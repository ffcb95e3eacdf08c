"""Multiplexed channels over one authenticated connection.

Twin of `cometbft_tpu/p2p/conn.py`. Behavior parity: reference p2p/conn/connection.go —
- channels with ids + priorities (:80,124 ChannelDescriptor);
- messages are packetized (channel id, eof flag, <=max_packet_payload
  chunks, reference msgPacket) and interleaved: the send loop picks the
  channel with the least recently-sent-bytes/priority ratio
  (sendSomePacketMsgs);
- ping/pong keepalive with a disconnect deadline (:~510);
- an onReceive callback delivers whole reassembled messages per channel.

Zero-copy hot path: the send loop never materializes a frame
per packet. A queued message is wrapped in ONE memoryview; each packet
is a slice of it, the 4-byte packet header lives in a per-connection
scratch, and both are handed to SecretConnection.write_views, which
seals them straight out of the original buffer. Receives reassemble
into a persistent per-channel bytearray (grown geometrically, reused
across messages) instead of a list + b"".join per message. The packet
payload size is configurable per connection ([p2p]
max_packet_payload_size, default 1024 for wire back-compat) and per
channel (ChannelDescriptor.packet_payload_size) — the receive path is
frame-size-agnostic (one read_msg = one whole packet), so peers
operating at different sizes interoperate.

Flow-rate limiting is ENFORCED on both directions (reference
connection.go:43-44 defaultSendRate/defaultRecvRate = 512000): the send
loop stops draining channels and the recv loop stops reading frames
once the 100 ms window budget is spent, applying backpressure through
TCP. Pass send_rate/recv_rate=0 to disable (in-process loopback nets).
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass

from ..utils.metrics import p2p_metrics
from ..utils import trace

PACKET_DATA = 1
PACKET_PING = 2
PACKET_PONG = 3

PACKET_HEADER_SIZE = 4  # <BHB: kind, channel id, eof flag
MAX_PACKET_PAYLOAD = 1024
PING_INTERVAL_S = 10.0
PONG_TIMEOUT_S = 45.0
DEFAULT_SEND_RATE = 512_000  # bytes/s (reference connection.go:43)
DEFAULT_RECV_RATE = 512_000  # bytes/s (reference connection.go:44)


class _RateLimiter:
    """Windowed byte budget: spend() blocks (or reports a wait) once the
    current 100 ms window's share of rate bytes/s is used up — the
    flowrate.Monitor.Limit() semantics the reference applies per
    direction."""

    WINDOW_S = 0.1

    def __init__(self, rate: int):
        self.rate = rate
        self._window_start = time.monotonic()
        self._spent = 0

    def spend(self, nbytes: int, stop_event) -> None:
        if self.rate <= 0:
            return
        now = time.monotonic()
        if now - self._window_start >= self.WINDOW_S:
            self._window_start = now
            self._spent = 0
        self._spent += nbytes
        budget = self.rate * self.WINDOW_S
        if self._spent > budget:
            wait = self._window_start + self.WINDOW_S - now
            if wait > 0:
                stop_event.wait(wait)
            self._window_start = time.monotonic()
            self._spent = 0


@dataclass
class ChannelDescriptor:
    id: int
    priority: int = 1
    recv_message_capacity: int = 8 * 1024 * 1024
    # per-channel packet payload override; 0 = the connection's
    # max_packet_payload_size (e2e raises this on block-part channels)
    packet_payload_size: int = 0


class _Channel:
    def __init__(self, desc: ChannelDescriptor, payload_cap: int):
        self.desc = desc
        self.payload_cap = desc.packet_payload_size or payload_cap
        self.send_queue: list[bytes] = []
        self.sending: memoryview | None = None
        self.sending_len = 0
        self.sent_pos = 0
        self.send_npkts = 0
        self.send_t0 = 0.0
        self.recently_sent = 0.0
        # persistent reassembly buffer: grown geometrically, reused
        # across messages (replaces the per-message list + b"".join)
        self.recv_buf = bytearray()
        self.recv_size = 0
        self.lock = threading.Lock()

    def enqueue(self, msg: bytes) -> int:
        with self.lock:
            self.send_queue.append(msg)
            return len(self.send_queue) + (self.sending is not None)

    def has_data(self) -> bool:
        with self.lock:
            return self.sending is not None or bool(self.send_queue)

    def next_packet(self):
        """-> (payload memoryview, eof, done) or None. `done` is
        (msg_bytes, n_packets, t0, queue_depth) when this packet
        completes a message, else None. The payload is a slice over the
        original queued buffer — no copy; it stays valid after `sending`
        is dropped because the slice keeps the buffer alive."""
        with self.lock:
            if self.sending is None:
                if not self.send_queue:
                    return None
                msg = self.send_queue.pop(0)
                self.sending = memoryview(msg)
                self.sending_len = len(msg)
                self.sent_pos = 0
                self.send_npkts = 0
                self.send_t0 = time.perf_counter()
            chunk = self.sending[self.sent_pos:
                                 self.sent_pos + self.payload_cap]
            self.sent_pos += len(chunk)
            self.send_npkts += 1
            eof = self.sent_pos >= self.sending_len
            done = None
            if eof:
                self.sending = None
                done = (self.sending_len, self.send_npkts, self.send_t0,
                        len(self.send_queue))
            self.recently_sent += len(chunk)
            return chunk, eof, done


class MConnection:
    def __init__(self, sconn, channels: list[ChannelDescriptor], on_receive,
                 on_error=None, send_rate: int = DEFAULT_SEND_RATE,
                 recv_rate: int = DEFAULT_RECV_RATE,
                 max_packet_payload_size: int = MAX_PACKET_PAYLOAD):
        """sconn: SecretConnection (or anything with write_msg/read_msg);
        on_receive(chan_id, msg_bytes); on_error(exc); send_rate /
        recv_rate in bytes/s (0 disables that direction's limit);
        max_packet_payload_size: data bytes per packet (channels may
        override via their descriptor)."""
        if max_packet_payload_size <= 0:
            raise ValueError("max_packet_payload_size must be positive")
        self._conn = sconn
        self.max_packet_payload_size = max_packet_payload_size
        self._channels = {
            d.id: _Channel(d, max_packet_payload_size) for d in channels
        }
        self._on_receive = on_receive
        self._on_error = on_error or (lambda e: None)
        self._send_event = threading.Event()
        self._stopped = threading.Event()
        self._last_pong = time.monotonic()
        self._threads: list[threading.Thread] = []
        self._send_limit = _RateLimiter(send_rate)
        self._recv_limit = _RateLimiter(recv_rate)
        # single preallocated packet-header scratch: the send loop is
        # one thread, so one buffer per connection suffices
        self._hdr_scratch = bytearray(PACKET_HEADER_SIZE)
        # vectored sealing path when the transport supports it (the
        # SecretConnection); fakes with only write_msg still work
        self._write_views = getattr(sconn, "write_views", None)

    def start(self) -> None:
        for fn in (self._send_loop, self._recv_loop, self._ping_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        self._send_event.set()
        self._conn.close()

    # ------------------------------------------------------------------
    def send(self, chan_id: int, msg: bytes) -> bool:
        ch = self._channels.get(chan_id)
        if ch is None:
            return False
        depth = ch.enqueue(msg)
        p2p_metrics().send_queue_depth.set(depth, f"{chan_id:#04x}")
        self._send_event.set()
        return True

    def _pick_channel(self) -> _Channel | None:
        """Least recently-sent-bytes/priority (reference sendPacketMsg)."""
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.has_data():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_loop(self) -> None:
        hdr = self._hdr_scratch
        try:
            while not self._stopped.is_set():
                ch = self._pick_channel()
                if ch is None:
                    self._send_event.wait(0.05)
                    self._send_event.clear()
                    # decay recently_sent so idle channels recover priority
                    for c in self._channels.values():
                        c.recently_sent *= 0.8
                    continue
                pkt = ch.next_packet()
                if pkt is None:
                    continue
                chunk, eof, done = pkt
                struct.pack_into("<BHB", hdr, 0, PACKET_DATA, ch.desc.id,
                                 1 if eof else 0)
                if self._write_views is not None:
                    self._write_views(hdr, chunk)
                else:
                    self._conn.write_msg(bytes(hdr) + bytes(chunk))
                frame_len = PACKET_HEADER_SIZE + len(chunk)
                p2p_metrics().message_send_bytes_total.inc(
                    frame_len, f"{ch.desc.id:#04x}"
                )
                if done is not None:
                    msg_bytes, npkts, t0, depth = done
                    p2p_metrics().send_queue_depth.set(
                        depth, f"{ch.desc.id:#04x}")
                    if trace.enabled:
                        trace.emit(
                            "p2p.zero_copy_send", "span",
                            dur_ms=round(
                                (time.perf_counter() - t0) * 1e3, 3),
                            chan=ch.desc.id, bytes=msg_bytes,
                            packets=npkts,
                        )
                self._send_limit.spend(frame_len, self._stopped)
        except Exception as e:  # noqa: BLE001
            if not self._stopped.is_set():
                self._on_error(e)

    def _recv_loop(self) -> None:
        try:
            while not self._stopped.is_set():
                frame = self._conn.read_msg()
                if not frame:
                    continue
                self._recv_limit.spend(len(frame), self._stopped)
                kind = frame[0]
                if kind == PACKET_PING:
                    self._conn.write_msg(struct.pack("<BHB", PACKET_PONG, 0, 0))
                    continue
                if kind == PACKET_PONG:
                    self._last_pong = time.monotonic()
                    continue
                if kind != PACKET_DATA or len(frame) < PACKET_HEADER_SIZE:
                    raise ValueError("corrupt packet")
                _, chan_id, eof = struct.unpack_from("<BHB", frame)
                ch = self._channels.get(chan_id)
                if ch is None:
                    raise ValueError(f"unknown channel {chan_id}")
                payload = memoryview(frame)[PACKET_HEADER_SIZE:]
                if eof and ch.recv_size == 0:
                    # single-packet message (votes, steps — the common
                    # case): hand the payload straight through, never
                    # touching the reassembly buffer
                    if len(payload) > ch.desc.recv_message_capacity:
                        raise ValueError("message exceeds channel capacity")
                    msg = bytes(payload)
                else:
                    need = ch.recv_size + len(payload)
                    if need > ch.desc.recv_message_capacity:
                        raise ValueError("message exceeds channel capacity")
                    if len(ch.recv_buf) < need:
                        grow = max(need, 2 * len(ch.recv_buf), 16 * 1024)
                        ch.recv_buf.extend(
                            bytes(grow - len(ch.recv_buf)))
                    ch.recv_buf[ch.recv_size:need] = payload
                    ch.recv_size = need
                    if not eof:
                        continue
                    msg = bytes(memoryview(ch.recv_buf)[:ch.recv_size])
                    ch.recv_size = 0
                p2p_metrics().message_receive_bytes_total.inc(
                    len(msg), f"{chan_id:#04x}"
                )
                self._on_receive(chan_id, msg)
        except Exception as e:  # noqa: BLE001
            if not self._stopped.is_set():
                self._on_error(e)

    def _ping_loop(self) -> None:
        while not self._stopped.is_set():
            time.sleep(PING_INTERVAL_S)
            if self._stopped.is_set():
                return
            try:
                self._conn.write_msg(struct.pack("<BHB", PACKET_PING, 0, 0))
            except Exception:  # noqa: BLE001
                return
            if time.monotonic() - self._last_pong > PONG_TIMEOUT_S:
                self._on_error(TimeoutError("pong timeout"))
                return
