"""Peer switch: lifecycle + reactor registry + broadcast.

Twin of `cometbft_tpu/p2p/switch.py`. Behavior parity: reference p2p/switch.go — reactors claim channels
(:71 AddReactor), accept loop adds inbound peers (:631), DialPeer adds
outbound ones (:396), Broadcast fans a message to every peer's channel
(:272), errors evict the peer (StopPeerForError :333).
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from collections import deque

from ..utils import trace as _trace
from ..utils.log import logger
from ..utils.metrics import p2p_metrics
from .conn import ChannelDescriptor, MConnection
from .transport import NodeInfo, Transport

_log = logger("p2p")


class Reactor(ABC):
    """reference p2p/base_reactor.go Reactor. `switch` is the Switch that
    registered it (set by add_reactor, as CometBFT's SetSwitch), through
    which a reactor stops a misbehaving peer."""

    switch = None

    @abstractmethod
    def channels(self) -> list[ChannelDescriptor]: ...

    @abstractmethod
    def receive(self, chan_id: int, peer: "Peer", msg: bytes) -> None: ...

    def add_peer(self, peer: "Peer") -> None: ...

    def remove_peer(self, peer: "Peer", reason) -> None: ...


class Peer:
    def __init__(self, node_info: NodeInfo, mconn: MConnection, outbound: bool,
                 tracer=None):
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        # flight-recorder hook: tracer("send"/"recv", peer_id, chan_id,
        # raw) classifies consensus wire messages into trace records
        # (installed by Switch.set_msg_tracer; the trace.enabled guard
        # keeps the disabled cost at one global load)
        self.tracer = tracer

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def send(self, chan_id: int, msg: bytes) -> bool:
        if _trace.enabled and self.tracer is not None:
            self.tracer("send", self.id, chan_id, msg)
        return self.mconn.send(chan_id, msg)

    def stop(self) -> None:
        self.mconn.stop()


class DuplicatePeerError(ValueError):
    """A connection to an already-connected (or self) peer id. Carries
    the id so the persistent-peer redial loop can adopt an INBOUND
    connection instead of re-dialing a connected peer forever."""

    def __init__(self, peer_id: str):
        super().__init__(f"duplicate or self peer {peer_id}")
        self.peer_id = peer_id


class Switch:
    def __init__(self, transport: Transport, send_rate: int | None = None,
                 recv_rate: int | None = None,
                 max_packet_payload_size: int | None = None):
        from .conn import (DEFAULT_RECV_RATE, DEFAULT_SEND_RATE,
                           MAX_PACKET_PAYLOAD)

        self.transport = transport
        self.send_rate = DEFAULT_SEND_RATE if send_rate is None else send_rate
        self.recv_rate = DEFAULT_RECV_RATE if recv_rate is None else recv_rate
        self.max_packet_payload_size = (
            MAX_PACKET_PAYLOAD if max_packet_payload_size is None
            else max_packet_payload_size)
        self._reactors: list[Reactor] = []
        self._chan_owner: dict[int, Reactor] = {}
        self._descs: list[ChannelDescriptor] = []
        self._peers: dict[str, Peer] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._upgrade_slots = threading.Semaphore(self.MAX_PENDING_UPGRADES)
        # persistent peers: redialed with per-address exponential backoff
        # for as long as they are disconnected (reference p2p/switch.go
        # reconnectToPeer; a single swallowed dial failure at startup
        # must not strand the node)
        self._persistent: list[dict] = []
        self._redial_thread: threading.Thread | None = None
        # transport-level partition: peer ids in this set are dropped and
        # refused (the e2e runner's network-partition perturbation — the
        # reference uses docker disconnect, this needs no namespaces).
        # Controlled directly (set_partition) or via a watched JSON file.
        self._blocked: set[str] = set()
        self.partition_file: str | None = None
        self._partition_mtime: float = -1.0
        # wire-message trace classifier (flight recorder); see
        # set_msg_tracer
        self.msg_tracer = None
        # async broadcast queue (tx gossip): bounded, drop-oldest under
        # saturation, drained by a worker thread so producers (the
        # mempool notifier / admission drainer) never run peer I/O
        self.broadcast_queue_limit = 4096
        self._bcast_q: "deque[tuple[int, bytes]]" = deque()
        self._bcast_cv = threading.Condition()
        self._bcast_thread: threading.Thread | None = None

    def set_msg_tracer(self, fn) -> None:
        """Install a wire-message trace hook, called as
        fn(direction, peer_id, chan_id, raw_msg) on every message sent
        to or received from any peer while tracing is enabled. The
        consensus reactor installs its channel classifier here so
        cross-node traces get send→recv edges without the p2p layer
        knowing the consensus wire format."""
        self.msg_tracer = fn
        for peer in self.peers():
            peer.tracer = fn

    # ------------------------------------------------------------------
    def add_reactor(self, reactor: Reactor) -> None:
        for desc in reactor.channels():
            if desc.id in self._chan_owner:
                raise ValueError(f"channel {desc.id} already claimed")
            self._chan_owner[desc.id] = reactor
            self._descs.append(desc)
        self._reactors.append(reactor)
        reactor.switch = self
        # advertise channels in the node info
        self.transport.node_info.channels = bytes(
            sorted(self._chan_owner.keys())
        )

    def start(self) -> None:
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def add_persistent_peer(self, host: str, port: int) -> None:
        """Register an address the switch keeps connected: dialed now and
        redialed (0.5s tick, exponential backoff to 10s) whenever the
        connection is absent."""
        with self._lock:
            self._persistent.append(
                {"addr": (host, port), "peer_id": None,
                 "backoff": 0.5, "next_try": 0.0}
            )
            if self._redial_thread is None:
                self._redial_thread = threading.Thread(
                    target=self._redial_loop, daemon=True,
                    name="p2p-redial",
                )
                self._redial_thread.start()

    def _redial_loop(self) -> None:
        import time as _time

        while not self._stopped.is_set():
            self._poll_partition_file()
            # partition enforcement sweep: catches peers whose handshake
            # raced a set_partition call (admitted between the blocked
            # check and registration)
            if self._blocked:
                for peer in self.peers():
                    if peer.id in self._blocked:
                        self.stop_peer_for_error(peer, "partitioned")
            with self._lock:
                entries = list(self._persistent)
                connected = set(self._peers)
            now = _time.monotonic()
            for e in entries:
                if e["peer_id"] is not None and e["peer_id"] in connected:
                    e["backoff"] = 0.5
                    continue
                if now < e["next_try"]:
                    continue
                host, port = e["addr"]
                try:
                    peer = self.dial_peer(host, port)
                    e["peer_id"] = peer.id
                    e["backoff"] = 0.5
                except DuplicatePeerError as dup:
                    # the peer connected INBOUND: adopt its id so we
                    # stop re-dialing a live connection
                    e["peer_id"] = dup.peer_id
                    e["backoff"] = 0.5
                except Exception:  # noqa: BLE001 — retried with backoff
                    e["peer_id"] = None
                    e["next_try"] = now + e["backoff"]
                    e["backoff"] = min(e["backoff"] * 2, 10.0)
            self._stopped.wait(0.5)

    # ---------------------------------------------- partition injection
    def set_partition(self, blocked_ids) -> None:
        """Drop and refuse the given peer ids until cleared (pass an
        empty set to heal). Connected blocked peers are disconnected
        immediately; the persistent-peer loop redials after healing."""
        self._blocked = {str(b) for b in blocked_ids}
        for peer in self.peers():
            if peer.id in self._blocked:
                self.stop_peer_for_error(peer, "partitioned")

    def watch_partition_file(self, path: str) -> None:
        """Poll `path` for a JSON list of blocked peer ids (runner ->
        subprocess control channel; polled by the redial loop). Missing
        file = no partition."""
        self.partition_file = path
        with self._lock:
            if self._redial_thread is None:
                self._redial_thread = threading.Thread(
                    target=self._redial_loop, daemon=True,
                    name="p2p-redial",
                )
                self._redial_thread.start()

    def _poll_partition_file(self) -> None:
        import json
        import os

        path = self.partition_file
        if path is None:
            return
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        if mtime == self._partition_mtime:
            return
        blocked: set[str] = set()
        if mtime:
            try:
                with open(path) as f:
                    blocked = set(json.load(f))
            except (OSError, ValueError):
                return  # partial write: mtime NOT recorded -> retried
        # record the mtime only after a successful read, so a transient
        # read failure doesn't permanently drop the update
        self._partition_mtime = mtime
        if blocked != self._blocked:
            _log.info("partition update", blocked=len(blocked))
            self.set_partition(blocked)

    MAX_PENDING_UPGRADES = 32  # reference p2p MaxIncomingConnections-style cap

    def _accept_loop(self) -> None:
        # The handshake runs on a per-connection thread: a dialer that
        # connects and goes silent burns its own 10s timeout, not the
        # accept loop's, so inbound admission never serializes. The
        # semaphore bounds concurrent in-flight upgrades so a connection
        # flood cannot exhaust threads/file descriptors.
        while not self._stopped.is_set():
            try:
                raw = self.transport.accept_raw()
            except Exception:  # noqa: BLE001 — listener hiccup: keep going
                continue
            if raw is None:
                return
            if not self._upgrade_slots.acquire(blocking=False):
                try:
                    raw.close()  # saturated: shed load
                except OSError:
                    pass
                continue
            threading.Thread(
                target=self._upgrade_and_add, args=(raw,), daemon=True
            ).start()

    def _upgrade_and_add(self, raw) -> None:
        try:
            sconn, info = self.transport.upgrade(raw)
            self._add_peer(sconn, info, outbound=False)
        except Exception:  # noqa: BLE001 — failed upgrade: drop the conn
            try:
                raw.close()
            except OSError:
                pass
        finally:
            self._upgrade_slots.release()

    def dial_peer(self, host: str, port: int) -> Peer:
        sc, info = self.transport.dial(host, port)
        return self._add_peer(sc, info, outbound=True)

    def _add_peer(self, sconn, info: NodeInfo, outbound: bool) -> Peer:
        holder: dict = {}

        def on_receive(chan_id: int, msg: bytes) -> None:
            if _trace.enabled and self.msg_tracer is not None:
                self.msg_tracer("recv", holder["peer"].id, chan_id, msg)
            reactor = self._chan_owner.get(chan_id)
            if reactor is not None:
                reactor.receive(chan_id, holder["peer"], msg)

        def on_error(exc) -> None:
            self.stop_peer_for_error(holder["peer"], exc)

        mconn = MConnection(
            sconn, self._descs, on_receive, on_error,
            send_rate=self.send_rate,
            recv_rate=self.recv_rate,
            max_packet_payload_size=self.max_packet_payload_size)
        peer = Peer(info, mconn, outbound, tracer=self.msg_tracer)
        holder["peer"] = peer
        if peer.id in self._blocked:
            sconn.close()
            raise ValueError(f"partitioned peer {peer.id}")
        with self._lock:
            if peer.id in self._peers or peer.id == self.transport.node_info.node_id:
                sconn.close()
                raise DuplicatePeerError(peer.id)
            self._peers[peer.id] = peer
        # register with the reactors BEFORE the connection starts
        # delivering: a message that arrives between mconn.start and a
        # reactor's add_peer would find no per-peer state and be dropped
        # — fatal for one-shot handshake messages like the consensus
        # NewRoundStep (sends made here queue in the mconn and flush on
        # start). On any failure, unwind fully: a half-registered peer
        # whose mconn never starts has no error path to clean it up and
        # would permanently block reconnects as a duplicate.
        added = []
        try:
            for r in self._reactors:
                r.add_peer(peer)
                added.append(r)
            mconn.start()
        except Exception:
            with self._lock:
                self._peers.pop(peer.id, None)
            for r in added:
                try:
                    r.remove_peer(peer, "registration failed")
                except Exception:  # noqa: BLE001 — best-effort unwind
                    pass
            try:
                sconn.close()
            except OSError:
                pass
            raise
        _log.info("peer connected", peer=peer.id[:12], outbound=outbound)
        p2p_metrics().peers.set(len(self._peers))
        return peer

    # ------------------------------------------------------------------
    def peers(self) -> list[Peer]:
        with self._lock:
            return list(self._peers.values())

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        for peer in self.peers():
            peer.send(chan_id, msg)

    def queue_broadcast(self, chan_id: int, msg: bytes) -> None:
        """Enqueue a broadcast for the async worker. Bounded: when the
        queue is saturated (peers draining slower than frames arrive)
        the OLDEST frame is shed — for tx gossip, newer txs are worth
        more than stale ones, and the LRU cache re-delivers via other
        routes. Depth and drops are exported."""
        m = p2p_metrics()
        with self._bcast_cv:
            if self._stopped.is_set():
                return
            if self._bcast_thread is None:
                self._bcast_thread = threading.Thread(
                    target=self._broadcast_loop, daemon=True,
                    name="p2p-broadcast",
                )
                self._bcast_thread.start()
            if len(self._bcast_q) >= self.broadcast_queue_limit:
                self._bcast_q.popleft()
                m.broadcast_queue_dropped.inc()
            self._bcast_q.append((chan_id, msg, time.perf_counter()))
            m.broadcast_queue_depth.set(len(self._bcast_q))
            self._bcast_cv.notify()

    def _broadcast_loop(self) -> None:
        while True:
            with self._bcast_cv:
                while not self._bcast_q and not self._stopped.is_set():
                    self._bcast_cv.wait(timeout=0.5)
                if self._stopped.is_set():
                    return
                chan_id, msg, t_enq = self._bcast_q.popleft()
                m = p2p_metrics()
                m.broadcast_queue_depth.set(len(self._bcast_q))
                m.broadcast_queue_wait_seconds.observe(
                    time.perf_counter() - t_enq)
            for peer in self.peers():
                try:
                    peer.send(chan_id, msg)
                except Exception:  # noqa: BLE001 — dead peer: skip
                    continue

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        with self._lock:
            if self._peers.get(peer.id) is not peer:
                return
            del self._peers[peer.id]
        peer.stop()
        _log.info("peer stopped", peer=peer.id[:12], reason=str(reason)[:80])
        p2p_metrics().peers.set(len(self._peers))
        for r in self._reactors:
            r.remove_peer(peer, reason)

    def stop(self) -> None:
        self._stopped.set()
        with self._bcast_cv:
            self._bcast_cv.notify_all()
        self.transport.close()
        for peer in self.peers():
            peer.stop()
