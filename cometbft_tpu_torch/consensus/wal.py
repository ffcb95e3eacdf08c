"""Write-ahead log for the consensus state machine.

Behavior parity: reference internal/consensus/wal.go (BaseWAL :57-68) +
internal/autofile/group.go —
- every record is CRC32-framed: crc(4, big) | length(4, big) | payload
  (reference internal/consensus/wal.go WALEncoder).
- records are TimedWALMessage{time, msg}; the msg union covers EndHeight
  markers, received consensus messages, and timeout firings — everything
  the receive loop processes, written BEFORE processing.
- `write_sync` fsyncs (own messages must hit disk before they hit the
  wire, reference state.go:830); `write` is buffered.
- log files rotate at max_file_bytes (autofile.Group's size rotation);
  `search_for_end_height` scans newest-to-oldest like the reference.

Encodings use the project's proto helpers; payloads embed the existing
wire encodings of Vote/Proposal, so a WAL survives process restarts and
code reloads (no pickling).

Twin of `cometbft_tpu/consensus/wal.py`: the same framing, CRC, rotation
and fsyncs, so a WAL written by either package reads in the other. An
aggregate-precommit certificate (BLS) is refused by name, written or read
(UnsupportedCommitFormat): the port has none.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass

from ..encoding import proto as pb
from ..types import Proposal, Vote
from ..types.block import UnsupportedCommitFormat

MAX_MSG_BYTES = 2 * 1024 * 1024


@dataclass
class EndHeightMessage:
    """#ENDHEIGHT marker: height H fully committed (reference wal.go:38)."""

    height: int


@dataclass
class MsgInfo:
    """A consensus message from a peer ("" = self) entering the loop."""

    msg: object  # Vote | Proposal | full-block bytes wrapper
    peer_id: str = ""


@dataclass
class BlockBytesMessage:
    """Proposal block payload (full-block gossip seam; parts later)."""

    height: int
    round: int
    block_bytes: bytes


@dataclass
class AggregateCommitMessage:
    """The reference's certificate-native catchup gossip: one +2/3
    aggregate-precommit certificate (BLS). The port refuses it by name
    (`refuse_certificate`) in the WAL and in the state machine."""

    cert: object


def refuse_certificate() -> UnsupportedCommitFormat:
    return UnsupportedCommitFormat(
        "AggregateCommitMessage: aggregate-precommit certificates (BLS) are not "
        "supported by the port")


@dataclass
class TimeoutMessage:
    height: int
    round: int
    step: int
    duration_ms: int = 0


@dataclass
class TimedWALMessage:
    time_ns: int
    msg: object


def _encode_msg(m) -> bytes:
    if isinstance(m, EndHeightMessage):
        return pb.f_embedded(2, pb.f_varint(1, m.height, emit_zero=True))
    if isinstance(m, MsgInfo):
        inner = m.msg
        if isinstance(inner, Vote):
            body = pb.f_embedded(1, inner.encode())
        elif isinstance(inner, Proposal):
            body = pb.f_embedded(2, inner.encode())
        elif isinstance(inner, BlockBytesMessage):
            body = pb.f_embedded(
                3,
                pb.f_varint(1, inner.height)
                + pb.f_varint(2, inner.round)
                + pb.f_bytes(3, inner.block_bytes),
            )
        elif isinstance(inner, AggregateCommitMessage):
            raise refuse_certificate()
        else:
            raise TypeError(f"unsupported WAL MsgInfo payload {type(inner)}")
        return pb.f_embedded(3, body + pb.f_string(15, m.peer_id))
    if isinstance(m, TimeoutMessage):
        return pb.f_embedded(
            4,
            pb.f_varint(1, m.height)
            + pb.f_varint(2, m.round)
            + pb.f_varint(3, m.step)
            + pb.f_varint(4, m.duration_ms),
        )
    raise TypeError(f"unsupported WAL message {type(m)}")


def _decode_timed(payload: bytes) -> TimedWALMessage:
    t, msg = 0, None
    for fnum, _, v in pb.parse_fields(payload):
        if fnum == 1:
            t = pb.to_i64(v)
        else:
            msg = _decode_msg_field(fnum, pb.as_bytes(v))
    if msg is None:
        raise ValueError("WAL record without message")
    return TimedWALMessage(t, msg)


def _decode_msg_field(fnum: int, v: bytes):
    if fnum == 2:
        return EndHeightMessage(pb.to_i64(pb.fields_to_dict(v).get(1, 0)))
    if fnum == 3:
        d = pb.fields_to_dict(v)
        peer = pb.as_bytes(d.get(15, b"")).decode()
        if 1 in d:
            return MsgInfo(Vote.decode(pb.as_bytes(d[1])), peer)
        if 2 in d:
            return MsgInfo(Proposal.decode(pb.as_bytes(d[2])), peer)
        if 3 in d:
            bd = pb.fields_to_dict(pb.as_bytes(d[3]))
            return MsgInfo(
                BlockBytesMessage(
                    pb.to_i64(bd.get(1, 0)),
                    pb.to_i64(bd.get(2, 0)),
                    pb.as_bytes(bd.get(3, b"")),
                ),
                peer,
            )
        if 4 in d:
            raise refuse_certificate()
        raise ValueError("unknown MsgInfo payload")
    if fnum == 4:
        d = pb.fields_to_dict(v)
        return TimeoutMessage(
            pb.to_i64(d.get(1, 0)), pb.to_i64(d.get(2, 0)),
            pb.to_i64(d.get(3, 0)), pb.to_i64(d.get(4, 0)),
        )
    raise ValueError(f"unknown WAL message tag {fnum}")


def _encode_timed(tm: TimedWALMessage) -> bytes:
    payload = pb.f_varint(1, tm.time_ns) + _encode_msg(tm.msg)
    crc = zlib.crc32(payload)
    return struct.pack(">II", crc, len(payload)) + payload


class WALCorruptionError(Exception):
    pass


class WAL:
    """Rolling-file CRC-framed WAL."""

    def __init__(self, path: str, max_file_bytes: int = 16 * 1024 * 1024):
        self.path = path
        self.max_file_bytes = max_file_bytes
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self._head_path(), "ab")

    # -- file layout: path.000, path.001, ... plus head at `path` ---------
    def _head_path(self) -> str:
        return self.path

    def _rolled_paths(self) -> list[str]:
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path)
        out = []
        for name in os.listdir(d):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    out.append(os.path.join(d, name))
        return sorted(out)

    def _maybe_rotate_locked(self):
        if self._f.tell() < self.max_file_bytes:
            return
        self._f.close()
        rolled = self._rolled_paths()
        nxt = (
            int(os.path.basename(rolled[-1]).rsplit(".", 1)[1]) + 1 if rolled else 0
        )
        os.replace(self._head_path(), f"{self.path}.{nxt:03d}")
        self._f = open(self._head_path(), "ab")

    # ------------------------------------------------------------------
    def write(self, msg) -> None:
        tm = TimedWALMessage(time.time_ns(), msg)
        with self._lock:
            self._f.write(_encode_timed(tm))

    def write_sync(self, msg) -> None:
        tm = TimedWALMessage(time.time_ns(), msg)
        with self._lock:
            self._f.write(_encode_timed(tm))
            self._f.flush()
            os.fsync(self._f.fileno())
            self._maybe_rotate_locked()

    def flush(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            self._f.close()

    def write_end_height(self, height: int) -> None:
        self.write_sync(EndHeightMessage(height))

    # ------------------------------------------------------------------
    @staticmethod
    def _read_file(path: str, strict: bool = True):
        out = []
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            if pos + 8 > len(data):
                break  # torn tail write: tolerated (crash mid-write)
            crc, ln = struct.unpack_from(">II", data, pos)
            if ln > MAX_MSG_BYTES:
                raise WALCorruptionError(f"record length {ln} too large")
            payload = data[pos + 8: pos + 8 + ln]
            if len(payload) < ln:
                break  # torn tail
            if zlib.crc32(payload) != crc:
                if strict:
                    raise WALCorruptionError(f"crc mismatch at offset {pos}")
                break
            out.append(_decode_timed(payload))
            pos += 8 + ln
        return out

    def read_all(self):
        self.flush()
        msgs = []
        for p in self._rolled_paths() + [self._head_path()]:
            if os.path.exists(p):
                msgs.extend(self._read_file(p))
        return msgs

    def search_for_end_height(self, height: int):
        """Messages logged AFTER EndHeight(height); None if marker absent
        (reference wal.go SearchForEndHeight)."""
        msgs = self.read_all()
        for i in range(len(msgs) - 1, -1, -1):
            m = msgs[i].msg
            if isinstance(m, EndHeightMessage) and m.height == height:
                return msgs[i + 1:]
        return None
