"""Twin of `cometbft_tpu/statesync/snapshots.py`. Snapshot pool: peer-advertised snapshots ranked for restoration.

Behavior parity: reference internal/statesync/snapshots.go:255 — dedups
by (height, format, chunks, hash), tracks which peers can serve each
snapshot, Best() prefers the highest height then newest format, and
rejection is remembered per snapshot / per format / per peer.

The replication feed's blob helpers (`blob_hash`, `chunk_blob`,
`FORMAT_REPLICATION_V1`) come with `replication/`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SnapshotKey:
    height: int
    format: int
    chunks: int
    hash: bytes


@dataclass
class Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""
    trusted_app_hash: bytes = b""

    def key(self) -> SnapshotKey:
        return SnapshotKey(self.height, self.format, self.chunks, self.hash)


@dataclass
class _Entry:
    snapshot: Snapshot
    peers: set[str] = field(default_factory=set)


class SnapshotPool:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[SnapshotKey, _Entry] = {}
        self._rejected_keys: set[SnapshotKey] = set()
        self._rejected_formats: set[int] = set()
        self._rejected_peers: set[str] = set()

    def add(self, snapshot: Snapshot, peer: str = "") -> bool:
        """True if this (snapshot, peer) pair is new and acceptable."""
        key = snapshot.key()
        with self._lock:
            if (
                key in self._rejected_keys
                or snapshot.format in self._rejected_formats
                or (peer and peer in self._rejected_peers)
            ):
                return False
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _Entry(snapshot)
                new = True
            else:
                new = False
            if peer:
                entry.peers.add(peer)
            return new

    def best(self) -> Snapshot | None:
        """Highest height, then newest format (reference Best())."""
        with self._lock:
            if not self._entries:
                return None
            key = max(
                self._entries, key=lambda k: (k.height, k.format)
            )
            return self._entries[key].snapshot

    def peers(self, snapshot: Snapshot) -> list[str]:
        with self._lock:
            e = self._entries.get(snapshot.key())
            return sorted(e.peers) if e else []

    def reject(self, snapshot: Snapshot) -> None:
        with self._lock:
            key = snapshot.key()
            self._rejected_keys.add(key)
            self._entries.pop(key, None)

    def reject_format(self, format_: int) -> None:
        with self._lock:
            self._rejected_formats.add(format_)
            for key in [k for k in self._entries if k.format == format_]:
                self._entries.pop(key)

    def reject_peer(self, peer: str) -> None:
        with self._lock:
            self._rejected_peers.add(peer)
            for key, e in list(self._entries.items()):
                e.peers.discard(peer)
                if not e.peers:
                    self._entries.pop(key)

    def remove_peer(self, peer: str) -> None:
        with self._lock:
            for key, e in list(self._entries.items()):
                e.peers.discard(peer)
