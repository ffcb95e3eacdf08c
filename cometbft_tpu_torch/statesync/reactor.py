"""Twin of `cometbft_tpu/statesync/reactor.py`. State-sync p2p reactor: snapshot advertisement + chunk serving.

Behavior parity: reference internal/statesync/reactor.go — two channels
(Snapshot 0x60 for metadata, Chunk 0x61 for contents); on AddPeer we
request their snapshots; inbound SnapshotsRequest answers from the local
app's ListSnapshots (capped at 10 like recentSnapshots), ChunkRequest
serves LoadSnapshotChunk; responses feed the syncer's pool and an
in-flight chunk future that the Syncer's fetch_chunk blocks on.
"""

from __future__ import annotations

import threading

from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Reactor
from .messages import (
    CHUNK_CHANNEL,
    LIGHT_BLOCK_CHANNEL,
    SNAPSHOT_CHANNEL,
    ChunkRequest,
    ChunkResponse,
    LightBlockRequest,
    LightBlockResponse,
    SnapshotsRequest,
    SnapshotsResponse,
    decode_message,
)
from .snapshots import Snapshot

RECENT_SNAPSHOTS = 10


class StateSyncReactor(Reactor):
    def __init__(self, snapshot_conn, pool=None, block_store=None,
                 state_store=None):
        self.conn = snapshot_conn  # ABCI snapshot connection (serving side)
        self.pool = pool  # SnapshotPool (syncing side; None on servers)
        # stores for serving light blocks to syncing peers (reference
        # internal/statesync/reactor.go handleLightBlockMessage)
        self.block_store = block_store
        self.state_store = state_store
        self._peers: dict[str, object] = {}
        self._lock = threading.Lock()
        # (height, format, index) -> [event, chunk-or-None]
        self._pending: dict[tuple[int, int, int], list] = {}
        # height -> [event, LightBlock-or-None]
        self._pending_lb: dict[int, list] = {}

    # -- Reactor interface -------------------------------------------------
    def channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(id=SNAPSHOT_CHANNEL, priority=5),
            ChannelDescriptor(id=CHUNK_CHANNEL, priority=3),
            ChannelDescriptor(id=LIGHT_BLOCK_CHANNEL, priority=2),
        ]

    def add_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
        if self.pool is not None:
            peer.send(SNAPSHOT_CHANNEL, SnapshotsRequest().encode())

    def remove_peer(self, peer, reason) -> None:
        with self._lock:
            self._peers.pop(peer.id, None)
        if self.pool is not None:
            self.pool.remove_peer(peer.id)

    def receive(self, chan_id: int, peer, raw: bytes) -> None:
        msg = decode_message(raw)
        if isinstance(msg, SnapshotsRequest):
            for snap in (self.conn.list_snapshots() or [])[:RECENT_SNAPSHOTS]:
                peer.send(
                    SNAPSHOT_CHANNEL,
                    SnapshotsResponse(
                        height=snap.height,
                        format=snap.format,
                        chunks=snap.chunks,
                        hash=snap.hash,
                        metadata=snap.metadata,
                    ).encode(),
                )
        elif isinstance(msg, SnapshotsResponse):
            if self.pool is not None:
                self.pool.add(
                    Snapshot(
                        height=msg.height,
                        format=msg.format,
                        chunks=msg.chunks,
                        hash=msg.hash,
                        metadata=msg.metadata,
                    ),
                    peer.id,
                )
        elif isinstance(msg, ChunkRequest):
            chunk = self.conn.load_snapshot_chunk(
                msg.height, msg.format, msg.index
            )
            peer.send(
                CHUNK_CHANNEL,
                ChunkResponse(
                    height=msg.height,
                    format=msg.format,
                    index=msg.index,
                    chunk=chunk or b"",
                    missing=not chunk,
                ).encode(),
            )
        elif isinstance(msg, ChunkResponse):
            key = (msg.height, msg.format, msg.index)
            with self._lock:
                slot = self._pending.get(key)
            if slot is not None:
                slot[1] = None if msg.missing else msg.chunk
                slot[0].set()
        elif isinstance(msg, LightBlockRequest):
            peer.send(LIGHT_BLOCK_CHANNEL, self._serve_light_block(msg.height))
        elif isinstance(msg, LightBlockResponse):
            with self._lock:
                slot = self._pending_lb.get(msg.height)
            if slot is not None:
                slot[1] = self._decode_light_block(msg)
                slot[0].set()

    # -- light-block serving ----------------------------------------------
    def _serve_light_block(self, height: int) -> bytes:
        from ..light.client import StoreProvider

        lb = None
        if self.block_store is not None and self.state_store is not None:
            lb = StoreProvider("", self.block_store, self.state_store
                               ).light_block(height)
        if lb is None:
            return LightBlockResponse(height=height).encode()
        from ..state.types import encode_validator_set

        return LightBlockResponse(
            height=height,
            signed_header=lb.signed_header.encode(),
            validator_set=encode_validator_set(lb.validators),
        ).encode()

    @staticmethod
    def _decode_light_block(msg: LightBlockResponse):
        if not msg.signed_header:
            return None
        from ..light.types import LightBlock, SignedHeader
        from ..state.types import decode_validator_set

        try:
            return LightBlock(
                SignedHeader.decode(msg.signed_header),
                decode_validator_set(msg.validator_set),
            )
        except Exception:  # noqa: BLE001 — malformed response: treat missing
            return None

    # -- Syncer seam -------------------------------------------------------
    def fetch_chunk(self, snapshot, index: int, timeout: float = 10.0):
        """Request a chunk from a peer advertising this snapshot; blocks
        for the response (the Syncer runs several of these concurrently)."""
        peers = []
        if self.pool is not None:
            advertisers = set(self.pool.peers(snapshot))
            with self._lock:
                peers = [p for pid, p in self._peers.items() if pid in advertisers]
        if not peers:
            with self._lock:
                peers = list(self._peers.values())
        if not peers:
            return None
        peer = peers[index % len(peers)]
        key = (snapshot.height, snapshot.format, index)
        slot = [threading.Event(), None]
        with self._lock:
            self._pending[key] = slot
        try:
            peer.send(
                CHUNK_CHANNEL,
                ChunkRequest(
                    height=snapshot.height,
                    format=snapshot.format,
                    index=index,
                ).encode(),
            )
            if not slot[0].wait(timeout):
                return None
            return slot[1]
        finally:
            with self._lock:
                self._pending.pop(key, None)

    def fetch_light_block(self, height: int, timeout: float = 10.0):
        """Request a light block from peers (round-robin until one answers
        or all are tried); blocks for the response."""
        with self._lock:
            peers = list(self._peers.values())
        for peer in peers:
            slot = [threading.Event(), None]
            with self._lock:
                self._pending_lb[height] = slot
            try:
                peer.send(
                    LIGHT_BLOCK_CHANNEL, LightBlockRequest(height=height).encode()
                )
                if slot[0].wait(timeout) and slot[1] is not None:
                    return slot[1]
            finally:
                with self._lock:
                    self._pending_lb.pop(height, None)
        return None


class P2PLightProvider:
    """light.client.Provider over the state-sync light-block channel —
    the trust-anchor chain comes from the same peers serving snapshots
    (reference internal/statesync/stateprovider.go p2p provider)."""

    def __init__(self, reactor: StateSyncReactor, chain_id: str):
        self._reactor = reactor
        self._chain_id = chain_id

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int):
        return self._reactor.fetch_light_block(height)
