"""Block-sync reactor: serve blocks to lagging peers and catch up from
the network.

Twin of `cometbft_tpu/blocksync/reactor.py`. Behavior parity: reference internal/blocksync/reactor.go — channel 0x40
with BlockRequest(1)/NoBlockResponse(2)/BlockResponse(3)/
StatusRequest(4)/StatusResponse(5); the pool routine verifies block H
with block H+1's LastCommit via VerifyCommitLight (:462) — the TPU
batch path — then ApplyBlock (:511), and reports IsCaughtUp so the node
can switch to consensus (:400 SwitchToConsensus).

The syncing side takes `device=` ("cuda" by default, raising without a
GPU) where the reference takes `backend=`: each light check runs on that
device's dispatch (native under NATIVE_MAX signatures, else the card's
routes). A refused block's error is kept, with its height and the peer
at fault, in `refused`. The peer at fault is the one whose block is
provably invalid (`_at_fault`): H+1's sender, unless H+1's LastCommit is
a valid commit of another block at H, which proves H's sender wrong. It
stays out of the pool for the reactor's life (`banned`, see
`blocksync/pool.py`) and is disconnected through the switch, as
CometBFT's reactor stops the senders (reactor.go poolRoutine,
StopPeerForError); the other sender keeps its connection and serves the
refetch. The reference punishes H's sender whichever block was at fault
and keeps it connected.
"""

from __future__ import annotations

import threading

from ..crypto import ed25519
from ..encoding import proto as pb
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..types import Block
from ..types.block import block_id_for
from ..types.validation import CommitError, verify_commit_light
from ..utils import trace
from ..utils.log import logger
from ..utils.metrics import blocksync_metrics
from .pool import BlockPool

BLOCKSYNC_CHANNEL = 0x40
_log = logger("blocksync")


def _msg(field: int, body: bytes = b"") -> bytes:
    return pb.f_embedded(field, body)


def encode_block_request(height: int) -> bytes:
    return _msg(1, pb.f_varint(1, height))


def encode_no_block(height: int) -> bytes:
    return _msg(2, pb.f_varint(1, height))


def encode_block_response(block: Block) -> bytes:
    return _msg(3, pb.f_embedded(1, block.encode()))


def encode_status_request() -> bytes:
    return _msg(4)


def encode_status_response(height: int, base: int) -> bytes:
    return _msg(5, pb.f_varint(1, height) + pb.f_varint(2, base))


class BlockSyncReactor(Reactor):
    def __init__(self, block_store, executor=None, state=None, device="cuda"):
        """Serving side always works off block_store; the syncing side
        (pool routine) activates via sync() with an executor + state, and
        checks commits on `device`."""
        self.store = block_store
        self.executor = executor
        self.state = state
        self.device = ed25519._resolve_device(device) if executor is not None else None
        self.pool: BlockPool | None = None
        self._peers: dict[str, object] = {}
        self._ranges: dict[str, tuple[int, int]] = {}  # peer id -> (base, height) last reported
        self._lock = threading.Lock()
        self.banned: set[str] = set()  # peers that served a provably invalid block
        self.refused: list[tuple[int, str | None, Exception]] = []  # (height, peer, error)

    # -- Reactor interface -------------------------------------------------
    def channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=BLOCKSYNC_CHANNEL, priority=5)]

    def add_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
        peer.send(
            BLOCKSYNC_CHANNEL,
            encode_status_response(self.store.height(), self.store.base()),
        )
        peer.send(BLOCKSYNC_CHANNEL, encode_status_request())

    def remove_peer(self, peer, reason) -> None:
        with self._lock:
            self._peers.pop(peer.id, None)
            self._ranges.pop(peer.id, None)
        if self.pool is not None:
            self.pool.remove_peer(peer.id)

    def receive(self, chan_id: int, peer, raw: bytes) -> None:
        d = pb.fields_to_dict(raw)
        if 1 in d:  # BlockRequest
            h = pb.to_i64(pb.fields_to_dict(pb.as_bytes(d[1])).get(1, 0))
            blk = self.store.load_block(h)
            if blk is None:
                peer.send(BLOCKSYNC_CHANNEL, encode_no_block(h))
            else:
                peer.send(BLOCKSYNC_CHANNEL, encode_block_response(blk))
        elif 3 in d:  # BlockResponse
            if self.pool is not None:
                inner = pb.fields_to_dict(pb.as_bytes(d[3]))
                try:
                    blk = Block.decode(pb.as_bytes(inner.get(1, b"")))
                except Exception:  # noqa: BLE001 — malformed: drop
                    return
                self.pool.add_block(peer.id, blk)
        elif 4 in d:  # StatusRequest
            peer.send(
                BLOCKSYNC_CHANNEL,
                encode_status_response(self.store.height(), self.store.base()),
            )
        elif 5 in d:  # StatusResponse
            f = pb.fields_to_dict(pb.as_bytes(d[5]))
            base, height = pb.to_i64(f.get(2, 0)) or 1, pb.to_i64(f.get(1, 0))
            with self._lock:
                if peer.id in self._peers:
                    self._ranges[peer.id] = (base, height)
            if self.pool is not None:
                self.pool.set_peer_range(peer.id, base, height)

    def _ban(self, peer_id: str, reason) -> None:
        """Ban `peer_id` from the pool and disconnect it."""
        self.pool.ban(peer_id)
        with self._lock:
            peer = self._peers.get(peer_id)
        if peer is not None and self.switch is not None:
            self.switch.stop_peer_for_error(peer, reason)

    def _at_fault(self, state, bid, height: int, commit) -> int:
        """Which block of a refused pair is provably invalid: 1 (block H+1,
        whose LastCommit fails as a commit of block H), unless that commit
        names another block ID and is a valid commit of it at `height`;
        then 0 (block H is not the block the validators signed)."""
        if commit.block_id == bid:
            return 1
        try:
            verify_commit_light(state.chain_id, state.validators, commit.block_id, height,
                                commit, device=self.device)
        except CommitError:
            return 1
        return 0

    # -- syncing side ------------------------------------------------------
    def _send_request(self, peer_id: str, height: int) -> None:
        with self._lock:
            peer = self._peers.get(peer_id)
        if peer is not None:
            peer.send(BLOCKSYNC_CHANNEL, encode_block_request(height))

    def sync(self, timeout_s: float = 60.0, poll_s: float = 0.05):
        """Catch up from peers until caught up or timeout; returns the
        post-sync state (reference poolRoutine)."""
        import time as _time

        assert self.executor is not None and self.state is not None
        state = self.state
        self.pool = BlockPool(state.last_block_height + 1, self._send_request, self.banned)
        # the ranges peers reported before, then fresh ones (the reference's
        # pool lives as long as its reactor and takes every status)
        with self._lock:
            peers = list(self._peers.values())
            ranges = list(self._ranges.items())
        for pid, (base, height) in ranges:
            self.pool.set_peer_range(pid, base, height)
        _log.debug("block sync starting", from_height=state.last_block_height + 1,
                   peers=len(peers))
        for p in peers:
            p.send(BLOCKSYNC_CHANNEL, encode_status_request())
        start = _time.monotonic()
        deadline = start + timeout_s
        applied = 0
        m = blocksync_metrics()
        m.syncing.set(1)
        while _time.monotonic() < deadline:
            self.pool.make_requests()
            first, second = self.pool.peek_two_blocks()
            if first is None or second is None:
                if self.pool.is_caught_up():
                    break  # nothing (more) to fetch
                if (self.pool.max_peer_height() == 0
                        and _time.monotonic() - start > 3.0):
                    _log.debug("block sync: no peer reported a range")
                    break  # no peer ever reported a range
                self.pool.wait_for_blocks(poll_s)
                continue
            bid = block_id_for(first)
            t_fetch = _time.perf_counter()
            try:
                # block H is endorsed by H+1's LastCommit — the batch
                # verify hot path (reference reactor.go:462)
                verify_commit_light(
                    state.chain_id,
                    state.validators,
                    bid,
                    first.header.height,
                    second.last_commit,
                    device=self.device,
                )
            except CommitError as e:
                h = first.header.height
                served = self.pool.senders(h)
                self.pool.redo_request(h)
                bad = served[self._at_fault(state, bid, h, second.last_commit)]
                if bad is not None:
                    self._ban(bad, e)
                self.refused.append((h, bad, e))
                m.bad_blocks_total.inc()
                _log.warn("invalid block from peer", height=h,
                          peer=(bad or "?")[:12], err=str(e)[:80])
                continue
            t_verify = _time.perf_counter()
            state = self.executor.apply_block(state, bid, first)
            self.store.save_block(first, second.last_commit)
            self.pool.pop_request()
            applied += 1
            m.blocks_applied_total.inc()
            m.latest_block_height.set(first.header.height)
            if trace.enabled:
                t_apply = _time.perf_counter()
                trace.emit(
                    "blocksync.block", "span",
                    height=first.header.height,
                    dur_ms=round((t_apply - t_fetch) * 1e3, 3),
                    verify_ms=round((t_verify - t_fetch) * 1e3, 3),
                    apply_ms=round((t_apply - t_verify) * 1e3, 3),
                )
        m.syncing.set(0)
        self.state = state
        _log.debug("block sync done", applied=applied,
                   height=state.last_block_height)
        return state
