"""Block pool: pipelined block fetching across peers.

Twin of `cometbft_tpu/blocksync/pool.py`. Behavior parity: reference internal/blocksync/pool.go — per-height
requesters fan out across reporting peers up to a request window;
arrived blocks queue for the apply loop, which always inspects TWO
consecutive blocks (PeekTwoBlocks :196) because block H is verified
with block H+1's LastCommit; PopRequest (:213) advances, RedoRequest
(:236) re-queues a height whose block failed verification and demotes
the sender. Peers report their (base, height) via status messages.

One difference from the reference (ROADMAP queue C): a redo drops both
blocks, H and H+1, and evicts nobody by itself; the reactor works out
which of the two senders served a provably invalid block and bans that
one (`ban`). The reference evicts H's sender whichever block was at
fault, and that peer's next status response re-admits it. A banned
peer's blocks are dropped and refetched, and its status responses are
ignored for as long as the ban set lives (the reactor keeps one across
its syncs).
"""

from __future__ import annotations

import threading
import time

from ..utils.metrics import blocksync_metrics

REQUEST_WINDOW = 64       # in-flight heights (reference maxPendingRequests)
RETRY_SECONDS = 5.0       # per-height fetch timeout before trying a new peer


class _Requester:
    __slots__ = ("height", "peer_id", "block", "sent_at")

    def __init__(self, height: int):
        self.height = height
        self.peer_id: str | None = None
        self.block = None
        self.sent_at = 0.0


class BlockPool:
    def __init__(self, start_height: int, send_request, banned: set | None = None):
        """send_request(peer_id, height) dispatches a BlockRequest (the
        reactor provides it); start_height is the first height wanted;
        `banned` (shared with the caller) holds the peers whose blocks
        failed verification."""
        self._lock = threading.Condition()
        self._send = send_request
        self.height = start_height          # next height the applier needs
        self._requesters: dict[int, _Requester] = {}
        self._peers: dict[str, tuple[int, int]] = {}  # id -> (base, height)
        self.banned = set() if banned is None else banned

    # -- peer management --------------------------------------------------
    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        with self._lock:
            if peer_id in self.banned:
                return
            self._peers[peer_id] = (base, height)
            m = blocksync_metrics()
            m.peer_height.set(height, peer_id)
            m.num_peers.set(len(self._peers))
            self._lock.notify_all()

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            if self._peers.pop(peer_id, None) is not None:
                m = blocksync_metrics()
                m.peer_height.remove(peer_id)
                m.num_peers.set(len(self._peers))
            for r in self._requesters.values():
                if r.peer_id == peer_id and r.block is None:
                    r.peer_id = None  # refetch from someone else

    def max_peer_height(self) -> int:
        with self._lock:
            return max((h for _, h in self._peers.values()), default=0)

    def is_caught_up(self) -> bool:
        with self._lock:
            best = max((h for _, h in self._peers.values()), default=0)
            return bool(self._peers) and self.height >= best

    # -- fetch scheduling --------------------------------------------------
    def make_requests(self) -> None:
        """Ensure a requester exists (and is assigned) for every height in
        the window; reassign timed-out fetches (reference
        makeRequestersRoutine + requester retry loop)."""
        now = time.monotonic()
        with self._lock:
            best = max((h for _, h in self._peers.values()), default=0)
            top = min(self.height + REQUEST_WINDOW, best)
            for h in range(self.height, top + 1):
                if h not in self._requesters:
                    self._requesters[h] = _Requester(h)
            sends = []
            for r in self._requesters.values():
                if r.block is not None:
                    continue
                if r.peer_id is not None and now - r.sent_at < RETRY_SECONDS:
                    continue
                peer = self._pick_peer(r.height, exclude=r.peer_id)
                if peer is None:
                    continue
                r.peer_id = peer
                r.sent_at = now
                sends.append((peer, r.height))
            blocksync_metrics().pending_requests.set(
                sum(1 for r in self._requesters.values() if r.block is None)
            )
        for peer, h in sends:
            self._send(peer, h)

    def _pick_peer(self, height: int, exclude: str | None) -> str | None:
        candidates = [
            pid for pid, (base, top) in self._peers.items()
            if base <= height <= top and pid != exclude
        ]
        if not candidates:
            # only the excluded peer has it: allow retrying it
            candidates = [
                pid for pid, (base, top) in self._peers.items()
                if base <= height <= top
            ]
        if not candidates:
            return None
        return candidates[height % len(candidates)]

    # -- block arrival / consumption ---------------------------------------
    def add_block(self, peer_id: str, block) -> bool:
        with self._lock:
            r = self._requesters.get(block.header.height)
            if r is None or r.block is not None:
                return False
            if r.peer_id != peer_id:
                return False  # unsolicited (reference drops + punishes)
            r.block = block
            self._lock.notify_all()
            return True

    def peek_two_blocks(self):
        """(block[height], block[height+1]) or (None, None-ish) if not
        both present yet."""
        with self._lock:
            first = self._requesters.get(self.height)
            second = self._requesters.get(self.height + 1)
            return (
                first.block if first else None,
                second.block if second else None,
            )

    def pop_request(self) -> None:
        """Height verified + applied: advance."""
        with self._lock:
            self._requesters.pop(self.height, None)
            self.height += 1

    def senders(self, height: int) -> tuple[str | None, str | None]:
        """The peers that served blocks `height` and `height`+1 (None where
        none has arrived)."""
        with self._lock:
            out = []
            for h in (height, height + 1):
                r = self._requesters.get(h)
                out.append(r.peer_id if r is not None and r.block is not None else None)
            return out[0], out[1]

    def redo_request(self, height: int) -> str | None:
        """Block at `height` failed verification against block height+1's
        LastCommit: drop both and refetch them. Returns the peer that
        served block `height`."""
        with self._lock:
            bad_peer = None
            for h in (height, height + 1):
                r = self._requesters.get(h)
                if r is None:
                    continue
                if h == height:
                    bad_peer = r.peer_id
                r.block = None
                r.peer_id = None
            return bad_peer

    def ban(self, peer_id: str) -> None:
        """A peer that served a provably invalid block: out of the pool for
        good, every block it served dropped and refetched."""
        with self._lock:
            self.banned.add(peer_id)
            m = blocksync_metrics()
            if self._peers.pop(peer_id, None) is not None:
                m.peer_height.remove(peer_id)
            m.num_peers.set(len(self._peers))
            for r in self._requesters.values():
                if r.peer_id == peer_id:
                    r.block = None
                    r.peer_id = None

    def wait_for_blocks(self, timeout: float) -> None:
        with self._lock:
            first = self._requesters.get(self.height)
            second = self._requesters.get(self.height + 1)
            if first and first.block and second and second.block:
                return
            self._lock.wait(timeout)
