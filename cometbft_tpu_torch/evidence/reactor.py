"""Twin of `cometbft_tpu/evidence/reactor.py`. Evidence reactor: gossip pending evidence to peers.

Behavior parity: reference internal/evidence/reactor.go — one channel
(0x38), a per-peer broadcast routine that walks the pending list and
retries on an interval (the reference's clist blocking-iterate becomes
a poll loop over pending_evidence), and inbound evidence fed through
EvidencePool.add_evidence (verification included; invalid evidence is
dropped and logged, reference :120). A node that observes equivocation
can therefore inform the whole network, not just its own block
proposals.
"""

from __future__ import annotations

import threading
import time

from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..types.evidence import decode_evidence
from ..utils.log import logger

EVIDENCE_CHANNEL = 0x38
BROADCAST_INTERVAL_S = 0.1
_log = logger("evidence")


class EvidenceReactor(Reactor):
    def __init__(self, pool):
        self.pool = pool
        self.switch = None
        self._peers: dict[str, object] = {}
        # peer id -> set of evidence hashes already sent
        self._sent: dict[str, set[bytes]] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=6)]

    def set_switch(self, switch) -> None:
        self.switch = switch
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._broadcast_loop, daemon=True, name="ev-gossip"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def add_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
            self._sent.setdefault(peer.id, set())

    def remove_peer(self, peer, reason) -> None:
        with self._lock:
            self._peers.pop(peer.id, None)
            self._sent.pop(peer.id, None)

    def receive(self, chan_id: int, peer, raw: bytes) -> None:
        try:
            ev = decode_evidence(raw)
        except Exception:  # noqa: BLE001 — malformed: drop
            return
        try:
            self.pool.add_evidence(ev)
        except Exception as e:  # noqa: BLE001 — invalid evidence: drop
            _log.debug("rejected peer evidence", peer=peer.id[:8],
                       err=str(e)[:80])
            return
        with self._lock:
            sent = self._sent.get(peer.id)
        if sent is not None:
            sent.add(ev.hash())  # the sender obviously has it

    def _broadcast_loop(self) -> None:
        while not self._stopped.wait(BROADCAST_INTERVAL_S):
            try:
                pending = self.pool.pending_evidence()
            except Exception:  # noqa: BLE001
                continue
            if not pending:
                continue
            with self._lock:
                peers = list(self._peers.items())
            for pid, peer in peers:
                with self._lock:
                    sent = self._sent.setdefault(pid, set())
                for ev in pending:
                    h = ev.hash()
                    if h in sent:
                        continue
                    try:
                        peer.send(EVIDENCE_CHANNEL, ev.wrapped())
                        sent.add(h)
                    except Exception:  # noqa: BLE001 — peer going away
                        break
