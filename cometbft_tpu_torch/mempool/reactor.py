"""Twin of `cometbft_tpu/mempool/reactor.py`. Mempool reactor: tx gossip over p2p (reference mempool/reactor.go).

Broadcasts newly admitted txs to peers on the mempool channel; received
txs go through CheckTx with the sender recorded so they are not echoed
back (the reference tracks per-peer send state; v1 relies on the LRU
cache to stop loops).

Gossip is batched end-to-end. The mempool's notifier hands the
reactor whole admission windows (`on_new_txs`), which it coalesces into
one multi-tx wire frame (repeated field 1 — old single-tx frames are
the n=1 case, so mixed-version links keep working) and hands to the
switch's backpressure-aware broadcast queue instead of fanning out
per-tx from the admitting thread. Received frames feed the admission
pipeline via the non-blocking submit path."""

from __future__ import annotations

import random

from ..encoding import proto as pb
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..utils import txlife as _txlife

MEMPOOL_CHANNEL = 0x30


class MempoolReactor(Reactor):
    def __init__(self, mempool, max_gossip_peers: int = 0):
        """max_gossip_peers > 0 caps tx fan-out to that many peers per
        broadcast (the reference's experimental
        max-gossip-connections-to-{persistent,non-persistent}-peers
        bound, mempool/reactor.go): in dense topologies flooding every
        peer mostly delivers duplicates, and the cap trades redundancy
        for bandwidth. 0 = flood all peers (default, like the
        reference)."""
        self.mempool = mempool
        self.switch = None
        self.max_gossip_peers = max_gossip_peers
        mempool.on_new_txs.append(self._broadcast_txs)

    def channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5)]

    def set_switch(self, switch) -> None:
        self.switch = switch

    def _broadcast_txs(self, txs: list[bytes]) -> None:
        if self.switch is None or not txs:
            return
        # one frame per window: repeated field 1
        payload = b"".join(
            pb.f_bytes(1, tx, emit_empty=True) for tx in txs
        )
        if self.max_gossip_peers <= 0:
            # flood path: queue on the switch's async broadcast worker
            # (backpressure-aware)
            self.switch.queue_broadcast(MEMPOOL_CHANNEL, payload)
            return
        # sample a fresh subset per broadcast: a fixed prefix would
        # permanently starve the peers beyond the cap
        peers = list(self.switch.peers())
        if len(peers) > self.max_gossip_peers:
            peers = random.sample(peers, self.max_gossip_peers)
        for peer in peers:
            try:
                peer.send(MEMPOOL_CHANNEL, payload)
            except Exception:  # noqa: BLE001 — dead peer: skip
                continue

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        # multi-tx frames carry repeated field 1; fields_to_dict is
        # last-wins, so walk the raw field list
        txs = [
            pb.as_bytes(v)
            for f, _wt, v in pb.parse_fields(msg)
            if f == 1
        ]
        for tx in txs:
            if _txlife.enabled:
                _txlife.track(tx, "arrival", src="gossip")
            # non-blocking: the admission pipeline delivers the verdict
            # to the future; peer gossip ignores it
            self.mempool.submit_tx(tx, from_peer=peer.id).add_done_callback(_swallow)


def _swallow(fut) -> None:
    fut.exception()  # consume so rejected gossip doesn't warn
