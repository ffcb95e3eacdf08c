"""Consensus (twin of `cometbft_tpu/consensus/`): the state machine, its
vote sets, WAL and ticker, the loopback network, and the p2p reactor in
`reactor.py`."""

from .height_vote_set import HeightVoteSet
from .ticker import ManualTicker, TimeoutInfo, TimeoutTicker
from .wal import WAL, EndHeightMessage, TimedWALMessage

__all__ = [
    "HeightVoteSet",
    "ManualTicker",
    "TimeoutInfo",
    "TimeoutTicker",
    "WAL",
    "EndHeightMessage",
    "TimedWALMessage",
]
