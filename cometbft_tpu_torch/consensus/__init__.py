"""In-process consensus (twin of `cometbft_tpu/consensus/`): the state
machine, its vote sets, WAL and ticker, and the loopback network. The p2p
reactor comes with the node."""

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
