"""The evidence pool and its gossip reactor in `reactor.py` (twin of
`cometbft_tpu/evidence/`)."""

from .pool import EvidencePool

__all__ = ["EvidencePool"]
