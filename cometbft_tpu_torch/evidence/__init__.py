"""The evidence pool (twin of `cometbft_tpu/evidence/`)."""

from .pool import EvidencePool

__all__ = ["EvidencePool"]
