"""The mempool: `CListMempool`, its LRU cache and `NopMempool`, the
micro-batched `AdmissionPipeline` with the STX signed-tx envelope, and
the gossip reactor in `reactor.py` (twin of `cometbft_tpu/mempool/`)."""

from .admission import AdmissionPipeline, parse_signed_tx, wrap_signed_tx
from .mempool import CListMempool, LRUTxCache, NopMempool, TxKey

__all__ = [
    "AdmissionPipeline",
    "CListMempool",
    "LRUTxCache",
    "NopMempool",
    "TxKey",
    "parse_signed_tx",
    "wrap_signed_tx",
]
