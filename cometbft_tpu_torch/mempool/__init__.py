"""The mempool: `CListMempool`, its LRU cache and `NopMempool`, and the
micro-batched `AdmissionPipeline` with the STX signed-tx envelope (twin
of `cometbft_tpu/mempool/`; the gossip reactor comes with the p2p
slice)."""

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
