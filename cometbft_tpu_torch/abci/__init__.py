"""ABCI: the application boundary (reference abci/types/application.go:9-35).

14 methods in 4 groups — Info/Query; CheckTx (mempool); InitChain/
PrepareProposal/ProcessProposal/FinalizeBlock/ExtendVote/
VerifyVoteExtension/Commit (consensus); ListSnapshots/OfferSnapshot/
LoadSnapshotChunk/ApplySnapshotChunk (state sync).

Twin of `cometbft_tpu/abci/` for the in-process path: the types, the
FinalizeBlock response's wire encoding, the local client and the kvstore
app. The socket and gRPC transports (with the rest of the wire codecs)
and the tx grammar are not here yet.
"""

from .types import (  # noqa: F401
    Application,
    CheckTxResult,
    ExecTxResult,
    FinalizeBlockRequest,
    FinalizeBlockResponse,
    InfoResponse,
    InitChainRequest,
    InitChainResponse,
    ProposalStatus,
    QueryResponse,
    Snapshot,
    ValidatorUpdate,
)
from .client import AppConns, LocalClient  # noqa: F401
from .kvstore import KVStoreApp  # noqa: F401
