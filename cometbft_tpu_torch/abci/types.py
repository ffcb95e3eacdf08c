"""ABCI request/response types and the Application interface.

Field shapes mirror the reference's abci/types protos (v1) at the level
consumers need; the in-process representation is plain dataclasses, with
proto encoding only at the socket/grpc boundary.

Twin of `cometbft_tpu/abci/types.py`.
"""

from __future__ import annotations

from abc import ABC
from dataclasses import dataclass, field

from ..types import Timestamp, ZERO_TIME

CODE_TYPE_OK = 0


@dataclass
class ValidatorUpdate:
    pub_key_bytes: bytes
    pub_key_type: str = "ed25519"
    power: int = 0


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = field(default_factory=list)

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        """Deterministic encoding feeding last_results_hash
        (reference types/results.go ABCIResults.Hash: merkle over
        deterministic subset: Code, Data, GasWanted, GasUsed)."""
        from ..encoding import proto as pb

        return (
            pb.f_varint(1, self.code)
            + pb.f_bytes(2, self.data)
            + pb.f_varint(5, self.gas_wanted)
            + pb.f_varint(6, self.gas_used)
        )


@dataclass
class CheckTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class InfoResponse:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class InitChainRequest:
    time: Timestamp = ZERO_TIME
    chain_id: str = ""
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class InitChainResponse:
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class QueryResponse:
    code: int = CODE_TYPE_OK
    key: bytes = b""
    value: bytes = b""
    height: int = 0
    log: str = ""


class ProposalStatus:
    ACCEPT = 1
    REJECT = 2


class OfferSnapshotResult:
    """reference abci OFFER_SNAPSHOT_RESULT_* enum."""

    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    REJECT = 3
    REJECT_FORMAT = 4
    REJECT_SENDER = 5


class ApplySnapshotChunkResult:
    """reference abci APPLY_SNAPSHOT_CHUNK_RESULT_* enum."""

    UNKNOWN = 0
    ACCEPT = 1
    ABORT = 2
    RETRY = 3
    RETRY_SNAPSHOT = 4
    REJECT_SNAPSHOT = 5


@dataclass
class Misbehavior:
    type: int = 0  # 1 = duplicate vote, 2 = light client attack
    validator_address: bytes = b""
    validator_power: int = 0
    height: int = 0
    time: Timestamp = ZERO_TIME
    total_voting_power: int = 0


@dataclass
class CommitInfo:
    round: int = 0
    votes: list = field(default_factory=list)  # (address, power, signed_last_block)


@dataclass
class FinalizeBlockRequest:
    txs: list[bytes] = field(default_factory=list)
    decided_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = ZERO_TIME
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class FinalizeBlockResponse:
    events: list = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: object | None = None
    app_hash: bytes = b""


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


class Application(ABC):
    """The 14-method ABCI application interface
    (reference abci/types/application.go:9-35). Default implementations
    are no-ops so simple apps override only what they need."""

    # --- info/query connection ---
    def info(self) -> InfoResponse:
        return InfoResponse()

    def query(self, path: str, data: bytes, height: int = 0) -> QueryResponse:
        return QueryResponse()

    # --- mempool connection ---
    def check_tx(self, tx: bytes) -> CheckTxResult:
        return CheckTxResult()

    def check_txs(self, txs: list[bytes]) -> list[CheckTxResult]:
        """Batched CheckTx: one call per admission window instead of one
        per tx, so a serialized client (LocalClient's shared mutex) pays
        its lock once per window. Apps with per-tx logic get the loop
        for free; apps that can vectorize override this."""
        return [self.check_tx(tx) for tx in txs]

    # --- consensus connection ---
    def init_chain(self, req: InitChainRequest) -> InitChainResponse:
        return InitChainResponse()

    def prepare_proposal(self, txs: list[bytes], max_tx_bytes: int,
                         local_last_commit=None) -> list[bytes]:
        """local_last_commit: ExtendedCommit with the vote extensions the
        app attached at height-1 (None while extensions are disabled) —
        reference PrepareProposalRequest.LocalLastCommit."""
        # columnar fast path (mempool/txcolumns.py): the default
        # byte-budget prefix is an offsets bisect sharing the blob —
        # same txs as the loop below, no per-tx materialization
        prefix = getattr(txs, "prefix_max_bytes", None)
        if prefix is not None:
            return prefix(max_tx_bytes)
        out, total = [], 0
        for tx in txs:
            total += len(tx)
            if total > max_tx_bytes:
                break
            out.append(tx)
        return out

    def process_proposal(self, txs: list[bytes]) -> int:
        return ProposalStatus.ACCEPT

    def finalize_block(self, req: FinalizeBlockRequest) -> FinalizeBlockResponse:
        return FinalizeBlockResponse(
            tx_results=[ExecTxResult() for _ in req.txs]
        )

    def extend_vote(self, height: int, round_: int, block_hash: bytes) -> bytes:
        return b""

    def verify_vote_extension(self, height: int, addr: bytes, ext: bytes) -> bool:
        return True

    def commit(self) -> int:
        """Returns retain_height (0 = keep everything)."""
        return 0

    # --- snapshot connection ---
    def list_snapshots(self) -> list[Snapshot]:
        return []

    def offer_snapshot(self, snapshot: Snapshot, app_hash: bytes) -> int:
        return 0  # reject

    def load_snapshot_chunk(self, height: int, format_: int, chunk: int) -> bytes:
        return b""

    def apply_snapshot_chunk(self, index: int, chunk: bytes, sender: str) -> int:
        return 0
