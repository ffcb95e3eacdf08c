"""The `State` value object (reference internal/state/state.go:352).

Everything needed to validate and execute the next block: rotated
validator sets (last/current/next), consensus params, app hash, last
results hash. Immutable-ish: every ApplyBlock produces a new State.

Twin of `cometbft_tpu/state/types.py`, the same proto bytes. The
validator-set encoding lives in the port's `types/validator_set.py` and
is re-exported here under the reference's names.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..encoding import proto as pb
from ..types import BlockID, Timestamp, ValidatorSet, ZERO_TIME
from ..types.basic import ZERO_BLOCK_ID
from ..types.validator_set import (  # noqa: F401 (re-exported)
    decode_validator_set,
    encode_validator_set,
)


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 4 * 1024 * 1024  # reference types/params.go defaults
    max_gas: int = -1


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1024 * 1024


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple[str, ...] = ("ed25519",)


@dataclass(frozen=True)
class ABCIParams:
    vote_extensions_enable_height: int = 0


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    abci: ABCIParams = field(default_factory=ABCIParams)

    def hash(self) -> bytes:
        """Hash over the consensus-critical params (reference
        types/params.go HashConsensusParams: SHA-256 of proto of
        block.max_bytes/max_gas)."""
        from ..crypto.keys import tmhash

        payload = pb.f_varint(1, self.block.max_bytes) + pb.f_varint(
            2, self.block.max_gas
        )
        return tmhash(payload)


def encode_params(cp: ConsensusParams) -> bytes:
    """Proto encoding of the full ConsensusParams (reference
    types/params.go ToProto) for per-height persistence."""
    block = pb.f_varint(1, cp.block.max_bytes) + pb.f_varint(2, cp.block.max_gas)
    ev = (
        pb.f_varint(1, cp.evidence.max_age_num_blocks)
        + pb.f_varint(2, cp.evidence.max_age_duration_ns)
        + pb.f_varint(3, cp.evidence.max_bytes)
    )
    val = b"".join(pb.f_string(1, t) for t in cp.validator.pub_key_types)
    abci = pb.f_varint(1, cp.abci.vote_extensions_enable_height)
    return (
        pb.f_embedded(1, block)
        + pb.f_embedded(2, ev)
        + pb.f_embedded(3, val)
        + pb.f_embedded(4, abci)
    )


def decode_params(buf: bytes) -> ConsensusParams:
    d = pb.fields_to_dict(buf)
    bd = pb.fields_to_dict(pb.as_bytes(d.get(1, b"")))
    ed = pb.fields_to_dict(pb.as_bytes(d.get(2, b"")))
    key_types = tuple(
        pb.as_bytes(v).decode()
        for f, _, v in pb.parse_fields(pb.as_bytes(d.get(3, b"")))
        if f == 1
    )
    ad = pb.fields_to_dict(pb.as_bytes(d.get(4, b"")))
    return ConsensusParams(
        block=BlockParams(
            max_bytes=pb.to_i64(bd.get(1, 0)) or BlockParams.max_bytes,
            max_gas=pb.to_i64(bd.get(2, 0)) or -1,
        ),
        evidence=EvidenceParams(
            max_age_num_blocks=pb.to_i64(ed.get(1, 0)),
            max_age_duration_ns=pb.to_i64(ed.get(2, 0)),
            max_bytes=pb.to_i64(ed.get(3, 0)),
        ),
        validator=ValidatorParams(pub_key_types=key_types or ("ed25519",)),
        abci=ABCIParams(
            vote_extensions_enable_height=pb.to_i64(ad.get(1, 0))
        ),
    )


@dataclass
class State:
    chain_id: str = ""
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = ZERO_BLOCK_ID
    last_block_time: Timestamp = ZERO_TIME
    validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    next_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_params_changed: int = 1
    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def __post_init__(self):
        # State snapshots alias ValidatorSet objects (no defensive
        # copies); the convention is that every mutator works on a
        # private .copy(). Freezing here — the single choke point every
        # producer passes through (decode, statesync, rollback, genesis,
        # dataclasses.replace) — makes a violation fail loudly instead
        # of silently corrupting historical sets.
        for vs in (self.validators, self.last_validators, self.next_validators):
            if vs is not None:
                vs.freeze()

    def copy(self) -> "State":
        return replace(self)

    def encode(self) -> bytes:
        out = (
            pb.f_string(1, self.chain_id)
            + pb.f_varint(2, self.initial_height)
            + pb.f_varint(3, self.last_block_height)
            + pb.f_embedded(4, self.last_block_id.encode())
            + pb.f_embedded(5, self.last_block_time.encode())
            + pb.f_varint(8, self.last_height_validators_changed)
            + pb.f_bytes(10, self.last_results_hash)
            + pb.f_bytes(11, self.app_hash)
            + pb.f_varint(12, self.last_height_params_changed)
            + pb.f_embedded(13, encode_params(self.consensus_params))
        )
        if self.validators is not None:
            out += pb.f_embedded(6, encode_validator_set(self.validators))
        if self.last_validators is not None:
            out += pb.f_embedded(7, encode_validator_set(self.last_validators))
        if self.next_validators is not None:
            out += pb.f_embedded(9, encode_validator_set(self.next_validators))
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "State":
        d = pb.fields_to_dict(buf)
        return cls(
            chain_id=pb.as_bytes(d.get(1, b"")).decode(),
            initial_height=pb.to_i64(d.get(2, 1)),
            last_block_height=pb.to_i64(d.get(3, 0)),
            last_block_id=BlockID.decode(pb.as_bytes(d.get(4, b""))),
            last_block_time=Timestamp.decode(pb.as_bytes(d.get(5, b""))),
            validators=decode_validator_set(pb.as_bytes(d[6])) if 6 in d else None,
            last_validators=decode_validator_set(pb.as_bytes(d[7])) if 7 in d else None,
            next_validators=decode_validator_set(pb.as_bytes(d[9])) if 9 in d else None,
            last_height_validators_changed=pb.to_i64(d.get(8, 1)),
            last_results_hash=pb.as_bytes(d.get(10, b"")),
            app_hash=pb.as_bytes(d.get(11, b"")),
            last_height_params_changed=pb.to_i64(d.get(12, 1)),
            consensus_params=(
                decode_params(pb.as_bytes(d[13])) if 13 in d else ConsensusParams()
            ),
        )
