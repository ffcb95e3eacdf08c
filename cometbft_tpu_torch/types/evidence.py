"""Evidence of Byzantine behavior (twin of `cometbft_tpu/types/evidence.py`).

Behavior parity: reference types/evidence.go —
- DuplicateVoteEvidence (:36): two conflicting signed votes at one HRS;
  constructor orders VoteA/VoteB by BlockID key (:58-66).
- LightClientAttackEvidence (:210): a conflicting light block + the common
  height, with the byzantine subset (:253 GetByzantineValidators).
- EvidenceList hash = merkle over each evidence's oneof-wrapped proto
  bytes (types/evidence.go EvidenceList.Hash).

The encodings are the reference's bytes: a block's evidence_hash and
its hash depend on them. A conflicting block whose validator set holds
a key that is not Ed25519 is refused by name at decode
(`validator_set.decode_pub_key` raises UnsupportedKeyType), as every
other decode of a set in the port is.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle
from ..crypto.keys import tmhash
from ..encoding import proto as pb
from .basic import Timestamp, ZERO_TIME
from .validator_set import ValidatorSet
from .vote import SignedMsgType, Vote


class EvidenceError(Exception):
    pass


@dataclass
class DuplicateVoteEvidence:
    vote_a: Vote = None
    vote_b: Vote = None
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = ZERO_TIME

    ABCI_TYPE = 1  # MisbehaviorType duplicate vote

    @classmethod
    def from_votes(cls, a: Vote, b: Vote, validator_power: int,
                   total_voting_power: int, time: Timestamp
                   ) -> "DuplicateVoteEvidence":
        if a is None or b is None:
            raise EvidenceError("missing vote")
        # order by block id key (reference NewDuplicateVoteEvidence :58)
        if b.block_id.key() < a.block_id.key():
            a, b = b, a
        return cls(a, b, total_voting_power, validator_power, time)

    @property
    def height(self) -> int:
        return self.vote_a.height

    def address(self) -> bytes:
        return self.vote_a.validator_address

    def encode(self) -> bytes:
        return (
            pb.f_embedded(1, self.vote_a.encode())
            + pb.f_embedded(2, self.vote_b.encode())
            + pb.f_varint(3, self.total_voting_power)
            + pb.f_varint(4, self.validator_power)
            + pb.f_embedded(5, self.timestamp.encode())
        )

    @classmethod
    def decode(cls, buf: bytes) -> "DuplicateVoteEvidence":
        d = pb.fields_to_dict(buf)
        return cls(
            Vote.decode(pb.as_bytes(d.get(1, b""))),
            Vote.decode(pb.as_bytes(d.get(2, b""))),
            pb.to_i64(d.get(3, 0)),
            pb.to_i64(d.get(4, 0)),
            Timestamp.decode(pb.as_bytes(d.get(5, b""))),
        )

    def wrapped(self) -> bytes:
        """Evidence oneof wrapper (field 1 = duplicate vote)."""
        return pb.f_embedded(1, self.encode())

    def hash(self) -> bytes:
        return tmhash(self.wrapped())

    def to_abci_list(self):
        from ..abci.types import Misbehavior

        return [Misbehavior(
            type=self.ABCI_TYPE,
            validator_address=self.address(),
            validator_power=self.validator_power,
            height=self.height,
            time=self.timestamp,
            total_voting_power=self.total_voting_power,
        )]

    def verify(self, chain_id: str, vals: ValidatorSet) -> None:
        """Structural + signature verification
        (reference internal/evidence/verify.go VerifyDuplicateVote :~180)."""
        a, b = self.vote_a, self.vote_b
        if a.height != b.height or a.round != b.round or a.type != b.type:
            raise EvidenceError("votes from different HRS")
        if a.type not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise EvidenceError("invalid vote type")
        if a.validator_address != b.validator_address:
            raise EvidenceError("votes from different validators")
        if a.block_id == b.block_id:
            raise EvidenceError("votes for the same block are not equivocation")
        if b.block_id.key() < a.block_id.key():
            raise EvidenceError("votes not ordered by block id")
        _, val = vals.get_by_address(a.validator_address)
        if val is None:
            raise EvidenceError("validator not in set at evidence height")
        if val.voting_power != self.validator_power:
            raise EvidenceError("validator power mismatch")
        if vals.total_voting_power() != self.total_voting_power:
            raise EvidenceError("total power mismatch")
        for v in (a, b):
            if not val.pub_key.verify_signature(v.sign_bytes(chain_id), v.signature):
                raise EvidenceError("invalid vote signature in evidence")


@dataclass
class LightClientAttackEvidence:
    """A conflicting (forged) light block (reference types/evidence.go:210)."""

    conflicting_block: object = None  # light.LightBlock
    common_height: int = 0
    byzantine_validators: list = field(default_factory=list)  # addresses
    total_voting_power: int = 0
    timestamp: Timestamp = ZERO_TIME

    ABCI_TYPE = 2

    @property
    def height(self) -> int:
        return self.common_height

    def encode(self) -> bytes:
        cb = self.conflicting_block
        payload = pb.f_embedded(1, cb.signed_header.encode()) if cb else b""
        from ..state.types import encode_validator_set

        if cb is not None:
            payload += pb.f_embedded(2, encode_validator_set(cb.validators))
        payload += pb.f_varint(3, self.common_height)
        for addr in self.byzantine_validators:
            payload += pb.f_bytes(4, addr, emit_empty=True)
        payload += pb.f_varint(5, self.total_voting_power)
        payload += pb.f_embedded(6, self.timestamp.encode())
        return payload

    @classmethod
    def decode(cls, buf: bytes) -> "LightClientAttackEvidence":
        from ..light.types import LightBlock, SignedHeader
        from ..state.types import decode_validator_set

        sh = vals = None
        common = tvp = 0
        ts = ZERO_TIME
        byz = []
        for f, _, v in pb.parse_fields(buf):
            if f == 1:
                sh = SignedHeader.decode(pb.as_bytes(v))
            elif f == 2:
                vals = decode_validator_set(pb.as_bytes(v))
            elif f == 3:
                common = pb.to_i64(v)
            elif f == 4:
                byz.append(pb.as_bytes(v))
            elif f == 5:
                tvp = pb.to_i64(v)
            elif f == 6:
                ts = Timestamp.decode(pb.as_bytes(v))
        cb = LightBlock(sh, vals) if sh is not None and vals is not None else None
        return cls(cb, common, byz, tvp, ts)

    def wrapped(self) -> bytes:
        return pb.f_embedded(2, self.encode())

    def hash(self) -> bytes:
        return tmhash(self.wrapped())

    def to_abci_list(self):
        """One Misbehavior per byzantine validator with its power
        (reference types/evidence.go LightClientAttackEvidence.ABCI)."""
        from ..abci.types import Misbehavior

        vals = self.conflicting_block.validators if self.conflicting_block else None
        out = []
        for addr in self.byzantine_validators:
            power = 0
            if vals is not None:
                _, v = vals.get_by_address(addr)
                power = v.voting_power if v else 0
            out.append(Misbehavior(
                type=self.ABCI_TYPE,
                validator_address=addr,
                validator_power=power,
                height=self.common_height,
                time=self.timestamp,
                total_voting_power=self.total_voting_power,
            ))
        return out


def decode_evidence(buf: bytes):
    """Evidence oneof -> concrete type."""
    fields = pb.parse_fields(buf)
    if not fields:
        raise EvidenceError("empty evidence")
    fnum, _, v = fields[0]
    if fnum == 1:
        return DuplicateVoteEvidence.decode(pb.as_bytes(v))
    if fnum == 2:
        return LightClientAttackEvidence.decode(pb.as_bytes(v))
    raise EvidenceError(f"unknown evidence tag {fnum}")


def evidence_list_hash(evidence: list) -> bytes:
    return merkle.hash_from_byte_slices([ev.wrapped() for ev in evidence])
