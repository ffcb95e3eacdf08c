"""Votes and their canonical sign-bytes.

Sign-bytes are the varint-delimited proto encoding of CanonicalVote
(reference types/vote.go:133-141 SignBytes, types/canonical.go:57-66),
bit-exact against the reference's golden vectors (types/vote_test.go:63).
The port's own copy of `cometbft_tpu/types/vote.py`, unchanged.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..encoding import proto as pb
from .basic import BlockID, Timestamp, ZERO_BLOCK_ID, ZERO_TIME


class SignedMsgType(enum.IntEnum):
    UNKNOWN = 0
    PREVOTE = 1
    PRECOMMIT = 2
    PROPOSAL = 32


def canonical_vote_bytes(
    msg_type: int,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp: Timestamp,
    chain_id: str,
) -> bytes:
    """Varint-delimited CanonicalVote: the bytes validators sign."""
    payload = (
        pb.f_varint(1, int(msg_type))
        + pb.f_sfixed64(2, height)
        + pb.f_sfixed64(3, round_)
        + pb.f_embedded_opt(4, block_id.encode_canonical())
        + pb.f_embedded(5, timestamp.encode())
        + pb.f_string(6, chain_id)
    )
    return pb.length_prefixed(payload)


def canonical_vote_extension_bytes(
    extension: bytes, height: int, round_: int, chain_id: str
) -> bytes:
    """Varint-delimited CanonicalVoteExtension
    (reference types/canonical.go CanonicalizeVoteExtension)."""
    payload = (
        pb.f_bytes(1, extension)
        + pb.f_sfixed64(2, height)
        + pb.f_sfixed64(3, round_)
        + pb.f_string(4, chain_id)
    )
    return pb.length_prefixed(payload)


def canonical_proposal_bytes(
    height: int,
    round_: int,
    pol_round: int,
    block_id: BlockID,
    timestamp: Timestamp,
    chain_id: str,
) -> bytes:
    """Varint-delimited CanonicalProposal (reference types/proposal.go)."""
    payload = (
        pb.f_varint(1, int(SignedMsgType.PROPOSAL))
        + pb.f_sfixed64(2, height)
        + pb.f_sfixed64(3, round_)
        + pb.f_varint(4, pol_round)
        + pb.f_embedded_opt(5, block_id.encode_canonical())
        + pb.f_embedded(6, timestamp.encode())
        + pb.f_string(7, chain_id)
    )
    return pb.length_prefixed(payload)


@dataclass
class Vote:
    """A prevote or precommit for a block (reference types/vote.go)."""

    type: SignedMsgType = SignedMsgType.UNKNOWN
    height: int = 0
    round: int = 0
    block_id: BlockID = ZERO_BLOCK_ID
    timestamp: Timestamp = ZERO_TIME
    validator_address: bytes = b""
    validator_index: int = 0
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_bytes(
            self.type, self.height, self.round, self.block_id, self.timestamp, chain_id
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical_vote_extension_bytes(
            self.extension, self.height, self.round, chain_id
        )

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    # --- full (non-canonical) proto encoding, used for storage/gossip ---
    def encode(self) -> bytes:
        return (
            pb.f_varint(1, int(self.type))
            + pb.f_varint(2, self.height)
            + pb.f_varint(3, self.round)
            + pb.f_embedded(4, self.block_id.encode())
            + pb.f_embedded(5, self.timestamp.encode())
            + pb.f_bytes(6, self.validator_address)
            + pb.f_varint(7, self.validator_index)
            + pb.f_bytes(8, self.signature)
            + pb.f_bytes(9, self.extension)
            + pb.f_bytes(10, self.extension_signature)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "Vote":
        d = pb.fields_to_dict(buf)
        return cls(
            type=SignedMsgType(int(d.get(1, 0))),
            height=pb.to_i64(d.get(2, 0)),
            round=pb.to_i64(d.get(3, 0)),
            block_id=BlockID.decode(pb.as_bytes(d.get(4, b""))),
            timestamp=Timestamp.decode(pb.as_bytes(d.get(5, b""))),
            validator_address=pb.as_bytes(d.get(6, b"")),
            validator_index=pb.to_i64(d.get(7, 0)),
            signature=pb.as_bytes(d.get(8, b"")),
            extension=pb.as_bytes(d.get(9, b"")),
            extension_signature=pb.as_bytes(d.get(10, b"")),
        )
