"""Block proposals (reference types/proposal.go).

The port's own copy of `cometbft_tpu/types/proposal.py`, unchanged: the
sign bytes are `types/vote.py::canonical_proposal_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding import proto as pb
from .basic import BlockID, Timestamp, ZERO_BLOCK_ID, ZERO_TIME
from .vote import SignedMsgType, canonical_proposal_bytes


@dataclass
class Proposal:
    height: int = 0
    round: int = 0
    pol_round: int = -1  # proof-of-lock round; -1 when none
    block_id: BlockID = ZERO_BLOCK_ID
    timestamp: Timestamp = ZERO_TIME
    signature: bytes = b""

    @property
    def type(self) -> SignedMsgType:
        return SignedMsgType.PROPOSAL

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical_proposal_bytes(
            self.height, self.round, self.pol_round, self.block_id,
            self.timestamp, chain_id,
        )

    def basic_validate(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.pol_round < -1 or (
            self.pol_round >= 0 and self.pol_round >= self.round
        ):
            raise ValueError("invalid POL round")
        if self.block_id.is_zero():
            raise ValueError("proposal for nil block")

    def encode(self) -> bytes:
        return (
            pb.f_varint(1, int(SignedMsgType.PROPOSAL))
            + pb.f_varint(2, self.height)
            + pb.f_varint(3, self.round)
            + pb.f_varint(4, self.pol_round)
            + pb.f_embedded(5, self.block_id.encode())
            + pb.f_embedded(6, self.timestamp.encode())
            + pb.f_bytes(7, self.signature)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "Proposal":
        d = pb.fields_to_dict(buf)
        return cls(
            height=pb.to_i64(d.get(2, 0)),
            round=pb.to_i64(d.get(3, 0)),
            pol_round=pb.to_i64(d.get(4, 0)),
            block_id=BlockID.decode(pb.as_bytes(d.get(5, b""))),
            timestamp=Timestamp.decode(pb.as_bytes(d.get(6, b""))),
            signature=pb.as_bytes(d.get(7, b"")),
        )
