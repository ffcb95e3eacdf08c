"""Light client data types (reference types/light.go).

The port's own copy of `cometbft_tpu/light/types.py`, plus the proto
encoding of LightBlock (cometbft.types.v1.LightBlock: signed header 1,
validator set 2), so a light block carries across as bytes."""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding import proto as pb
from ..types import Commit, Header, ValidatorSet
from ..types.validator_set import decode_validator_set, encode_validator_set


@dataclass
class SignedHeader:
    """Header + the commit that signed it (reference types/light.go:83)."""

    header: Header
    commit: Commit

    def basic_validate(self, chain_id: str) -> None:
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header chain id {self.header.chain_id!r} != {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError("commit height != header height")
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit signs a different header")

    def encode(self) -> bytes:
        return pb.f_embedded(1, self.header.encode()) + pb.f_embedded(
            2, self.commit.encode()
        )

    @classmethod
    def decode(cls, buf: bytes) -> "SignedHeader":
        d = pb.fields_to_dict(buf)
        return cls(
            Header.decode(pb.as_bytes(d.get(1, b""))),
            Commit.decode(pb.as_bytes(d.get(2, b""))),
        )


@dataclass
class LightBlock:
    """SignedHeader + the validator set of that height
    (reference types/light.go:12)."""

    signed_header: SignedHeader
    validators: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.header.height

    @property
    def time(self):
        return self.signed_header.header.time

    def basic_validate(self, chain_id: str) -> None:
        self.signed_header.basic_validate(chain_id)
        if self.signed_header.header.validators_hash != self.validators.hash():
            raise ValueError("validator set does not match header validators_hash")

    def encode(self) -> bytes:
        return pb.f_embedded(1, self.signed_header.encode()) + pb.f_embedded(
            2, encode_validator_set(self.validators)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "LightBlock":
        d = pb.fields_to_dict(buf)
        return cls(
            SignedHeader.decode(pb.as_bytes(d.get(1, b""))),
            decode_validator_set(pb.as_bytes(d.get(2, b""))),
        )
