"""Primitive consensus types: timestamps, part-set headers, block IDs.

The port's own copy of `cometbft_tpu/types/basic.py`, unchanged."""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding import proto as pb

# Go's zero time (0001-01-01T00:00:00Z) as a protobuf Timestamp.
GO_ZERO_SECONDS = -62135596800


@dataclass(frozen=True)
class Timestamp:
    """google.protobuf.Timestamp: (seconds since unix epoch, nanos)."""

    seconds: int = GO_ZERO_SECONDS
    nanos: int = 0

    def encode(self) -> bytes:
        return pb.f_varint(1, self.seconds) + pb.f_varint(2, self.nanos)

    @classmethod
    def decode(cls, buf: bytes) -> "Timestamp":
        d = pb.fields_to_dict(buf)
        return cls(pb.to_i64(d.get(1, 0)), pb.to_i64(d.get(2, 0)))

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_SECONDS and self.nanos == 0

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Timestamp":
        return cls(ns // 1_000_000_000, ns % 1_000_000_000)

    def unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos

    def __lt__(self, other: "Timestamp") -> bool:
        return (self.seconds, self.nanos) < (other.seconds, other.nanos)

    def __le__(self, other: "Timestamp") -> bool:
        return (self.seconds, self.nanos) <= (other.seconds, other.nanos)


ZERO_TIME = Timestamp()


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def encode(self) -> bytes:
        return pb.f_varint(1, self.total) + pb.f_bytes(2, self.hash)

    @classmethod
    def decode(cls, buf: bytes) -> "PartSetHeader":
        d = pb.fields_to_dict(buf)
        return cls(int(d.get(1, 0)), pb.as_bytes(d.get(2, b"")))

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash


@dataclass(frozen=True)
class BlockID:
    """Block identity: header hash + part-set header
    (reference types/block.go BlockID)."""

    hash: bytes = b""
    part_set_header: PartSetHeader = PartSetHeader()

    def encode(self) -> bytes:
        return pb.f_bytes(1, self.hash) + pb.f_embedded(
            2, self.part_set_header.encode()
        )

    @classmethod
    def decode(cls, buf: bytes) -> "BlockID":
        d = pb.fields_to_dict(buf)
        return cls(
            pb.as_bytes(d.get(1, b"")), PartSetHeader.decode(pb.as_bytes(d.get(2, b"")))
        )

    def is_zero(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def key(self) -> bytes:
        """Stable map key (reference types/block.go BlockID.Key)."""
        return (
            self.hash
            + self.part_set_header.total.to_bytes(4, "big")
            + self.part_set_header.hash
        )

    def encode_canonical(self) -> bytes | None:
        """CanonicalBlockID payload, or None when zero (omitted from
        CanonicalVote per reference types/canonical.go CanonicalizeBlockID)."""
        if self.is_zero():
            return None
        psh = pb.f_varint(1, self.part_set_header.total) + pb.f_bytes(
            2, self.part_set_header.hash
        )
        return pb.f_bytes(1, self.hash) + pb.f_embedded(2, psh)


ZERO_BLOCK_ID = BlockID()
