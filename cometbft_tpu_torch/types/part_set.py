"""Block part sets: 64 KiB chunks with merkle proofs for gossip
(reference types/part_set.go, BlockPartSizeBytes). The port's own copy of
`cometbft_tpu/types/part_set.py`, unchanged."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle
from .basic import PartSetHeader

PART_SIZE = 65536


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof


class PartSet:
    def __init__(self, parts: list[Part], header: PartSetHeader):
        self.parts = parts
        self.header = header

    @classmethod
    def from_data(cls, data: bytes) -> "PartSet":
        chunks = [data[i : i + PART_SIZE] for i in range(0, len(data), PART_SIZE)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        parts = [Part(i, c, p) for i, (c, p) in enumerate(zip(chunks, proofs))]
        return cls(parts, PartSetHeader(total=len(chunks), hash=root))

    def assemble(self) -> bytes:
        return b"".join(p.bytes_ for p in sorted(self.parts, key=lambda p: p.index))

    @staticmethod
    def verify_part(header: PartSetHeader, part: Part) -> bool:
        return (
            part.proof.total == header.total
            and part.proof.index == part.index
            and part.proof.verify(header.hash, part.bytes_)
        )
