"""ExtendedCommit: a commit carrying vote extensions.

Behavior parity: reference types proto ExtendedCommit/ExtendedCommitSig
(types.proto:123-145, field numbers matched) and types/vote_set.go
MakeExtendedCommit — precommits keep their app-supplied vote extension
and its separate signature so PrepareProposal can deliver them to the
application at the next height (ABCI LocalLastCommit).

Twin of `cometbft_tpu/types/extended_commit.py`."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..encoding import proto as pb
from .basic import BlockID, Timestamp
from .block import BlockIDFlag, Commit, CommitSig


@dataclass
class ExtendedCommitSig:
    block_id_flag: int = BlockIDFlag.ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp)
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def encode(self) -> bytes:
        return (
            pb.f_varint(1, self.block_id_flag)
            + pb.f_bytes(2, self.validator_address)
            + pb.f_embedded(3, self.timestamp.encode())
            + pb.f_bytes(4, self.signature)
            + pb.f_bytes(5, self.extension)
            + pb.f_bytes(6, self.extension_signature)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "ExtendedCommitSig":
        d = pb.fields_to_dict(buf)
        return cls(
            block_id_flag=pb.to_i64(d.get(1, 0)),
            validator_address=pb.as_bytes(d.get(2, b"")),
            timestamp=Timestamp.decode(pb.as_bytes(d.get(3, b""))),
            signature=pb.as_bytes(d.get(4, b"")),
            extension=pb.as_bytes(d.get(5, b"")),
            extension_signature=pb.as_bytes(d.get(6, b"")),
        )

    def to_commit_sig(self) -> CommitSig:
        return CommitSig(
            block_id_flag=self.block_id_flag,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )


@dataclass
class ExtendedCommit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    extended_signatures: list[ExtendedCommitSig] = field(default_factory=list)

    def encode(self) -> bytes:
        out = (
            pb.f_varint(1, self.height)
            + pb.f_varint(2, self.round)
            + pb.f_embedded(3, self.block_id.encode())
        )
        for s in self.extended_signatures:
            out += pb.f_embedded(4, s.encode())
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "ExtendedCommit":
        d = pb.fields_to_dict(buf)
        sigs = []
        for f, _, v in pb.parse_fields(buf):
            if f == 4:
                sigs.append(ExtendedCommitSig.decode(pb.as_bytes(v)))
        return cls(
            height=pb.to_i64(d.get(1, 0)),
            round=pb.to_i64(d.get(2, 0)),
            block_id=BlockID.decode(pb.as_bytes(d.get(3, b""))),
            extended_signatures=sigs,
        )

    def to_commit(self) -> Commit:
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id,
            signatures=[s.to_commit_sig() for s in self.extended_signatures],
        )
