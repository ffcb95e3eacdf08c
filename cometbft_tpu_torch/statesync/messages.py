"""Twin of `cometbft_tpu/statesync/messages.py`. State-sync wire messages (reference proto/cometbft/statesync/v1).

Message oneof: snapshots_request=1, snapshots_response=2,
chunk_request=3, chunk_response=4, light_block_request=5,
light_block_response=6 — field numbers match the reference proto for
wire parity. The light-block channel lets a syncing node fetch the
trust-anchor chain from its peers (reference
internal/statesync/reactor.go LightBlockChannel 0x62).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..encoding import proto as pb

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
LIGHT_BLOCK_CHANNEL = 0x62


@dataclass
class SnapshotsRequest:
    def encode(self) -> bytes:
        return pb.f_embedded(1, b"")


@dataclass
class SnapshotsResponse:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""

    def encode(self) -> bytes:
        body = (
            pb.f_varint(1, self.height)
            + pb.f_varint(2, self.format)
            + pb.f_varint(3, self.chunks)
            + pb.f_bytes(4, self.hash)
            + pb.f_bytes(5, self.metadata)
        )
        return pb.f_embedded(2, body)

    @classmethod
    def from_fields(cls, d: dict) -> "SnapshotsResponse":
        return cls(
            height=pb.to_i64(d.get(1, 0)),
            format=pb.to_i64(d.get(2, 0)),
            chunks=pb.to_i64(d.get(3, 0)),
            hash=pb.as_bytes(d.get(4, b"")),
            metadata=pb.as_bytes(d.get(5, b"")),
        )


@dataclass
class ChunkRequest:
    height: int = 0
    format: int = 0
    index: int = 0

    def encode(self) -> bytes:
        body = (
            pb.f_varint(1, self.height)
            + pb.f_varint(2, self.format)
            + pb.f_varint(3, self.index)
        )
        return pb.f_embedded(3, body)

    @classmethod
    def from_fields(cls, d: dict) -> "ChunkRequest":
        return cls(
            height=pb.to_i64(d.get(1, 0)),
            format=pb.to_i64(d.get(2, 0)),
            index=pb.to_i64(d.get(3, 0)),
        )


@dataclass
class ChunkResponse:
    height: int = 0
    format: int = 0
    index: int = 0
    chunk: bytes = b""
    missing: bool = False

    def encode(self) -> bytes:
        body = (
            pb.f_varint(1, self.height)
            + pb.f_varint(2, self.format)
            + pb.f_varint(3, self.index)
            + pb.f_bytes(4, self.chunk)
        )
        if self.missing:
            body += pb.f_varint(5, 1)
        return pb.f_embedded(4, body)

    @classmethod
    def from_fields(cls, d: dict) -> "ChunkResponse":
        return cls(
            height=pb.to_i64(d.get(1, 0)),
            format=pb.to_i64(d.get(2, 0)),
            index=pb.to_i64(d.get(3, 0)),
            chunk=pb.as_bytes(d.get(4, b"")),
            missing=bool(pb.to_i64(d.get(5, 0))),
        )


@dataclass
class LightBlockRequest:
    height: int = 0

    def encode(self) -> bytes:
        return pb.f_embedded(5, pb.f_varint(1, self.height))

    @classmethod
    def from_fields(cls, d: dict) -> "LightBlockRequest":
        return cls(height=pb.to_i64(d.get(1, 0)))


@dataclass
class LightBlockResponse:
    """signed_header + validator_set, both in their canonical proto
    encodings; empty signed_header means the peer has no such block."""

    height: int = 0
    signed_header: bytes = b""
    validator_set: bytes = b""

    def encode(self) -> bytes:
        body = (
            pb.f_varint(1, self.height)
            + pb.f_bytes(2, self.signed_header)
            + pb.f_bytes(3, self.validator_set)
        )
        return pb.f_embedded(6, body)

    @classmethod
    def from_fields(cls, d: dict) -> "LightBlockResponse":
        return cls(
            height=pb.to_i64(d.get(1, 0)),
            signed_header=pb.as_bytes(d.get(2, b"")),
            validator_set=pb.as_bytes(d.get(3, b"")),
        )


def decode_message(buf: bytes):
    """One statesync Message -> typed dataclass (None if unknown)."""
    d = pb.fields_to_dict(buf)
    if 1 in d:
        return SnapshotsRequest()
    if 2 in d:
        return SnapshotsResponse.from_fields(pb.fields_to_dict(pb.as_bytes(d[2])))
    if 3 in d:
        return ChunkRequest.from_fields(pb.fields_to_dict(pb.as_bytes(d[3])))
    if 4 in d:
        return ChunkResponse.from_fields(pb.fields_to_dict(pb.as_bytes(d[4])))
    if 5 in d:
        return LightBlockRequest.from_fields(pb.fields_to_dict(pb.as_bytes(d[5])))
    if 6 in d:
        return LightBlockResponse.from_fields(pb.fields_to_dict(pb.as_bytes(d[6])))
    return None
