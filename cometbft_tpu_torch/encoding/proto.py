"""Minimal protobuf wire-format writer/reader: the port's own copy of
`cometbft_tpu/encoding/proto.py`, unchanged.

Implements exactly the proto3 + gogoproto emission rules the reference's
canonical encodings rely on (reference: types/canonical.go:57-66,
internal/protoio varint-delimited framing):

- varint (base-128, two's-complement 10-byte for negative int64)
- zero-valued scalar fields are omitted
- *non-nullable* embedded messages (gogoproto.nullable=false) are always
  emitted, even when empty; nullable (pointer) ones only when present
- sfixed64 = 8-byte little-endian two's complement, wire type 1
"""

from __future__ import annotations

WT_VARINT = 0
WT_I64 = 1
WT_LEN = 2
WT_I32 = 5

_U64 = 1 << 64
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


# single-byte varints (the overwhelmingly common case: tags, small
# lengths, flags) come from a table instead of the shift loop — varint
# encoding is the hottest host function in replay profiles
_UV1 = [bytes((i,)) for i in range(0x80)]


def uvarint(v: int) -> bytes:
    if v < 0x80:
        if v < 0:
            raise ValueError("uvarint needs v >= 0")
        return _UV1[v]
    if v < 0x4000:
        return bytes(((v & 0x7F) | 0x80, v >> 7))
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint_i64(v: int) -> bytes:
    """int64/int32/enum encoding: two's complement as uint64."""
    if v < 0:
        v += _U64
    return uvarint(v)


def tag(field: int, wt: int) -> bytes:
    return uvarint((field << 3) | wt)


def f_varint(field: int, v: int, *, emit_zero: bool = False) -> bytes:
    if v == 0 and not emit_zero:
        return b""
    return tag(field, WT_VARINT) + varint_i64(v)


def f_sfixed64(field: int, v: int, *, emit_zero: bool = False) -> bytes:
    if v == 0 and not emit_zero:
        return b""
    return tag(field, WT_I64) + (v & (_U64 - 1)).to_bytes(8, "little")


def f_bytes(field: int, v: bytes, *, emit_empty: bool = False) -> bytes:
    if not v and not emit_empty:
        return b""
    return tag(field, WT_LEN) + uvarint(len(v)) + v


def f_string(field: int, v: str, *, emit_empty: bool = False) -> bytes:
    return f_bytes(field, v.encode("utf-8"), emit_empty=emit_empty)


def f_embedded(field: int, payload: bytes) -> bytes:
    """Non-nullable embedded message: ALWAYS emitted."""
    return tag(field, WT_LEN) + uvarint(len(payload)) + payload


def f_embedded_opt(field: int, payload: bytes | None) -> bytes:
    """Nullable embedded message: emitted only when not None."""
    if payload is None:
        return b""
    return f_embedded(field, payload)


def length_prefixed(payload: bytes) -> bytes:
    """Varint-delimited framing (reference internal/protoio MarshalDelimited)."""
    return uvarint(len(payload)) + payload


# ----- reader -----


def read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def to_i64(v: int) -> int:
    return v - _U64 if v > _I64_MAX else v


def parse_fields(buf: bytes) -> list[tuple[int, int, object]]:
    """Flat parse: list of (field_number, wire_type, value).

    value is int for varint/i64/i32, bytes for length-delimited.
    """
    out = []
    pos = 0
    while pos < len(buf):
        key, pos = read_uvarint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            v, pos = read_uvarint(buf, pos)
        elif wt == WT_I64:
            v = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wt == WT_LEN:
            ln, pos = read_uvarint(buf, pos)
            v = buf[pos : pos + ln]
            if len(v) != ln:
                raise ValueError("truncated bytes field")
            pos += ln
        elif wt == WT_I32:
            v = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((field, wt, v))
    return out


def fields_to_dict(buf: bytes) -> dict[int, object]:
    """Last-wins dict of field -> value (repeated fields: use parse_fields)."""
    return {f: v for f, _, v in parse_fields(buf)}


def as_bytes(v) -> bytes:
    """Coerce a parsed field value to bytes, REJECTING type confusion.

    parse_fields returns ints for varint/i64/i32 fields; calling the
    bytes() builtin on an attacker-chosen int allocates that many zero
    bytes (bytes(2**35) = 32 GiB) — a remote memory-exhaustion vector
    every wire decoder would otherwise inherit. Decoders must use this
    for every field they expect to be length-delimited.
    """
    if isinstance(v, int):
        raise ValueError("expected length-delimited field, got scalar")
    return bytes(v)
