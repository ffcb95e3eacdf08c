"""Trusted light-block store (reference light/store/db/db.go) and the
MMR's KV persistence (twin of `cometbft_tpu/light/store.py`: the same
keys and values, on the port's `storage/kv.py`)."""

from __future__ import annotations

import threading

from ..encoding import proto as pb
from ..storage.kv import KVStore, MemKV
from ..types import Validator, ValidatorSet
from ..types.validator_set import decode_pub_key, encode_pub_key
from .types import LightBlock, SignedHeader


def _key(h: int) -> bytes:
    return b"LB2:" + h.to_bytes(8, "big")  # v2: proto-encoded pubkeys


def _encode_vals(vals: ValidatorSet) -> bytes:
    out = b""
    for v in vals.validators:
        out += pb.f_embedded(
            1,
            pb.f_embedded(1, encode_pub_key(v.pub_key))
            + pb.f_varint(2, v.voting_power)
            + pb.f_varint(3, v.proposer_priority + (1 << 62)),  # offset-encode
        )
    return out


def _decode_vals(buf: bytes) -> ValidatorSet:
    vals = []
    for f, _, v in pb.parse_fields(buf):
        if f != 1:
            continue
        d = pb.fields_to_dict(pb.as_bytes(v))
        val = Validator.from_pub_key(
            decode_pub_key(pb.fields_to_dict(pb.as_bytes(d.get(1, b"")))),
            pb.to_i64(d.get(2, 0)),
        )
        val.proposer_priority = pb.to_i64(d.get(3, 0)) - (1 << 62)
        vals.append(val)
    return ValidatorSet(vals, increment_first=False)


class LightStore:
    """Height-keyed store of verified LightBlocks with pruning."""

    def __init__(self, db: KVStore | None = None):
        self._db = db or MemKV()
        self._lock = threading.Lock()
        self._heights: list[int] = []

    def save(self, lb: LightBlock) -> None:
        payload = pb.f_embedded(1, lb.signed_header.encode()) + pb.f_embedded(
            2, _encode_vals(lb.validators)
        )
        with self._lock:
            self._db.set(_key(lb.height), payload)
            if lb.height not in self._heights:
                import bisect

                bisect.insort(self._heights, lb.height)

    def load(self, height: int) -> LightBlock | None:
        raw = self._db.get(_key(height))
        if not raw:
            return None
        d = pb.fields_to_dict(raw)
        return LightBlock(
            SignedHeader.decode(pb.as_bytes(d.get(1, b""))),
            _decode_vals(pb.as_bytes(d.get(2, b""))),
        )

    def latest(self) -> LightBlock | None:
        with self._lock:
            if not self._heights:
                return None
            h = self._heights[-1]
        return self.load(h)

    def lowest(self) -> LightBlock | None:
        with self._lock:
            if not self._heights:
                return None
            h = self._heights[0]
        return self.load(h)

    def heights(self) -> list[int]:
        with self._lock:
            return list(self._heights)

    def prune(self, keep: int) -> int:
        """Keep the newest `keep` blocks (reference PruningSize)."""
        with self._lock:
            drop = self._heights[:-keep] if keep else list(self._heights)
            self._heights = self._heights[-keep:] if keep else []
            for h in drop:
                self._db.delete(_key(h))
            return len(drop)


def _mmr_node_key(pos: int) -> bytes:
    return b"MMRN:" + pos.to_bytes(8, "big")


_MMR_SIZE_KEY = b"MMRS:"  # leaf_count_be8 || node_count_be8
_MMR_BASE_KEY = b"MMRB:"  # base chain height of leaf 0, be8


class MMRStore:
    """KV persistence for the light-serve MMR accumulator.

    Write-through from `MMR.append` (only the nodes the append created
    are written), rebuilt into memory via `MMR.load`. The size record is
    written after the node records, so a crash between them leaves a
    consistent prefix — every MMR node-array prefix is itself a valid
    MMR.
    """

    def __init__(self, db: KVStore | None = None):
        self._db = db or MemKV()
        self._lock = threading.Lock()

    def append_nodes(self, first_pos: int, nodes: list[bytes],
                     leaf_count: int) -> None:
        with self._lock:
            for i, node in enumerate(nodes):
                self._db.set(_mmr_node_key(first_pos + i), node)
            self._db.set(
                _MMR_SIZE_KEY,
                leaf_count.to_bytes(8, "big")
                + (first_pos + len(nodes)).to_bytes(8, "big"),
            )

    def load_nodes(self) -> tuple[int, list[bytes]]:
        with self._lock:
            raw = self._db.get(_MMR_SIZE_KEY)
            if not raw:
                return 0, []
            leaf_count = int.from_bytes(raw[:8], "big")
            node_count = int.from_bytes(raw[8:16], "big")
            nodes = []
            for pos in range(node_count):
                node = self._db.get(_mmr_node_key(pos))
                if node is None:
                    raise ValueError(f"mmr store missing node {pos}")
                nodes.append(node)
            return leaf_count, nodes

    def node_count(self) -> int:
        with self._lock:
            raw = self._db.get(_MMR_SIZE_KEY)
        return int.from_bytes(raw[8:16], "big") if raw else 0

    def save_base_height(self, height: int) -> None:
        with self._lock:
            self._db.set(_MMR_BASE_KEY, height.to_bytes(8, "big"))

    def load_base_height(self) -> int | None:
        with self._lock:
            raw = self._db.get(_MMR_BASE_KEY)
        return int.from_bytes(raw, "big") if raw else None
