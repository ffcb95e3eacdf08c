"""RFC-6962-style merkle tree (reference: crypto/merkle/).

- leaf hash  = SHA256(0x00 || leaf)          (reference crypto/merkle/hash.go:21)
- inner hash = SHA256(0x01 || left || right) (reference crypto/merkle/hash.go:34)
- empty tree = SHA256("")
- split point = largest power of two strictly less than n

The port's own copy of `cometbft_tpu/crypto/merkle.py` without its
multi-op proof chains (no consumer in this package uses them). A tree of
_NATIVE_MIN leaves or more is hashed in one C call (`crypto/native.py`,
`csrc/host/merkle_native.inc`); hashlib takes it on a host without the
library.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


_NATIVE_MIN = 8  # below this the ctypes call setup beats the win


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n >= _NATIVE_MIN:
        # one C call for the whole tree (SHA-NI when the host has it):
        # commits re-merkle 100+ signature encodings per block and the
        # per-hash hashlib round trips were a measured replay hot spot
        from . import native

        if native.available():
            return native.merkle_root(items)
    return _hash_pure(items)


def _hash_pure(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _sha256(b"")
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(_hash_pure(items[:k]), _hash_pure(items[k:]))


@dataclass
class Proof:
    """Merkle inclusion proof (reference crypto/merkle/proof.go:52)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0 or self.index >= self.total:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        computed = self.compute_root()
        return computed is not None and computed == root

    def compute_root(self) -> bytes | None:
        return _root_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)


def _root_from_aunts(index: int, total: int, leaf_h: bytes, aunts: list[bytes]) -> bytes | None:
    """Recompute the root from a leaf hash and its aunt hashes
    (reference crypto/merkle/proof.go:203 computeHashFromAunts)."""
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        if aunts:
            return None
        return leaf_h
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _root_from_aunts(index, k, leaf_h, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _root_from_aunts(index - k, total - k, leaf_h, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root + per-item proofs (reference crypto/merkle/proof.go:61)."""
    trails, root_node = _trails_from_byte_slices(items)
    root = root_node.hash
    proofs = []
    for i, trail in enumerate(trails):
        proofs.append(
            Proof(total=len(items), index=i, leaf_hash=trail.hash, aunts=trail.flatten_aunts())
        )
    return root, proofs


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = None
        self.left = None  # sibling trail links
        self.right = None

    def flatten_aunts(self) -> list[bytes]:
        out = []
        node = self
        while node is not None:
            if node.left is not None:
                out.append(node.left.hash)
            elif node.right is not None:
                out.append(node.right.hash)
            node = node.parent
        return out


def _trails_from_byte_slices(items: list[bytes]):
    n = len(items)
    if n == 0:
        return [], _Node(_sha256(b""))
    if n == 1:
        node = _Node(leaf_hash(items[0]))
        return [node], node
    k = _split_point(n)
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root
