"""Merkle Mountain Range accumulator over committed headers (twin of
`cometbft_tpu/light/mmr.py`: the same roots and proof bytes).

The light-serve surface (light/serve.py) appends each committed
header's hash at commit time; a syncing client then receives ancestry
for any past height with O(log n) proof bytes instead of replaying and
re-verifying every header. Design follows "The Merkle Mountain Belt"
(PAPERS.md) and the classic MMR layout: nodes are stored post-order in
one append-only array, every prefix of which is itself a valid MMR, so
incremental appends and from-scratch rebuilds are bit-exact.

Hashing reuses the repo's RFC-6962 domain separation (crypto/merkle.py):

- leaf node  = SHA256(0x00 || header_hash)
- inner node = SHA256(0x01 || left || right)     (also used for bagging)
- root       = SHA256(0x02 || leaf_count_be8 || bagged_peaks)

The root commits the leaf count, so a proof is bound to one exact
accumulator snapshot — a truncated or extended MMR can't replay it.

Proofs are "peak-walking": the sibling path from the leaf to its
mountain peak, plus the other peaks left and right of that mountain.
For n leaves the path is <= ceil(log2(n)) hashes and there are at most
popcount(n) <= log2(n)+1 peaks, so encoded proofs are <= c*log2(n)
bytes — the gate tests/test_torch_light_client.py pins.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"
ROOT_PREFIX = b"\x02"

_sha = hashlib.sha256


def _leaf(h: bytes) -> bytes:
    return _sha(LEAF_PREFIX + h).digest()


def _inner(left: bytes, right: bytes) -> bytes:
    return _sha(INNER_PREFIX + left + right).digest()


def _bag(peaks: list[bytes], n_leaves: int) -> bytes:
    """Fold peaks right-to-left, then bind the leaf count."""
    if not peaks:
        return _sha(b"").digest()
    acc = peaks[-1]
    for p in reversed(peaks[:-1]):
        acc = _inner(p, acc)
    return _sha(ROOT_PREFIX + n_leaves.to_bytes(8, "big") + acc).digest()


def peak_heights(n_leaves: int) -> list[int]:
    """Mountain heights left to right: the set bits of n, descending.
    A mountain of height h holds 2**h leaves and 2**(h+1)-1 nodes."""
    return [h for h in reversed(range(n_leaves.bit_length()))
            if (n_leaves >> h) & 1]


def peak_positions(n_leaves: int) -> list[int]:
    """Node-array positions of the peaks, left to right."""
    out, pos = [], 0
    for h in peak_heights(n_leaves):
        pos += (1 << (h + 1)) - 1
        out.append(pos - 1)
    return out


@dataclass
class MMRProof:
    """Ancestry proof for one leaf against one accumulator snapshot.

    `path` walks leaf -> mountain peak as (sibling_hash, sibling_is_left)
    pairs; `left_peaks`/`right_peaks` are the other mountains' summits.
    """

    leaf_index: int
    size: int  # leaf count of the snapshot the proof targets
    path: list[tuple[bytes, bool]] = field(default_factory=list)
    left_peaks: list[bytes] = field(default_factory=list)
    right_peaks: list[bytes] = field(default_factory=list)

    # -- structural expectations (cheap reject before any hashing) ------
    def _expected_shape(self) -> tuple[int, int] | None:
        """(path_len, n_other_peaks) for (leaf_index, size), or None when
        the index does not fall inside the accumulator."""
        if not (0 <= self.leaf_index < self.size):
            return None
        heights = peak_heights(self.size)
        first = 0
        for k, h in enumerate(heights):
            span = 1 << h
            if self.leaf_index < first + span:
                return h, len(heights) - 1
            first += span
        return None  # unreachable for a valid (index, size)

    def verify(self, root: bytes, leaf_hash: bytes) -> bool:
        shape = self._expected_shape()
        if shape is None:
            return False
        path_len, n_other = shape
        if len(self.path) != path_len:
            return False
        if len(self.left_peaks) + len(self.right_peaks) != n_other:
            return False
        node = _leaf(leaf_hash)
        for sib, sib_is_left in self.path:
            node = _inner(sib, node) if sib_is_left else _inner(node, sib)
        peaks = [*self.left_peaks, node, *self.right_peaks]
        return _bag(peaks, self.size) == root

    # -- wire form (the byte size the O(log n) gate measures) -----------
    def encode(self) -> bytes:
        flags = 0
        for i, (_, is_left) in enumerate(self.path):
            if is_left:
                flags |= 1 << i
        out = [struct.pack(
            ">QQHBBI", self.leaf_index, self.size, len(self.path),
            len(self.left_peaks), len(self.right_peaks), flags,
        )]
        out += [sib for sib, _ in self.path]
        out += self.left_peaks
        out += self.right_peaks
        return b"".join(out)

    @classmethod
    def decode(cls, buf: bytes) -> "MMRProof":
        idx, size, n_path, n_l, n_r, flags = struct.unpack_from(">QQHBBI", buf)
        off = struct.calcsize(">QQHBBI")
        need = off + 32 * (n_path + n_l + n_r)
        if len(buf) != need:
            raise ValueError(f"mmr proof length {len(buf)} != {need}")

        def take(n):
            nonlocal off
            out = [buf[off + 32 * i: off + 32 * (i + 1)] for i in range(n)]
            off += 32 * n
            return out

        sibs = take(n_path)
        path = [(s, bool(flags >> i & 1)) for i, s in enumerate(sibs)]
        return cls(idx, size, path, take(n_l), take(n_r))

    def num_bytes(self) -> int:
        return len(self.encode())


class MMR:
    """Append-only Merkle Mountain Range with optional write-through
    persistence (light/store.py MMRStore)."""

    def __init__(self, store=None):
        self._nodes: list[bytes] = []
        self._leaves = 0
        self._store = store

    # -- size ------------------------------------------------------------
    @property
    def leaf_count(self) -> int:
        return self._leaves

    @property
    def node_count(self) -> int:
        return len(self._nodes)

    def node(self, pos: int) -> bytes:
        return self._nodes[pos]

    # -- append ----------------------------------------------------------
    def append(self, leaf_hash: bytes) -> int:
        """Append one leaf (a 32-byte header hash); returns its 0-based
        leaf index. Merges right-to-left while equal-height mountains
        meet — the merge count is the number of trailing 1-bits of the
        new leaf's index."""
        i = self._leaves
        first_new = len(self._nodes)
        self._nodes.append(_leaf(leaf_hash))
        pos = len(self._nodes) - 1
        h = 0
        while (i >> h) & 1:
            left_pos = pos - (1 << (h + 1)) + 1
            self._nodes.append(_inner(self._nodes[left_pos],
                                      self._nodes[pos]))
            pos = len(self._nodes) - 1
            h += 1
        self._leaves = i + 1
        if self._store is not None:
            self._store.append_nodes(
                first_new, self._nodes[first_new:], self._leaves
            )
        return i

    @classmethod
    def from_leaves(cls, leaves: list[bytes], store=None) -> "MMR":
        m = cls(store=store)
        for lh in leaves:
            m.append(lh)
        return m

    # -- root ------------------------------------------------------------
    def peaks(self) -> list[bytes]:
        return [self._nodes[p] for p in peak_positions(self._leaves)]

    def root(self) -> bytes:
        return _bag(self.peaks(), self._leaves)

    # -- proofs ----------------------------------------------------------
    def prove(self, leaf_index: int) -> MMRProof:
        """Peak-walking ancestry proof for one leaf of the CURRENT
        snapshot."""
        n = self._leaves
        if not (0 <= leaf_index < n):
            raise IndexError(f"leaf {leaf_index} not in MMR of {n} leaves")
        heights = peak_heights(n)
        positions = peak_positions(n)
        first_leaf, start = 0, 0
        for k, h in enumerate(heights):
            span = 1 << h
            if leaf_index < first_leaf + span:
                mountain_k, mountain_h, mountain_start = k, h, start
                local = leaf_index - first_leaf
                break
            first_leaf += span
            start += (1 << (h + 1)) - 1
        path: list[tuple[bytes, bool]] = []
        self._walk(mountain_start, mountain_h, local, path)
        peaks = [self._nodes[p] for p in positions]
        return MMRProof(
            leaf_index=leaf_index, size=n, path=path,
            left_peaks=peaks[:mountain_k],
            right_peaks=peaks[mountain_k + 1:],
        )

    def _walk(self, start: int, height: int, local: int,
              path: list[tuple[bytes, bool]]) -> None:
        """Collect the sibling path inside one perfect mountain stored
        post-order at [start, start + 2**(height+1)-1). Appends bottom-up
        (recursion unwinds leaf-first)."""
        if height == 0:
            return
        subsize = (1 << height) - 1  # nodes per child subtree
        half = 1 << (height - 1)     # leaves per child subtree
        if local < half:
            self._walk(start, height - 1, local, path)
            path.append((self._nodes[start + 2 * subsize - 1], False))
        else:
            self._walk(start + subsize, height - 1, local - half, path)
            path.append((self._nodes[start + subsize - 1], True))

    # -- persistence -----------------------------------------------------
    @classmethod
    def load(cls, store) -> "MMR":
        """Rebuild from an MMRStore written by write-through appends."""
        m = cls(store=None)  # don't re-write while loading
        m._leaves, m._nodes = store.load_nodes()
        m._store = store
        return m
