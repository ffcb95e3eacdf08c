"""Columnar transaction batch: one contiguous blob + an offsets column
(twin of `cometbft_tpu/mempool/txcolumns.py`).

The proposal path used to re-materialize per-tx byte strings at every
hop — reap copies them out of the mempool, prepare_proposal walks them
again, Data.hash() hashes them one by one, Data.encode() concatenates
them a fourth time. A TxColumns batch keeps the payloads in ONE
contiguous buffer with an offsets column, exposes the same sequence
protocol as list[bytes] (so the app, FinalizeBlock, and mempool.update
consume it unchanged), and memoizes the three expensive projections the
hot path needs: per-tx hashes, the Data proto payload, and the
byte-budget prefix (which shares the blob instead of copying it).

Bit-exactness contract: tx_hashes()/encode_data()/prefix_max_bytes()
must produce exactly what the list[bytes] code paths produce —
types/block.py's Data fast-paths to these methods only because the
results are indistinguishable on the wire (tests/test_torch_mempool.py
holds them against the reference's).
"""

from __future__ import annotations

from bisect import bisect_right

from ..crypto.keys import tmhash
from ..encoding import proto as pb


class TxColumns:
    """Immutable columnar tx batch with list[bytes] semantics.

    tx i is ``blob[offsets[i]:offsets[i+1]]``; ``offsets`` has n+1
    entries with offsets[0] == 0. Per-tx access goes through memoryview
    slices of the shared blob; a materialized list[bytes] is built at
    most once (lazily) for consumers that iterate repeatedly.
    """

    __slots__ = ("blob", "offsets", "_hashes", "_data_enc", "_mat")

    def __init__(self, blob, offsets: list[int]):
        self.blob = blob
        self.offsets = offsets
        self._hashes: list[bytes] | None = None
        self._data_enc: bytes | None = None
        self._mat: list[bytes] | None = None

    @classmethod
    def from_txs(cls, txs) -> "TxColumns":
        """Columnarize any iterable of tx bytes (idempotent)."""
        if isinstance(txs, cls):
            return txs
        txs = list(txs)
        offsets = [0]
        total = 0
        for t in txs:
            total += len(t)
            offsets.append(total)
        return cls(b"".join(txs), offsets)

    # -- sequence protocol (list[bytes] compatibility) -----------------
    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.to_list()[i]
        o = self.offsets
        n = len(o) - 1
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("tx index out of range")
        if self._mat is not None:
            return self._mat[i]
        return bytes(memoryview(self.blob)[o[i]:o[i + 1]])

    def __iter__(self):
        return iter(self.to_list())

    def __eq__(self, other):
        if isinstance(other, TxColumns):
            return self.to_list() == other.to_list()
        if isinstance(other, (list, tuple)):
            return self.to_list() == list(other)
        return NotImplemented

    __hash__ = None  # mutable-sequence semantics, like list[bytes]

    def __repr__(self) -> str:
        return f"TxColumns(n={len(self)}, bytes={self.total_bytes()})"

    # -- zero-copy access ----------------------------------------------
    def view(self, i: int) -> memoryview:
        """Memoryview of tx i over the shared blob (no copy)."""
        o = self.offsets
        return memoryview(self.blob)[o[i]:o[i + 1]]

    def iter_views(self):
        """Iterate memoryview slices without materializing bytes."""
        mv = memoryview(self.blob)
        o = self.offsets
        for i in range(len(o) - 1):
            yield mv[o[i]:o[i + 1]]

    def to_list(self) -> list[bytes]:
        """Materialized list[bytes] — built at most once per batch, so
        repeated full passes (app delivery, mempool.update) pay the
        per-tx copies a single time."""
        if self._mat is None:
            mv = memoryview(self.blob)
            o = self.offsets
            self._mat = [bytes(mv[o[i]:o[i + 1]])
                         for i in range(len(o) - 1)]
        return self._mat

    def total_bytes(self) -> int:
        return self.offsets[-1]

    # -- memoized hot-path projections ---------------------------------
    def tx_hashes(self) -> list[bytes]:
        """Per-tx tmhash column — exactly [tx_hash(t) for t in txs]."""
        if self._hashes is None:
            mv = memoryview(self.blob)
            o = self.offsets
            self._hashes = [tmhash(mv[o[i]:o[i + 1]])
                            for i in range(len(o) - 1)]
        return self._hashes

    def encode_data(self) -> bytes:
        """The Data proto payload — exactly the concatenation of
        pb.f_bytes(1, t, emit_empty=True) over the txs."""
        if self._data_enc is None:
            t1 = pb.tag(1, pb.WT_LEN)
            parts = []
            mv = memoryview(self.blob)
            o = self.offsets
            for i in range(len(o) - 1):
                parts.append(t1 + pb.uvarint(o[i + 1] - o[i]))
                parts.append(mv[o[i]:o[i + 1]])
            self._data_enc = b"".join(parts)
        return self._data_enc

    def prefix_max_bytes(self, max_tx_bytes: int) -> "TxColumns":
        """Longest prefix whose summed payload bytes fit the budget,
        SHARING the blob (the default prepare_proposal contract: walk
        FIFO, stop before the first tx that would overflow)."""
        o = self.offsets
        n = len(o) - 1
        # offsets are the cumulative byte sums, so the cut point is a
        # bisect; duplicates (empty txs) land after the run, matching
        # the reference loop's total-not-greater check
        k = bisect_right(o, max_tx_bytes) - 1
        if k >= n:
            return self
        if k < 0:
            k = 0
        return TxColumns(self.blob, o[:k + 1])
