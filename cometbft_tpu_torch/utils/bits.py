"""Thread-safe fixed-size bit array.

Behavior parity: reference internal/bits/bit_array.go (BitArray, :445 LoC) —
vote presence tracking in VoteSet, block-part tracking in PartSet, and the
VoteSetBits gossip messages. Python representation is a single int used as a
bitmask (arbitrary precision, so no word bookkeeping), guarded by a lock the
way the reference guards with sync.Mutex.

The port's own copy of `cometbft_tpu/utils/bits.py`, unchanged.
"""

from __future__ import annotations

import random
import threading


class BitArray:
    __slots__ = ("_n", "_bits", "_lock")

    def __init__(self, n: int, bits: int = 0):
        if n < 0:
            raise ValueError("BitArray size must be >= 0")
        self._n = n
        self._bits = bits & ((1 << n) - 1)
        self._lock = threading.Lock()

    # -- core ops ---------------------------------------------------------
    def size(self) -> int:
        return self._n

    def get(self, i: int) -> bool:
        if not 0 <= i < self._n:
            return False
        with self._lock:
            return bool((self._bits >> i) & 1)

    def set(self, i: int, v: bool = True) -> bool:
        """Set bit i; returns False when out of range (reference SetIndex)."""
        if not 0 <= i < self._n:
            return False
        with self._lock:
            if v:
                self._bits |= 1 << i
            else:
                self._bits &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        with self._lock:
            return BitArray(self._n, self._bits)

    def _raw(self) -> int:
        with self._lock:
            return self._bits

    # -- set algebra (sizes may differ; reference semantics) --------------
    def or_(self, other: "BitArray") -> "BitArray":
        """Union, sized to the larger operand (reference Or)."""
        n = max(self._n, other._n)
        return BitArray(n, self._raw() | other._raw())

    def and_(self, other: "BitArray") -> "BitArray":
        """Intersection, sized to the smaller operand (reference And)."""
        n = min(self._n, other._n)
        return BitArray(n, self._raw() & other._raw())

    def not_(self) -> "BitArray":
        return BitArray(self._n, ~self._raw())

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set here but not in other; keeps this size (reference Sub)."""
        return BitArray(self._n, self._raw() & ~other._raw())

    # -- queries ----------------------------------------------------------
    def is_empty(self) -> bool:
        return self._raw() == 0

    def is_full(self) -> bool:
        return self._raw() == (1 << self._n) - 1 if self._n else True

    def num_true(self) -> int:
        return bin(self._raw()).count("1")

    def true_indices(self) -> list[int]:
        bits = self._raw()
        return [i for i in range(self._n) if (bits >> i) & 1]

    def pick_random(self, rng: random.Random | None = None) -> tuple[int, bool]:
        """A uniformly random set bit (reference PickRandom); (0, False) if none."""
        idx = self.true_indices()
        if not idx:
            return 0, False
        return (rng or random).choice(idx), True

    # -- encoding / display -----------------------------------------------
    def to_bytes(self) -> bytes:
        return self._raw().to_bytes((self._n + 7) // 8 or 1, "little")

    @classmethod
    def from_bytes(cls, n: int, data: bytes) -> "BitArray":
        return cls(n, int.from_bytes(data, "little"))

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self._n == other._n and self._raw() == other._raw()

    def __repr__(self) -> str:
        bits = self._raw()
        s = "".join("x" if (bits >> i) & 1 else "_" for i in range(self._n))
        return f"BA{{{self._n}:{s}}}"
