"""Batched scalar handling mod L (the ed25519 group order) on device.

Twin of the part of `cometbft_tpu/ops/scalar.py` that the prehashed
verify path needs, on the same 12-bit limbs:

- `recode_signed`: scalar -> 64 signed radix-16 digits in [-8, 7] for the
  windowed ladder, via the add-0x888...8 trick (adding 8 to every nibble
  with full carry propagation turns unsigned nibbles into signed digits).
- `lt_l`: the ZIP-215 "reject S >= L" range check as a borrow chain.
- `digits_from_bytes`: 32-byte scalar encodings straight to digits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F

BITS = F.BITS
MASK = F.MASK

L_INT = 2**252 + 27742317777372353535851937790883648493
HALF_INT = int("8" * 64, 16)  # 0x888...8: adds 8 to each of 64 nibbles

_K = 22  # L occupies 22 base-2^12 limbs (bit 252 lives in limb 21)


def _to_limbs(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (BITS * i)) & MASK for i in range(n)], np.int32)


@functools.lru_cache(maxsize=None)
def _limbs_const(x: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_to_limbs(x, n)[:, None].copy()).to(device)


def bytes_to_limbs(b, nlimbs: int):
    """(B, nbytes) uint8 little-endian -> (nlimbs, B) int32 12-bit limbs."""
    return F._byte_gather(b.to(torch.int32), nlimbs)


def _canon(x, extra_rounds: int = 2):
    """Exact canonicalization: limbs in [0, 2^12), value preserved.

    A few parallel rounds shrink carries, then one sequential ripple
    finishes exactly. Input limbs must be >= 0. Returns (limbs, carry out
    of the top limb as (1, B)).
    """
    for _ in range(extra_rounds):
        hi = x >> BITS
        x = (x & MASK) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])
    out = []
    c = torch.zeros_like(x[0:1])
    for j in range(x.shape[0]):
        t = x[j : j + 1] + c
        out.append(t & MASK)
        c = t >> BITS
    return torch.cat(out), c


def _sub_borrow(a, b):
    """a - b limbwise with sequential borrow. Returns (diff, borrow (1,B)):
    diff is a - b mod b^n, borrow is 1 where a < b."""
    out = []
    c = torch.zeros_like(a[0:1])
    for j in range(a.shape[0]):
        t = a[j : j + 1] - b[j : j + 1] - c
        out.append(t & MASK)
        c = (t >> BITS) & 1  # arithmetic shift of negative -> -1; mask to 1
    return torch.cat(out), c


def lt_l(s_bytes):
    """(B, 32) uint8 little-endian -> bool (B,): value < L (ZIP-215 S check)."""
    s = bytes_to_limbs(s_bytes, _K)
    _, borrow = _sub_borrow(s, _limbs_const(L_INT, _K, s.device).expand_as(s))
    return (borrow == 1)[0]


def recode_signed(limbs):
    """Canonical (22, B) scalar < 2^255 -> (64, B) int32 digits in [-8, 7].

    value = sum_i digit_i * 16^i: add 0x888...8 (one ripple suffices for
    sums <= 2*4095) and subtract 8 from every resulting nibble.
    """
    t, _ = _canon(limbs + _limbs_const(HALF_INT, _K, limbs.device), extra_rounds=0)
    nib = np.arange(64) * 4
    dev = limbs.device
    rows = t[torch.from_numpy(nib // BITS).to(dev)]
    shift = torch.from_numpy((nib % BITS).astype(np.int32)).to(dev)[:, None]
    return ((rows >> shift) & 15) - 8


def digits_from_bytes(b32):
    """(B, 32) uint8 scalar encoding -> (64, B) signed digits.

    Values >= 2^256 - HALF would overflow nibble 64; callers reject such
    lanes independently (lt_l), so garbage digits there are harmless.
    """
    return recode_signed(F.from_bytes_le(b32))
