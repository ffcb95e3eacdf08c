"""Batched scalar handling mod L (the ed25519 group order) on device.

Twin of `cometbft_tpu/ops/scalar.py`, on the same 12-bit limbs:

- `reduce512`: SHA-512 digests (512-bit little-endian) -> canonical
  scalars < L. On a CUDA tensor one `reduce512` kernel launch
  (`csrc/sha512_kernels.cu`); on a CPU tensor `reduce512_plain`, the
  reference's Barrett reduction (HAC Alg 14.42) in base-2^12 limbs. The
  output is canonical, so the two agree bit for bit.
- `sha512_reduce`: padded R||A||M words -> k = SHA-512 mod L, the
  challenge of the device-SHA and delta routes. On a CUDA tensor one
  `sha512_reduce` kernel launch, the digest kept in registers; on a CPU
  tensor `sha512_reduce_plain`, `reduce512_plain` of
  `sha512.sha512_digest_plain`.
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
from . import kernels as K
from . import sha512 as H

BITS = F.BITS
MASK = F.MASK

L_INT = 2**252 + 27742317777372353535851937790883648493
HALF_INT = int("8" * 64, 16)  # 0x888...8: adds 8 to each of 64 nibbles

_K = 22  # L occupies 22 base-2^12 limbs (bit 252 lives in limb 21)
_MU_INT = (1 << (BITS * 2 * _K)) // L_INT  # floor(b^44 / L), 23 limbs


def _to_limbs(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (BITS * i)) & MASK for i in range(n)], np.int32)


L_LIMBS = _to_limbs(L_INT, _K)[:, None]  # (22, 1), host copy
_MU_LIMBS = _to_limbs(_MU_INT, 23)[:, None]  # (23, 1), host copy


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


def _conv(a, b):
    """Plain (no modular fold) limb convolution: (n, B) x (m, B or 1) ->
    (n + m - 1, B), one shifted row of products per limb of a."""
    n, m = a.shape[0], b.shape[0]
    t = torch.zeros((n + m - 1, a.shape[1]), dtype=torch.int32, device=a.device)
    for i in range(n):
        t[i : i + m] += a[i][None, :] * b
    return t


def reduce512_plain(digest_bytes):
    """Plain PyTorch version of the `reduce512` kernel: (B, 64) uint8
    little-endian 512-bit values -> (22, B) int32 canonical limbs < L, by
    the reference's Barrett reduction in 12-bit limbs."""
    x = bytes_to_limbs(digest_bytes, 43)  # already canonical
    dev = x.device
    q1 = x[_K - 1 :]  # floor(x / b^21): 22 limbs
    q2 = _conv(q1, _limbs_const(_MU_INT, 23, dev))
    # q1*mu < b^45: one extra row absorbs the convolution's carries
    q2 = torch.cat([q2, torch.zeros_like(q2[:1])])
    q2, _ = _canon(q2)
    q3 = q2[_K + 1 :]  # floor(q2 / b^23)
    r2, _ = _canon(_conv(q3, _limbs_const(L_INT, _K, dev))[: _K + 1])
    r, _ = _sub_borrow(x[: _K + 1], r2)  # r >= 0 mathematically; borrow ignored
    lpad = torch.cat([_limbs_const(L_INT, _K, dev), torch.zeros((1, 1), dtype=torch.int32,
                                                                device=dev)]).expand_as(r)
    for _ in range(2):  # Barrett leaves r < 3L
        d, borrow = _sub_borrow(r, lpad)
        r = torch.where(borrow == 0, d, r)
    return r[:_K]


def reduce512(digest_bytes):
    """(B, 64) uint8 little-endian 512-bit values -> (22, B) int32
    canonical limbs < L: one kernel launch on a CUDA tensor,
    `reduce512_plain` on a CPU tensor."""
    if F.on_gpu(digest_bytes):
        return K.reduce512(digest_bytes.contiguous())
    return reduce512_plain(digest_bytes)


def sha512_reduce_plain(words, two_blocks=None):
    """Plain PyTorch version of the `sha512_reduce` kernel: (B, 64) padded
    words -> (22, B) int32 canonical limbs of SHA-512 mod L."""
    return reduce512_plain(H.sha512_digest_plain(words, two_blocks))


def sha512_reduce(words, two_blocks=None):
    """(B, 64) padded words (int64 < 2^32 or int32 bit patterns) and (B,)
    two-block flags -> (22, B) int32 canonical limbs of each lane's
    SHA-512 mod L: one kernel launch on a CUDA tensor,
    `sha512_reduce_plain` on a CPU tensor."""
    if F.on_gpu(words):
        tb = H.two_blocks_mask(two_blocks, words.shape[0], words.device)
        return K.sha512_reduce(words.to(torch.int32).contiguous(), tb.contiguous())
    return sha512_reduce_plain(words, two_blocks)


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
