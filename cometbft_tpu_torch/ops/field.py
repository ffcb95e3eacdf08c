"""GF(2^255 - 19) arithmetic in PyTorch, vectorized over a trailing batch axis.

Twin of `cometbft_tpu/ops/field.py`, with the same representation:
little-endian base-2^12 limbs in int32, shape (22, B). p = 2^255 - 19;
22 * 12 = 264 bits, so 2^264 ≡ 512 * 19 = 9728 (mod p), the carry-fold
constant FOLD.

Loose invariant (what every op returns and accepts):
    limb 0   in [0, 13824)   (absorbs carry folds; < 2^13.76)
    limbs 1+ in [0, 4300)    (~canonical 2^12 plus ripple slack)
Schoolbook products then sum to at most
    2 * 13823 * 4299 + 20 * 4299^2 < 2^28.9  « int32,
so multiplication never overflows.

Carries are parallel rounds, as in the reference: one round masks every
limb and shifts all carries up one position (the top carry folds into
limb 0 via FOLD). The plain versions below compute bit-for-bit the loose
limbs the reference computes.

`mul` and `sq` dispatch on the tensor's device: a CUDA tensor launches
the hand-written kernel (`csrc/field_kernels.cu`, through `ops/kernels.py`),
a CPU tensor runs the plain version (`mul_plain`, `sq_plain`). Nothing
falls back from one to the other. The kernels return canonical limbs,
which satisfy the loose invariant; every op below accepts either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels as K

NLIMBS = 22
BITS = 12
MASK = (1 << BITS) - 1
FOLD = 9728  # 2^264 mod p
P_INT = 2**255 - 19

P_LIMBS = np.array(
    [(P_INT >> (BITS * i)) & MASK for i in range(NLIMBS)], dtype=np.int32
)
assert sum(int(l) << (BITS * i) for i, l in enumerate(P_LIMBS)) == P_INT

_WIDE = 2 * NLIMBS + 1  # 45 rows; row 44 stays zero (max degree 42)


def from_int(x: int, batch: int | None = None) -> np.ndarray:
    """Host-side: python int -> limb array (NLIMBS,) or broadcast (NLIMBS, B)."""
    x %= P_INT
    limbs = np.array([(x >> (BITS * i)) & MASK for i in range(NLIMBS)], dtype=np.int32)
    if batch is None:
        return limbs
    return np.broadcast_to(limbs[:, None], (NLIMBS, batch)).copy()


def to_int(limbs) -> int:
    """Host-side: limb vector (NLIMBS,) -> python int (no reduction)."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (BITS * i) for i, v in enumerate(arr))


def on_gpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; other devices raise."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def device_key(device) -> torch.device:
    """`device` as the port's caches key it: a CUDA device always carries its
    index ("cuda" is the current device), so that "cuda" and "cuda:0" are one
    card and not two cache entries."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def const(x: int, device) -> torch.Tensor:
    """Constant field element shaped (NLIMBS, 1) on `device` (cached; never
    mutate the returned tensor)."""
    return _const(x, device_key(device))


@functools.lru_cache(maxsize=None)
def _const(x: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(from_int(x)[:, None].copy()).to(device)


@functools.lru_cache(maxsize=None)
def _sub_bias(device: torch.device) -> torch.Tensor:
    # 2048*p limbwise: (a - b + bias) is positive limbwise (min limb
    # 2048*7 = 14336 > 13823 = max loose limb) AND value-wise (max loose
    # value < 2^265.01 < 2048*p ~= 2^266), so sub/neg never go value-
    # negative and limbs stay < 2048*4095 + 13824 < 2^23.1, inside carry().
    bias = (2048 * P_LIMBS.astype(np.int64)).astype(np.int32)[:, None]
    return torch.from_numpy(bias.copy()).to(device)


@functools.lru_cache(maxsize=None)
def _p_const(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(P_LIMBS[:, None].copy()).to(device)


@functools.lru_cache(maxsize=None)
def _conv_index(device: torch.device) -> torch.Tensor:
    """Row i*22 + j of the outer product lands in wide row i + j."""
    idx = np.add.outer(np.arange(NLIMBS), np.arange(NLIMBS)).reshape(-1)
    return torch.from_numpy(idx).to(device)


def _round(x, fold: bool):
    """One parallel carry round: mask all limbs, shift carries up one slot.

    Arithmetic shifts give floor semantics, so this is right for negative
    limbs too (value preserved mod p). With fold=True the top carry
    re-enters limb 0 scaled by FOLD; with fold=False it must be zero.
    """
    hi = x >> BITS
    low = FOLD * hi[-1:] if fold else torch.zeros_like(hi[:1])
    return (x & MASK) + torch.cat([low, hi[:-1]])


def carry(x):
    """Restore the loose invariant for |limbs| < 2^29 (3 folded rounds;
    bound walk in the reference, field.py:85-98)."""
    return _round(_round(_round(x, True), True), True)


def add(a, b):
    """Loose + loose: limbs <= 27646; 2 rounds suffice (carries <= 6)."""
    return _round(_round(a + b, True), True)


def sub(a, b):
    return carry(a - b + _sub_bias(a.device))


def neg(a):
    return carry(_sub_bias(a.device) - a)


def _conv_rows_shifted(a, b):
    """(22, B) x (22, B) -> (45, B) wide product t[k] = sum_{i+j=k} a_i b_j.

    One outer product and one index_add (integer sums are exact in any
    order, so this equals the reference's 22 shifted-row accumulations)."""
    batch = a.shape[1]
    prod = (a[:, None, :] * b[None, :, :]).reshape(NLIMBS * NLIMBS, batch)
    t = torch.zeros((_WIDE, batch), dtype=torch.int32, device=a.device)
    return t.index_add_(0, _conv_index(a.device), prod)


def _fold_wide(t):
    """(45, B) wide product -> loose (22, B), in 4 carry-shift rounds.

    The reference's bound walk (field.py:136-151): round 1 unfolded; the
    collapse lo = t[:22] + FOLD*t[22:44] < 1.32e9; round 2 over 23 rows;
    the top row split-folded into limbs 0 and 1; two folded rounds.
    """
    batch = t.shape[1]
    t = _round(t, False)
    lo = t[:NLIMBS] + FOLD * t[NLIMBS : 2 * NLIMBS]
    lo = torch.cat([lo, torch.zeros((1, batch), dtype=torch.int32, device=t.device)])
    lo = _round(lo, False)
    top = lo[NLIMBS : NLIMBS + 1]
    x = torch.cat(
        [
            lo[0:1] + FOLD * (top & MASK),
            lo[1:2] + FOLD * (top >> BITS),
            lo[2:NLIMBS],
        ]
    )
    return _round(_round(x, True), True)


def _bcast(a, b):
    if a.shape[-1] != b.shape[-1]:
        a, b = torch.broadcast_tensors(a, b)
    return a, b


def mul_plain(a, b):
    """Plain PyTorch version of the mul kernel (reference `_mul_kernel`)."""
    a, b = _bcast(a, b)
    return _fold_wide(_conv_rows_shifted(a, b))


def sq_plain(a):
    """Plain PyTorch version of the sq kernel (reference `_sq_kernel`)."""
    return _fold_wide(_conv_rows_shifted(a, a))


def mul(a, b):
    """Field product of loose inputs, loose output. CUDA tensors launch the
    `fe_mul` kernel (canonical output); CPU tensors run `mul_plain`."""
    a, b = _bcast(a, b)
    if on_gpu(a):
        return K.fe_mul(a.contiguous(), b.contiguous())
    return mul_plain(a, b)


def sq(a):
    """Field square; CUDA tensors launch the `fe_sq` kernel."""
    if on_gpu(a):
        return K.fe_sq(a.contiguous())
    return sq_plain(a)


def mul_small(a, c: int):
    """Multiply by a small constant 0 <= c < 2^13. |a*c| < 2^26.8 -> carry-able."""
    if not 0 <= c < (1 << 13):
        raise ValueError("mul_small takes 0 <= c < 2^13")
    return carry(a * c)


def _seq_pass(x):
    """Sequential carry pass without fold; returns (limbs, carry_out (1,B))."""
    out = []
    c = torch.zeros_like(x[0:1])
    for j in range(NLIMBS):
        t = x[j : j + 1] + c
        out.append(t & MASK)
        c = t >> BITS
    return torch.cat(out), c


def _add_row0(a, delta):
    return torch.cat([a[0:1] + delta, a[1:]])


def freeze(a):
    """Canonical representative: limbs < 2^12, value in [0, p)."""
    a = carry(a)
    a, c = _seq_pass(a)
    a = _add_row0(a, FOLD * c)
    a, c = _seq_pass(a)
    a = _add_row0(a, FOLD * c)
    a, _ = _seq_pass(a)
    # Fold bits >= 255 out of the top limb (bits 252..263 live there).
    top = a[NLIMBS - 1 : NLIMBS] >> 3
    a = torch.cat([a[: NLIMBS - 1], a[NLIMBS - 1 : NLIMBS] & 7])
    a = _add_row0(a, 19 * top)
    a, _ = _seq_pass(a)  # value now < 2^255 + eps < 2p
    d, c = _seq_pass(a - _p_const(a.device))
    return torch.where(c == 0, d, a)  # borrow-free => a >= p


def eq(a, b):
    """Field equality (canonical compare). Returns bool (B,)."""
    return torch.all(freeze(a) == freeze(b), dim=0)


def is_zero(a):
    return torch.all(freeze(a) == 0, dim=0)


def parity(a):
    """Least significant bit of the canonical representative. (B,) int32."""
    return freeze(a)[0] & 1


def select(cond, a, b):
    """cond: bool (B,); a, b: (NLIMBS, B)."""
    return torch.where(cond[None, :], a, b)


def sqn(x, n: int, sq=sq):
    for _ in range(n):
        x = sq(x)
    return x


def pow2523(x, mul=mul, sq=sq):
    """x^((p-5)/8) = x^(2^252 - 3): the reference's addition chain
    (11 muls + 251 squarings; the reference's docstring says 252)."""
    x2 = sq(x)  # x^2
    x9 = mul(sq(sq(x2)), x)  # x^9
    x11 = mul(x9, x2)  # x^11
    x31 = mul(sq(x11), x9)  # x^(2^5 - 1)
    x_10 = mul(sqn(x31, 5, sq), x31)  # 2^10 - 1
    x_20 = mul(sqn(x_10, 10, sq), x_10)  # 2^20 - 1
    x_40 = mul(sqn(x_20, 20, sq), x_20)  # 2^40 - 1
    x_50 = mul(sqn(x_40, 10, sq), x_10)  # 2^50 - 1
    x_100 = mul(sqn(x_50, 50, sq), x_50)  # 2^100 - 1
    x_200 = mul(sqn(x_100, 100, sq), x_100)  # 2^200 - 1
    x_250 = mul(sqn(x_200, 50, sq), x_50)  # 2^250 - 1
    return mul(sq(sq(x_250)), x)  # x^(2^252 - 3)


def invert(x, mul=mul, sq=sq):
    """x^(p-2): p-2 = 8*(2^252 - 3) + 3."""
    t = sqn(pow2523(x, mul, sq), 3, sq)
    return mul(t, mul(sq(x), x))


def _byte_gather(b, nlimbs: int):
    """(B, nbytes) int32 -> (nlimbs, B) 12-bit limbs of the little-endian
    value (limbs past the last byte are zero)."""
    batch, nbytes = b.shape
    padded = torch.cat([b, torch.zeros((batch, 1), dtype=torch.int32, device=b.device)], dim=1)
    nfull = min(nlimbs, (8 * nbytes + BITS - 1) // BITS)
    bit = np.arange(nfull) * BITS
    lo_idx = torch.from_numpy(bit // 8).to(b.device)
    shift = torch.from_numpy((bit % 8).astype(np.int32)).to(b.device)
    lo = padded[:, lo_idx] >> shift
    hi = padded[:, lo_idx + 1] << (8 - shift)
    limbs = ((lo | hi) & MASK).T
    if nfull < nlimbs:
        limbs = torch.cat(
            [limbs, torch.zeros((nlimbs - nfull, batch), dtype=torch.int32, device=b.device)]
        )
    return limbs.contiguous()


def from_bytes_le(b):
    """(B, 32) uint8 little-endian -> (22, B) loose limbs (value < 2^256).

    Callers that need only 255 bits (point decoding) mask the sign bit first.
    """
    return _byte_gather(b.to(torch.int32), NLIMBS)


def to_bytes_le(a):
    """(22, B) -> (B, 32) uint8 of the canonical representative."""
    a = freeze(a)  # limbs < 2^12, value < p < 2^255
    bit = np.arange(32) * 8
    j = bit // BITS
    shift = bit % BITS
    jn = np.minimum(j + 1, NLIMBS - 1)
    # the next limb contributes only where the byte straddles two limbs
    straddle = (shift > BITS - 8) & (j + 1 < NLIMBS)
    dev = a.device
    v = a[torch.from_numpy(j).to(dev)] >> torch.from_numpy(shift.astype(np.int32)).to(dev)[:, None]
    nxt = a[torch.from_numpy(jn).to(dev)] << torch.from_numpy(
        np.where(straddle, BITS - shift, 0).astype(np.int32)
    ).to(dev)[:, None]
    v = torch.where(torch.from_numpy(straddle).to(dev)[:, None], v | nxt, v)
    return (v & 0xFF).T.contiguous().to(torch.uint8)
