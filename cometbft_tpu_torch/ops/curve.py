"""Batched edwards25519 point operations in PyTorch.

Twin of `cometbft_tpu/ops/curve.py`. Points are tuples (X, Y, Z, T) of
(22, B) int32 limb tensors: extended homogeneous coordinates on
-x^2 + y^2 = 1 + d x^2 y^2 with x = X/Z, y = Y/Z, T = XY/Z. The addition
law (add-2008-hwcd-3) is complete for a = -1 and non-square d, so it is
valid for every curve point, including the 8-torsion components that
ZIP-215 liberal decoding admits.

The formulas live once, in `PointOps`, over a pair of field multiply
routes. The module-level functions use the dispatching pair (`F.mul`,
`F.sq`: the field kernels on CUDA tensors, the plain versions on CPU
tensors). `decompress` and `ladder_sub_mul8` launch their own fused
kernels on CUDA tensors (`csrc/curve_kernels.cu`); their plain versions,
`decompress_plain` and `ladder_sub_mul8_plain`, run the same formulas
through the plain field routes on any device.

Each `lax.scan` of the reference is a Python loop here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import ed25519_ref as ref
from . import field as F
from . import kernels as K

P = F.P_INT
_D2_INT = (2 * ref.D) % P


def identity(batch: int, device="cuda"):
    z = torch.zeros((F.NLIMBS, batch), dtype=torch.int32, device=device)
    one = F.const(1, torch.device(device)).expand(F.NLIMBS, batch)
    return (z, one, one, z)


def neg(p):
    X, Y, Z, T = p
    return (F.neg(X), Y, Z, F.neg(T))


def is_identity(p):
    X, Y, Z, _ = p
    return F.is_zero(X) & F.eq(Y, Z)


# --- Constant base table: affine niels of [i]B for i in 0..8 ---
def _host_base_niels() -> np.ndarray:
    out = np.zeros((9, 3, F.NLIMBS), np.int32)
    out[0, 0] = F.from_int(1)  # identity: y+x=1, y-x=1, 2dxy=0
    out[0, 1] = F.from_int(1)
    for i in range(1, 9):
        x, y = ref._ext_to_affine(ref._ext_scalar_mul(i, ref.B_POINT))
        out[i, 0] = F.from_int((y + x) % P)
        out[i, 1] = F.from_int((y - x) % P)
        out[i, 2] = F.from_int((2 * ref.D * x * y) % P)
    return out


BASE_NIELS = torch.from_numpy(_host_base_niels())  # (9, 3, 22), host copy


def base_niels(device) -> torch.Tensor:
    """BASE_NIELS on `device` (cached; never mutate)."""
    return _base_niels(F.device_key(device))


@functools.lru_cache(maxsize=None)
def _base_niels(device: torch.device) -> torch.Tensor:
    return BASE_NIELS.to(device)


def _select_rows(tbl, idx_row):
    """Per-lane table entry by a (1, B) index in 0..8.

    tbl: (9, ncomps, 22, B or 1). Every entry is added under its mask (the
    reference's where-loop, `_select_rows`), so the sum is the selected
    entry exactly. Returns a tuple of ncomps (22, B) tensors."""
    hits = idx_row == torch.arange(9, device=idx_row.device)[:, None]  # (9, B)
    masked = tbl * hits.to(torch.int32)[:, None, None, :]
    return tuple(masked.sum(dim=0, dtype=torch.int32))


def _apply_sign_affine(sign_row, ypx, ymx, t2d):
    return (
        torch.where(sign_row, ymx, ypx),
        torch.where(sign_row, ypx, ymx),
        torch.where(sign_row, F.neg(t2d), t2d),
    )


class PointOps:
    """The reference's point formulas over one pair of field multiply
    routes (`mul`, `sq`); sums, differences and negations are plain
    PyTorch in both."""

    def __init__(self, mul, sq):
        self.mul = mul
        self.sq = sq

    def add(self, p, q):
        """Complete unified addition (add-2008-hwcd-3, a=-1). 9 muls."""
        mul = self.mul
        X1, Y1, Z1, T1 = p
        X2, Y2, Z2, T2 = q
        a = mul(F.sub(Y1, X1), F.sub(Y2, X2))
        b = mul(F.add(Y1, X1), F.add(Y2, X2))
        c = mul(mul(T1, F.const(_D2_INT, T1.device)), T2)
        d = mul(F.add(Z1, Z1), Z2)
        return self._efgh_out(a, b, c, d)

    def _efgh_out(self, a, b, c, d):
        mul = self.mul
        e = F.sub(b, a)
        f = F.sub(d, c)
        g = F.add(d, c)
        h = F.add(b, a)
        return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))

    def to_niels(self, p):
        """Extended -> cached niels form (Y+X, Y-X, 2dT, 2Z). 1 mul."""
        X, Y, Z, T = p
        return (F.add(Y, X), F.sub(Y, X), self.mul(T, F.const(_D2_INT, T.device)), F.add(Z, Z))

    def add_niels(self, p, n):
        """Extended + niels-cached point. 8 muls."""
        mul = self.mul
        X1, Y1, Z1, T1 = p
        ypx2, ymx2, t2d2, z22 = n
        a = mul(F.sub(Y1, X1), ymx2)
        b = mul(F.add(Y1, X1), ypx2)
        return self._efgh_out(a, b, mul(T1, t2d2), mul(Z1, z22))

    def madd(self, p, an):
        """Extended + affine niels (Y+X, Y-X, 2dT with Z2=1). 7 muls."""
        mul = self.mul
        X1, Y1, Z1, T1 = p
        ypx2, ymx2, t2d2 = an
        a = mul(F.sub(Y1, X1), ymx2)
        b = mul(F.add(Y1, X1), ypx2)
        return self._efgh_out(a, b, mul(T1, t2d2), F.add(Z1, Z1))

    def _dbl_efgh(self, p):
        sq = self.sq
        X1, Y1, Z1, _ = p
        a = sq(X1)
        b = sq(Y1)
        zz = sq(Z1)
        c = F.add(zz, zz)
        e = F.sub(F.sub(sq(F.add(X1, Y1)), a), b)
        g = F.sub(b, a)
        f = F.sub(g, c)
        h = F.neg(F.add(a, b))
        return e, f, g, h

    def dbl(self, p):
        """Dedicated doubling (dbl-2008-hwcd, a=-1). 4 sq + 4 mul."""
        mul = self.mul
        e, f, g, h = self._dbl_efgh(p)
        return (mul(e, f), mul(g, h), mul(f, g), mul(e, h))

    def dbl_no_t(self, p):
        """Doubling that skips the T output (4 sq + 3 mul). The result is NOT
        valid as input to additions, only to further doublings / freezes."""
        mul = self.mul
        e, f, g, h = self._dbl_efgh(p)
        return (mul(e, f), mul(g, h), mul(f, g), None)

    def eq_points(self, p, q):
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        mul = self.mul
        X1, Y1, Z1, _ = p
        X2, Y2, Z2, _ = q
        return F.eq(mul(X1, Z2), mul(X2, Z1)) & F.eq(mul(Y1, Z2), mul(Y2, Z1))

    def decompress_value(self, y, sign):
        """ZIP-215 decoding core on limbs: y (22, B) loose, sign (B,) int32.
        Returns (valid bool (B,), x, t = x*y)."""
        mul, sq = self.mul, self.sq
        dev = y.device
        one = F.const(1, dev)
        yy = sq(y)
        u = F.sub(yy, one)
        v = F.add(mul(yy, F.const(ref.D, dev)), one)
        v3 = mul(sq(v), v)
        v7 = mul(sq(v3), v)
        x = mul(mul(u, v3), F.pow2523(mul(u, v7), mul, sq))
        vxx = mul(v, sq(x))
        ok_direct = F.eq(vxx, u)
        ok_flip = F.eq(vxx, F.neg(u))
        x = F.select(ok_flip, mul(x, F.const(ref.SQRT_M1, dev)), x)
        valid = ok_direct | ok_flip
        flip_sign = F.parity(x) != sign
        x = F.select(flip_sign, F.neg(x), x)
        return valid, x, mul(x, y)

    def compress(self, p):
        """(B, 32) uint8 canonical encodings (inverts Z; host/test use only)."""
        X, Y, Z, _ = p
        zi = F.invert(Z, self.mul, self.sq)
        x = F.freeze(self.mul(X, zi))
        enc = F.to_bytes_le(self.mul(Y, zi))
        enc[:, 31] |= ((x[0] & 1) << 7).to(torch.uint8)
        return enc

    def lane_table(self, p):
        """Per-lane niels table of [i]p for i in 0..8, one (9, 4, 22, B)
        tensor: P_{k+1} = P_k + P, seven times."""
        batch = p[0].shape[1]
        dev = p[0].device
        n1 = self.to_niels(p)
        shape = (F.NLIMBS, batch)
        ident = (
            F.const(1, dev).expand(shape),
            F.const(1, dev).expand(shape),
            torch.zeros(shape, dtype=torch.int32, device=dev),
            F.const(2, dev).expand(shape),
        )
        entries = [ident, n1]
        pk = p
        for _ in range(7):
            pk = self.add_niels(pk, n1)
            entries.append(self.to_niels(pk))
        return torch.stack([torch.stack(e) for e in entries])

    def _base_madd(self, r, ws_row):
        """madd of [digit]B from the constant base table (signed select)."""
        tbl = base_niels(ws_row.device)[..., None]  # (9, 3, 22, 1)
        ypx, ymx, t2d = _select_rows(tbl, ws_row.abs())
        return self.madd(r, _apply_sign_affine(ws_row < 0, ypx, ymx, t2d))

    def _window_step(self, r, tbl, ws_row, wk_row):
        """One radix-16 window: 4 doublings + base madd + lane add.
        ws_row / wk_row: (1, B) signed digits; tbl from lane_table."""
        r = self.dbl_no_t(r)
        r = self.dbl_no_t(r)
        r = self.dbl_no_t(r)
        r = self.dbl(r)
        r = self._base_madd(r, ws_row)
        lypx, lymx, lt2d, lz2 = _select_rows(tbl, wk_row.abs())
        ypx, ymx, t2d = _apply_sign_affine(wk_row < 0, lypx, lymx, lt2d)
        return self.add_niels(r, (ypx, ymx, t2d, lz2))

    def ladder(self, s_digits, k_digits, a_point):
        """[s]B + [k]a_point with shared doublings, signed radix-16 digits
        (64, B) in [-8, 7], little-endian; scans from the top digit."""
        batch = s_digits.shape[1]
        tbl = self.lane_table(a_point)
        r = identity(batch, s_digits.device)
        for w in range(63, -1, -1):
            r = self._window_step(r, tbl, s_digits[w : w + 1], k_digits[w : w + 1])
        return r

    def fixed_base(self, s_digits):
        """[s]B from signed digits (64, B) (keygen/test helper)."""
        r = identity(s_digits.shape[1], s_digits.device)
        for w in range(63, -1, -1):
            r = self.dbl_no_t(r)
            r = self.dbl_no_t(r)
            r = self.dbl_no_t(r)
            r = self.dbl(r)
            r = self._base_madd(r, s_digits[w : w + 1])
        return r

    def mul8(self, p):
        r = (p[0], p[1], p[2], None)
        for _ in range(3):
            r = self.dbl_no_t(r)
        return r

    def ladder_sub_mul8_value(self, s_digits, k_digits, a_point, r_point):
        r = self.ladder(s_digits, k_digits, a_point)
        r = self.add(r, neg(r_point))
        m = self.mul8(r)
        return (m[0], m[1], m[2])


_DISPATCH = PointOps(F.mul, F.sq)
_PLAIN = PointOps(F.mul_plain, F.sq_plain)

add = _DISPATCH.add
to_niels = _DISPATCH.to_niels
add_niels = _DISPATCH.add_niels
madd = _DISPATCH.madd
dbl = _DISPATCH.dbl
dbl_no_t = _DISPATCH.dbl_no_t
eq_points = _DISPATCH.eq_points
compress = _DISPATCH.compress
lane_table = _DISPATCH.lane_table
ladder = _DISPATCH.ladder
fixed_base = _DISPATCH.fixed_base
mul8 = _DISPATCH.mul8


def _split_encoding(b):
    """(B, 32) uint8 -> (sign (B,) int32, y (22, B) loose limbs < 2^255)."""
    sign = (b[:, 31].to(torch.int32) >> 7) & 1
    masked = b.clone()
    masked[:, 31] &= 0x7F
    return sign, F.from_bytes_le(masked)


def decompress(b):
    """ZIP-215 liberal point decoding.

    b: (B, 32) uint8 encodings. Returns (valid: bool (B,), point).
    Non-canonical y (>= p) is reduced mod p; x == 0 with sign bit 1 is
    accepted as x = 0. Invalid (non-square) lanes return valid=False with
    an arbitrary well-formed point. On a CUDA tensor the decoding core is
    the `decompress` kernel; on a CPU tensor, `decompress_plain`.
    """
    sign, y = _split_encoding(b)
    one = F.const(1, y.device).expand(y.shape)
    if F.on_gpu(y):
        valid, x, t = K.decompress(y, sign[None, :].contiguous())
        return valid[0] != 0, (x, y, one, t)
    valid, x, t = decompress_plain(y, sign)
    return valid, (x, y, one, t)


def decompress_plain(y, sign):
    """Plain PyTorch version of the decompress kernel (reference
    `_decompress_kernel`) on any device: (valid (B,), x, t)."""
    return _PLAIN.decompress_value(y, sign)


def ladder_sub_mul8(s_digits, k_digits, a_point, r_point):
    """(X, Y, Z) of [8]([s]B + [k]a_point - r_point): the whole ZIP-215
    verification equation's left side. One kernel launch on CUDA tensors;
    `ladder_sub_mul8_plain` on CPU tensors."""
    if F.on_gpu(s_digits):
        out = K.ladder_sub_mul8(
            torch.stack(a_point[:4]),
            torch.stack(r_point[:4]),
            s_digits.contiguous(),
            k_digits.contiguous(),
            base_niels(s_digits.device),
        )
        return (out[0], out[1], out[2])
    return ladder_sub_mul8_plain(s_digits, k_digits, a_point, r_point)


def ladder_sub_mul8_plain(s_digits, k_digits, a_point, r_point):
    """Plain PyTorch version of the ladder kernel (reference
    `_ladder_sub_kernel`) on any device."""
    return _PLAIN.ladder_sub_mul8_value(s_digits, k_digits, a_point, r_point)


def scalar_digits(scalars) -> np.ndarray:
    """Host-side: python ints (< 2^253) -> (64, N) int32 signed digits.

    Same recoding as ops.scalar.recode_signed: the nibbles of s + 0x888...8
    (mod 2^256), each minus 8."""
    half = int("8" * 64, 16)
    mask = (1 << 256) - 1
    blob = b"".join(((s + half) & mask).to_bytes(32, "little") for s in scalars)
    byts = np.frombuffer(blob, np.uint8).reshape(len(scalars), 32).astype(np.int32)
    nib = np.empty((len(scalars), 64), np.int32)
    nib[:, 0::2] = byts & 15
    nib[:, 1::2] = byts >> 4
    return np.ascontiguousarray((nib - 8).T)


def from_reference_arrays(arrays, device="cuda"):
    """The reference's numpy limb/digit/mask arrays (or a tuple of them, such
    as a point) -> the port's tensors on `device`: integer arrays become
    int32, boolean arrays stay boolean."""
    if isinstance(arrays, (tuple, list)):
        return tuple(from_reference_arrays(a, device) for a in arrays)
    arr = np.asarray(arrays)
    if arr.dtype != np.bool_:
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
