"""Pure-Python Ed25519 reference implementation (scalar, host-side).

The port's own copy of `cometbft_tpu/crypto/ed25519_ref.py`: the *golden
model* for the CUDA kernels in `cometbft_tpu_torch.ops`, the source of the
curve constants and tables in `ops/curve.py`, and the only signer on a
host without `cryptography` or `nacl`. It implements:

- RFC 8032 key generation / signing.
- **ZIP-215 verification semantics**, matching the reference framework's
  consensus-critical rules (reference: crypto/ed25519/ed25519.go:36-41, which
  uses curve25519-voi with ZIP-215 verification options):
    * accept non-canonical encodings of A and R (y >= p is reduced mod p;
      "negative zero" x encodings are accepted),
    * reject S >= L (non-canonical scalars),
    * use the cofactored verification equation [8][S]B = [8]R + [8][k]A,
    * k = SHA-512(R || A || M) over the *as-received* encodings.

Written from the RFC 8032 / ZIP-215 specifications; not a translation of any
existing implementation. Performance is irrelevant here — this is a spec
oracle for differential tests and a correctness fallback.
"""

from __future__ import annotations

import hashlib
import os

# --- Field / curve parameters (edwards25519) ---
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # -121665/121666 mod p
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p (p = 5 mod 8)
assert (SQRT_M1 * SQRT_M1) % P == P - 1

# Base point B: y = 4/5 mod p, x recovered with even sign.
_By = (4 * pow(5, P - 2, P)) % P


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def _recover_x(y: int, sign: int, *, zip215: bool) -> int | None:
    """Recover x from y and the sign bit. Returns None if no sqrt exists.

    Under ZIP-215 rules, x == 0 with sign == 1 is *accepted* (yielding x=0),
    whereas strict RFC 8032 rejects it. y is taken mod p by the caller.
    """
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate sqrt of u/v for p = 5 mod 8: x = u v^3 (u v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    vxx = (v * x * x) % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if x == 0 and sign == 1:
        if not zip215:
            return None
        return 0
    if x % 2 != sign:
        x = (P - x) % P
    return x


def _decode_point(s: bytes, *, zip215: bool) -> tuple[int, int] | None:
    """Decode 32-byte point encoding -> affine (x, y), or None if invalid.

    ZIP-215: the 255-bit y value is reduced mod p (non-canonical encodings
    accepted). Strict mode rejects y >= p.
    """
    if len(s) != 32:
        return None
    yb = int.from_bytes(s, "little")
    sign = yb >> 255
    y = yb & ((1 << 255) - 1)
    if not zip215 and y >= P:
        return None
    y %= P
    x = _recover_x(y, sign, zip215=zip215)
    if x is None:
        return None
    return (x, y)


def _encode_point(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


# --- Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
def _to_ext(p: tuple[int, int]):
    x, y = p
    return (x, y, 1, (x * y) % P)


_IDENT = (0, 1, 1, 0)


def _ext_add(p, q):
    # add-2008-hwcd-3 for a=-1 twisted Edwards (complete, handles doubling).
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = ((Y1 - X1) * (Y2 - X2)) % P
    B = ((Y1 + X1) * (Y2 + X2)) % P
    C = (T1 * 2 * D % P) * T2 % P
    Dv = (Z1 * 2 * Z2) % P
    E = (B - A) % P
    F = (Dv - C) % P
    G = (Dv + C) % P
    H = (B + A) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def _ext_neg(p):
    X, Y, Z, T = p
    return ((P - X) % P, Y, Z, (P - T) % P)


def _ext_scalar_mul(k: int, p):
    q = _IDENT
    while k > 0:
        if k & 1:
            q = _ext_add(q, p)
        p = _ext_add(p, p)
        k >>= 1
    return q


def _ext_to_affine(p) -> tuple[int, int]:
    X, Y, Z, _ = p
    zi = _inv(Z)
    return ((X * zi) % P, (Y * zi) % P)


def _ext_is_identity(p) -> bool:
    X, Y, Z, _ = p
    return X % P == 0 and (Y - Z) % P == 0


_Bx = _recover_x(_By, 0, zip215=False)
assert _Bx is not None
B_POINT = _to_ext((_Bx, _By))


# --- Key generation / signing (RFC 8032) ---
def _clamp(h: bytes) -> int:
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


def pubkey_from_seed(seed: bytes) -> bytes:
    assert len(seed) == 32
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    A = _ext_scalar_mul(a, B_POINT)
    return _encode_point(*_ext_to_affine(A))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signing. Returns 64-byte signature R || S."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    A_enc = pubkey_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = _ext_scalar_mul(r, B_POINT)
    R_enc = _encode_point(*_ext_to_affine(R))
    k = int.from_bytes(hashlib.sha512(R_enc + A_enc + msg).digest(), "little") % L
    s = (r + k * a) % L
    return R_enc + s.to_bytes(32, "little")


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verification (cofactored, liberal decoding, S < L enforced)."""
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    R_enc, S_enc = sig[:32], sig[32:]
    s = int.from_bytes(S_enc, "little")
    if s >= L:
        return False
    A = _decode_point(pubkey, zip215=True)
    R = _decode_point(R_enc, zip215=True)
    if A is None or R is None:
        return False
    k = int.from_bytes(hashlib.sha512(R_enc + pubkey + msg).digest(), "little") % L
    # [8]([S]B - R - [k]A) == identity
    sB = _ext_scalar_mul(s, B_POINT)
    kA = _ext_scalar_mul(k, _to_ext(A))
    diff = _ext_add(sB, _ext_neg(_ext_add(_to_ext(R), kA)))
    return _ext_is_identity(_ext_scalar_mul(8, diff))


def generate_seed() -> bytes:
    return os.urandom(32)


def batch_verify_parts(pubkeys, msgs, sigs) -> list[bool]:
    """Scalar batch verify: per-signature verdicts (oracle for the GPU path)."""
    return [verify(p, m, s) for p, m, s in zip(pubkeys, msgs, sigs)]
