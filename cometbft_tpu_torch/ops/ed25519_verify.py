"""Batched Ed25519 ZIP-215 verification on device (prehashed route).

Twin of the prehashed half of `cometbft_tpu/ops/ed25519_verify.py`.
Per-lane cofactored verification: each lane checks

    [8]([S]B + [k](-A) - R) == identity

with liberal (ZIP-215) decoding of A and R, where k = SHA-512(R||A||M)
mod L was hashed on the host. Every function returns (bits, all_ok) with
both left on the device: fetching the one all-ok scalar is the happy
path, the bitmap crosses only when some lane failed.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import scalar as SC


def _finish(ok_a, ok_r, s_ok, X, Y, Z, live):
    ok_eq = F.is_zero(X) & F.eq(Y, Z)
    bits = ok_a & ok_r & ok_eq & s_ok & live
    return bits, torch.all(bits | ~live)


def verify_batch_prehashed(a_bytes, r_bytes, s_bytes, k_bytes, live):
    """Batched ZIP-215 verify with the challenge scalar computed host-side.

    a_bytes, r_bytes, s_bytes, k_bytes: (B, 32) uint8 (k little-endian,
    canonical k < L); live: (B,) bool padding mask.
    """
    k_digits = SC.digits_from_bytes(k_bytes)
    s_digits = SC.digits_from_bytes(s_bytes)
    s_ok = SC.lt_l(s_bytes)
    ok_a, a_pt = C.decompress(a_bytes)
    ok_r, r_pt = C.decompress(r_bytes)
    X, Y, Z = C.ladder_sub_mul8(s_digits, k_digits, C.neg(a_pt), r_pt)
    return _finish(ok_a, ok_r, s_ok, X, Y, Z, live)


def decompress_pubkeys(a_bytes):
    """(B, 32) uint8 pubkey encodings -> (ok, negated extended point).

    The A half of the verification equation, split out so callers keep a
    validator set's decompressed points on the device: the same pubkey
    column verifies every height, so A crosses the link and decompresses
    once per validator-set change instead of once per commit."""
    ok_a, a_pt = C.decompress(a_bytes)
    return ok_a, C.neg(a_pt)


def verify_batch_cached_a(ok_a, neg_a, rsk, live):
    """verify_batch_prehashed with the pubkey stage precomputed by
    decompress_pubkeys (device-resident across submits).

    rsk: (B, 96) uint8, R || S || k in one array so the per-commit
    host->device traffic is a single contiguous copy."""
    r_bytes = rsk[:, :32]
    s_bytes = rsk[:, 32:64]
    k_bytes = rsk[:, 64:]
    k_digits = SC.digits_from_bytes(k_bytes)
    s_digits = SC.digits_from_bytes(s_bytes)
    s_ok = SC.lt_l(s_bytes)
    ok_r, r_pt = C.decompress(r_bytes)
    X, Y, Z = C.ladder_sub_mul8(s_digits, k_digits, neg_a, r_pt)
    return _finish(ok_a, ok_r, s_ok, X, Y, Z, live)
