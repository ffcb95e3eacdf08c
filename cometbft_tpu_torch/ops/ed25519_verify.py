"""Batched Ed25519 ZIP-215 verification on device.

Twin of `cometbft_tpu/ops/ed25519_verify.py`. Per-lane cofactored
verification: each lane checks

    [8]([S]B + [k](-A) - R) == identity

with liberal (ZIP-215) decoding of A and R. k = SHA-512(R||A||M) mod L
is hashed on the host for the prehashed functions, and on the device for
`verify_batch` (padded messages from the host) and `verify_batch_delta`
(messages rebuilt on the device from a shared prefix and suffix and
per-lane middle bytes): there one `sha512_reduce` kernel (the hash and
the reduction mod L in one launch) runs before `decompress` and the
ladder. Every function returns (bits, all_ok) with both left on the
device: fetching the one all-ok scalar is the happy path, the bitmap
crosses only when some lane failed.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import scalar as SC
from . import sha512 as H
from .sha512 import digest_to_bytes as _digest_to_bytes  # noqa: F401 (the reference's name)


def _finish(ok_a, ok_r, s_ok, X, Y, Z, live):
    ok_eq = F.is_zero(X) & F.eq(Y, Z)
    bits = ok_a & ok_r & ok_eq & s_ok & live
    return bits, torch.all(bits | ~live)


def _challenge_digits(msg_words, two_blocks):
    """k = SHA-512(padded message) mod L as (64, B) signed digits."""
    return SC.recode_signed(SC.sha512_reduce(msg_words, two_blocks))


def verify_batch(a_bytes, r_bytes, s_bytes, msg_words, two_blocks, live):
    """Batched ZIP-215 verify, the challenge hashed on the device.

    a_bytes, r_bytes, s_bytes: (B, 32) uint8 as-received encodings;
    msg_words: (B, 64) SHA-512-padded R||A||M words from
    `sha512.pad_messages` (int64 < 2^32, or int32 bit patterns);
    two_blocks: (B,) bool; live: (B,) bool padding mask (False lanes
    report False)."""
    k_digits = _challenge_digits(msg_words, two_blocks)
    s_digits = SC.digits_from_bytes(s_bytes)
    s_ok = SC.lt_l(s_bytes)
    ok_a, a_pt = C.decompress(a_bytes)
    ok_r, r_pt = C.decompress(r_bytes)
    X, Y, Z = C.ladder_sub_mul8(s_digits, k_digits, C.neg(a_pt), r_pt)
    return _finish(ok_a, ok_r, s_ok, X, Y, Z, live)


def verify_batch_prehashed(a_bytes, r_bytes, s_bytes, k_bytes, live):
    """Batched ZIP-215 verify with the challenge scalar computed host-side.

    a_bytes, r_bytes, s_bytes, k_bytes: (B, 32) uint8 (k little-endian,
    canonical k < L); live: (B,) bool padding mask. A and R decompress
    together, in one `decompress` launch over 2B lanes (each shard of the
    mesh verifies through here).
    """
    b = a_bytes.shape[0]
    k_digits = SC.digits_from_bytes(k_bytes)
    s_digits = SC.digits_from_bytes(s_bytes)
    s_ok = SC.lt_l(s_bytes)
    ok, pt = C.decompress(torch.cat([a_bytes, r_bytes]))
    a_pt, r_pt = tuple(c[:, :b] for c in pt), tuple(c[:, b:] for c in pt)
    X, Y, Z = C.ladder_sub_mul8(s_digits, k_digits, C.neg(a_pt), r_pt)
    return _finish(ok[:b], ok[b:], s_ok, X, Y, Z, live)


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


# delta-wire meta layout, shared by the host packer
# (crypto/ed25519._pack_delta) and the device unpacker (verify_batch_delta):
# [plen, slen, n_lo, n_mid, n_hi, pad*3, prefix[DELTA_PMAX], suffix[DELTA_PMAX]]
DELTA_META_HEADER = 8
DELTA_PMAX = 176  # >= MAX_INPUT_BYTES - 64 (max message length 175)
DELTA_META_LEN = DELTA_META_HEADER + 2 * DELTA_PMAX


def build_delta_msgs(a_enc, rs_mid, mlens, plen, slen, prefix, suffix):
    """Rebuild the SHA-512-padded R||A||M blocks on the device from a
    shared prefix and suffix plus per-lane middle bytes (commit sign bytes
    differ per lane only in the vote timestamp).

    a_enc:  (B, 32) uint8 pubkey encodings (device-resident cache).
    rs_mid: (B, 64 + MIDMAX) uint8, R || S || middle bytes.
    mlens:  (B,) per-lane middle length.
    plen, slen: 0-d int tensors, the shared prefix and suffix lengths.
    prefix, suffix: (PMAX,) uint8 shared bytes.

    Returns (B, 64) int32 big-endian padded words and (B,) bool two_blocks.
    Every gather clamps its index into range, as the reference's
    `jnp.take(..., clip)` does; the selects then keep only in-range bytes.
    """
    dev = rs_mid.device
    batch, midmax = rs_mid.shape[0], rs_mid.shape[1] - 64
    pos = torch.arange(H.PADDED_BYTES, device=dev)  # (256,)
    m_off = pos - 64
    mlens = mlens.to(torch.int64)[:, None]  # (B, 1)
    total = plen + mlens + slen  # (B, 1) message length per lane
    head = torch.cat([rs_mid[:, :32], a_enc], dim=1)  # (B, 64) R || A
    head_b = head[:, pos.clamp(0, 63)]
    pfx_b = prefix[m_off.clamp(0, prefix.shape[0] - 1)][None, :]
    mid_b = rs_mid[:, 64:][:, (m_off - plen).clamp(0, midmax - 1)]
    sfx_b = suffix[(m_off[None, :] - plen - mlens).clamp(0, suffix.shape[0] - 1)]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    b = torch.where(m_off < 0, head_b, torch.where(
        m_off < plen, pfx_b, torch.where(
            m_off < plen + mlens, mid_b, torch.where(m_off < total, sfx_b, zero))))
    # SHA-512 padding: the 0x80 terminator, and the big-endian bit length
    # in the last two bytes of the last block (one block iff 64 + total <= 111)
    end = 64 + total
    b = torch.where(pos == end, torch.full_like(zero, 0x80), b).to(torch.int32)
    two = end > 111
    blk = torch.where(two, H.PADDED_BYTES, H.PADDED_BYTES // 2)
    bits = (end * 8).to(torch.int32)  # < 2^16: two length bytes suffice
    b = torch.where(pos == blk - 2, bits >> 8, torch.where(pos == blk - 1, bits & 0xFF, b))
    b = b.reshape(batch, H.PADDED_WORDS, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return words, two[:, 0]


def verify_batch_delta(ok_a, neg_a, a_enc, packed, meta):
    """`verify_batch` with cached pubkeys and the messages rebuilt on the
    device (`build_delta_msgs`) from two host arrays:

      packed: (B, 64 + MIDMAX + 1) uint8, R || S || middle bytes || middle length;
      meta:   (DELTA_META_LEN,) uint8, [plen, slen, n_lo, n_mid, n_hi, pad*3,
              prefix[176], suffix[176]]; the live lanes are the first n.
    """
    rs_mid = packed[:, :-1]
    meta32 = meta.to(torch.int64)
    plen, slen = meta32[0], meta32[1]
    n = meta32[2] | (meta32[3] << 8) | (meta32[4] << 16)
    live = torch.arange(packed.shape[0], device=packed.device) < n
    h = DELTA_META_HEADER
    words, two = build_delta_msgs(a_enc, rs_mid, packed[:, -1], plen, slen,
                                  meta[h : h + DELTA_PMAX], meta[h + DELTA_PMAX :])
    k_digits = _challenge_digits(words, two)
    s_bytes = rs_mid[:, 32:64]
    s_digits = SC.digits_from_bytes(s_bytes)
    s_ok = SC.lt_l(s_bytes)
    ok_r, r_pt = C.decompress(rs_mid[:, :32])
    X, Y, Z = C.ladder_sub_mul8(s_digits, k_digits, neg_a, r_pt)
    return _finish(ok_a, ok_r, s_ok, X, Y, Z, live)
