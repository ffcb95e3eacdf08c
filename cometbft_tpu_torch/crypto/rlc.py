"""Host half of the RLC/MSM batch verifier: scalars, digits, layout.

Twin of `cometbft_tpu/crypto/rlc.py`. The device (`ops/msm.py`) wants a
dense (S, W*K) gather table; everything data-dependent (SHA-512
challenges, random coefficients, signed-digit decomposition, bucket
sorting, slot assignment) is done here, leaving the device pure point
arithmetic. Mirrors the scalar side of the reference's batch verifier
(crypto/ed25519/ed25519.go:207-240: z_i sampling, h_i = H(R||A||M),
s-coefficient accumulation).

`prepare` takes the native C++ packer (`crypto/native.py::rlc_pack`,
`csrc/host/rlc_packer.inc`) when the host library is built, and the
numpy packer `prepare_numpy` when it is absent; `prepare_numpy` is also
the oracle the native packer is tested against. For the same items, skip
mask, bucket and z coefficients both give byte-identical arrays, and
identical to the reference's `prepare` and `prepare_numpy`.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..ops.curve import scalar_digits
from . import ed25519_ref as ref
from . import native

L = ref.L

C_BITS = 10
K_BUCKETS = 1 << (C_BITS - 1)
N_WINDOWS = 26
Z_WINDOWS = 13  # 128-bit z + carry fits 13 ten-bit windows

# Every (scalar-class, window) pair owns a full K_BUCKETS lane region:
# the z and m digits of a shared window would otherwise need > K lanes
# between them. Regions are ordered by descending weight 2^(10w); two
# regions sharing a window get 0 doublings between them in the device's
# Horner chain (ops/msm.py REGION_DBL).
# order: m25..m13, then (m12, z12), (m11, z11), ..., (m0, z0)
N_REGIONS = N_WINDOWS + Z_WINDOWS  # 39
WK = N_REGIONS * K_BUCKETS


def region_of_m(w: int) -> int:
    return 25 - w if w >= 13 else 37 - 2 * w


def region_of_z(w: int) -> int:
    return 38 - 2 * w


# Per-lane slot depth: long (window, digit) runs split across lanes at
# this depth, which caps the device round count S = max lane occupancy.
# The floor aims to keep Sigma_v ceil(count_v / depth) within the K-lane
# window budget; an overflow sends the batch to the per-lane route. A
# window in which all K magnitudes occur overflows as soon as one of them
# occurs more than `depth` times, which is not rare at 10,000 signatures.
def slot_depth(bucket: int) -> int:
    mean = max(bucket / K_BUCKETS, 1.0)
    return int(np.ceil(mean + 4.0 * np.sqrt(mean) + 4))


def _signed_digits(scalars_bytes: np.ndarray, n_windows: int) -> np.ndarray:
    """(N, 33) LE bytes -> (N, n_windows) signed digits in [-511, 512],
    value = sum_w digit_w * 2^(10w)."""
    n = scalars_bytes.shape[0]
    bits = np.unpackbits(scalars_bytes, axis=1, bitorder="little")
    need = n_windows * C_BITS
    raw = bits[:, :need].reshape(n, n_windows, C_BITS).astype(np.int32)
    vals = raw @ (1 << np.arange(C_BITS, dtype=np.int32))
    digits = np.zeros((n, n_windows), np.int32)
    carry = np.zeros(n, np.int32)
    for w in range(n_windows):
        d = vals[:, w] + carry
        over = d > K_BUCKETS  # d in [0, 1024]; 513..1024 wrap negative
        d = np.where(over, d - (1 << C_BITS), d)
        carry = over.astype(np.int32)
        digits[:, w] = d
    # top carry cannot occur: scalars < 2^253 (resp. 2^129) leave the
    # highest window <= 512 even after +1
    return digits


def prepare(items, skip: np.ndarray, bucket: int, z16=None, blobs=None):
    """Build the device inputs for one RLC batch.

    items: list of (pub32, msg, sig64), or None when `blobs` holds the
    batch; skip: bool (n,) lanes excluded (precheck failures: they get z=0
    and are reported failed by the caller). Returns a dict, or None when a
    bucket overflows slot depth or no lane is live (the caller takes the
    per-lane route).

    z16: optional (n, 16) uint8 little-endian z coefficients (bit 0 is
    forced on). Tests pin it to compare with the reference bit-for-bit;
    production leaves it None (a fresh CSPRNG draw per batch).
    blobs: optional columnar (pub_blob, sig_blob, msg_blob, msg_lens), as
    the verifier holds them: the native packer reads them without a
    per-item join.
    """
    if native.rlc_available():
        return _prepare_native(items, skip, bucket, z16, blobs)
    if items is None:
        items = items_of(*blobs)
    return prepare_numpy(items, skip, bucket, z16)


def items_of(pub_blob, sig_blob, msg_blob, msg_lens) -> list[tuple[bytes, bytes, bytes]]:
    """Columnar blobs (32-byte pubs, 64-byte sigs, concatenated messages
    and their lengths) -> (pub, msg, sig) tuples."""
    out, off = [], 0
    for i, ln in enumerate(int(x) for x in msg_lens):
        out.append((bytes(pub_blob[32 * i : 32 * i + 32]), bytes(msg_blob[off : off + ln]),
                    bytes(sig_blob[64 * i : 64 * i + 64])))
        off += ln
    return out


def prepare_numpy(items, skip: np.ndarray, bucket: int, z16=None):
    """The numpy packer: the native packer's oracle, and `prepare` when
    the host library is absent. Same contract as `prepare` (items
    required)."""
    n = len(items)
    depth = slot_depth(bucket)
    if depth > 255:
        # lane counts ship as uint8; buckets beyond 65536 would wrap
        # them and corrupt the layout, so decline and let the per-lane
        # route (which has no such bound) take the batch
        return None

    if z16 is not None:
        z16 = np.ascontiguousarray(z16, np.uint8).reshape(n, 16)

    zs: list[int] = []
    ms: list[int] = []
    c = 0
    live_idx = []
    for i, (pub, msg, sig) in enumerate(items):
        if skip[i]:
            zs.append(0)
            ms.append(0)
            continue
        h = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L
        if z16 is None:
            z = int.from_bytes(os.urandom(16), "little") | 1  # nonzero
        else:
            z = int.from_bytes(z16[i].tobytes(), "little") | 1
        s = int.from_bytes(sig[32:], "little")
        zs.append(z)
        ms.append((z * h) % L)
        c = (c + z * s) % L
        live_idx.append(i)
    if not live_idx:
        return None

    z_bytes = np.zeros((n, 33), np.uint8)
    m_bytes = np.zeros((n, 33), np.uint8)
    for i in range(n):
        if zs[i]:
            z_bytes[i, :17] = np.frombuffer(zs[i].to_bytes(17, "little"), np.uint8)
            m_bytes[i] = np.frombuffer(ms[i].to_bytes(33, "little"), np.uint8)
    z_digits = _signed_digits(z_bytes, Z_WINDOWS)  # (n, 13)
    m_digits = _signed_digits(m_bytes, N_WINDOWS)  # (n, 26)

    # contributions: (point_index, region, digit); R_i at lane i, A_i at
    # bucket+i. The equation needs -R, -A: the digit sign is pre-negated.
    z_regions = np.array([region_of_z(w) for w in range(Z_WINDOWS)])
    m_regions = np.array([region_of_m(w) for w in range(N_WINDOWS)])
    pt_idx_parts, win_parts, dig_parts = [], [], []
    r_pt = np.broadcast_to(np.arange(n)[:, None], z_digits.shape)
    a_pt = np.broadcast_to((bucket + np.arange(n))[:, None], m_digits.shape)
    r_win = np.broadcast_to(z_regions[None, :], z_digits.shape)
    a_win = np.broadcast_to(m_regions[None, :], m_digits.shape)
    for pts, wins, digs in ((r_pt, r_win, z_digits), (a_pt, a_win, m_digits)):
        nz = digs != 0
        pt_idx_parts.append(pts[nz])
        win_parts.append(wins[nz])
        dig_parts.append(-digs[nz])  # pre-negated sign
    pt_idx = np.concatenate(pt_idx_parts)
    win = np.concatenate(win_parts)
    dig = np.concatenate(dig_parts)

    # ---- lane assignment with bucket splitting
    # Scalar digits are not uniform per window (the top window of a
    # mod-L scalar concentrates in a few values, L being barely above
    # 2^252), so each (window, |digit|) run gets as many lanes as it needs
    # (ceil(count / depth)) and the device reads per-lane weights from a
    # table: splitting costs the device nothing.
    value = np.abs(dig)  # 1..K
    key = win * (K_BUCKETS + 1) + value  # dense run key
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.searchsorted(key_s, key_s, side="left")
    pos = np.arange(len(key_s)) - first  # position within (w, v) run

    run_keys, run_counts = np.unique(key_s, return_counts=True)
    run_lanes = -(-run_counts // depth)  # lanes each run needs
    run_win = run_keys // (K_BUCKETS + 1)
    # exclusive cumsum of lane needs, reset per window
    csum = np.concatenate([[0], np.cumsum(run_lanes)])
    win_first_run = np.searchsorted(run_win, run_win, side="left")
    run_base = csum[:-1] - csum[win_first_run]  # lane base within window
    if len(run_lanes) and (run_base + run_lanes > K_BUCKETS).any():
        return None  # window lane budget exceeded: per-lane route

    # per-contribution lane + slot
    run_of = np.searchsorted(run_keys, key_s)
    lane_in_win = run_base[run_of] + pos // depth
    slot = pos % depth
    lane = run_win[run_of] * K_BUCKETS + lane_in_win

    weight_table = np.zeros((N_REGIONS, K_BUCKETS), np.int32)
    for_win = run_win.astype(np.int64)
    for r in range(len(run_keys)):
        w0 = for_win[r]
        v0 = run_keys[r] % (K_BUCKETS + 1)
        weight_table[w0, run_base[r] : run_base[r] + run_lanes[r]] = v0

    # ---- dense contribution stream
    # The host ships the contributions as one dense stream ordered by
    # lane (index + sign) plus per-lane counts, ~2 bytes per contribution;
    # the device rebuilds the (S, WK) gather table (ops/msm.py
    # expand_stream).
    order2 = np.lexsort((slot, lane))  # by lane, then slot
    lane_sorted = lane[order2]
    counts = np.bincount(lane_sorted, minlength=WK).astype(np.uint8)
    s_rounds = int(counts.max()) if len(lane_sorted) else 1
    pt_sorted = pt_idx[order][order2].astype(np.int64)
    neg_sorted = (dig[order][order2] < 0).astype(np.uint8)
    sentinel = 2 * bucket
    wide = sentinel > 0x7FFF  # uint16 covers buckets <= 16383
    dt = np.uint32 if wide else np.uint16
    # Pad the stream to a tiered length (8192-entry tiers), as the
    # reference does so that its compiled graph sees few distinct
    # shapes; trailing slots hold the identity sentinel, which invalid
    # gathers also target.
    c_len = len(pt_sorted)
    tier = 1 << 13
    padded = ((c_len + 1 + tier - 1) // tier) * tier
    stream = np.full(padded, sentinel, dt)
    stream[:c_len] = pt_sorted
    # signs ride in a separate bit-packed array over the full padded
    # length; pad bits are zero and only sentinel slots land on them
    neg_padded = np.zeros(padded, np.uint8)
    neg_padded[:c_len] = neg_sorted
    stream_neg = np.packbits(neg_padded, bitorder="little")

    return {
        "stream": stream,  # (tiered,) point indices dense by lane, then sentinels
        "stream_neg": stream_neg,  # bit-packed signs, same order, tiered/8 bytes
        "counts": counts,  # (WK,) contributions per lane
        "s_rounds": s_rounds,  # round count the layout needs
        "weights": weight_table,  # (W, K) per-lane digit values
        "c_digits": scalar_digits([c]),  # (64, 1)
    }


def _prepare_native(items, skip, bucket: int, z16, blobs):
    """`prepare` on the native packer: the same dict, or None on the same
    declines (a window's lanes overflow, or no live lane)."""
    n = len(items) if items is not None else len(skip)
    depth = slot_depth(bucket)
    if depth > 255:
        return None  # the numpy path's uint8-counts bound
    if blobs is not None:
        pub_blob, sig_blob, msg_blob, msg_lens = blobs
    else:
        pub_blob = b"".join(it[0] for it in items)
        sig_blob = b"".join(it[2] for it in items)
        msg_blob = b"".join(it[1] for it in items)
        msg_lens = [len(it[1]) for it in items]
    msg_lens = np.ascontiguousarray(msg_lens, np.uint64)
    skip_u8 = np.ascontiguousarray(np.asarray(skip, bool).astype(np.uint8))
    if z16 is None:
        z16 = np.frombuffer(os.urandom(16 * n), np.uint8)
    z16 = np.ascontiguousarray(z16, np.uint8).reshape(-1)
    if z16.size != 16 * n:
        raise ValueError("z16 must be n*16 bytes")

    sentinel = 2 * bucket
    wide = sentinel > 0x7FFF  # uint16 covers buckets <= 16383
    dt = np.uint32 if wide else np.uint16
    tier = 1 << 13
    cap = ((N_REGIONS * n + 1 + tier - 1) // tier) * tier  # max c_len + 1, tiered
    stream = np.empty(cap, dt)
    neg = np.zeros(cap, np.uint8)  # the tail must stay 0 for packbits
    counts = np.empty(WK, np.uint8)
    weights = np.empty((N_REGIONS, K_BUCKETS), np.int32)
    out_c = np.empty(32, np.uint8)
    c_len, s_rounds = native.rlc_pack(
        n, bucket, depth, pub_blob, sig_blob, msg_blob, msg_lens, skip_u8, z16,
        4 if wide else 2, stream, neg, counts, weights, out_c)
    if c_len < 0:
        return None  # -1 lane overflow, -2 no live lane: the numpy path's None

    # the numpy path's tiering: at least one sentinel slot, then the stream
    # rounded up to the next 8192-entry tier
    padded = ((c_len + 1 + tier - 1) // tier) * tier
    stream[c_len:padded] = sentinel
    return {
        "stream": stream[:padded],
        "stream_neg": np.packbits(neg[:padded], bitorder="little"),
        "counts": counts,
        "s_rounds": s_rounds,
        "weights": weights,
        "c_digits": scalar_digits([int.from_bytes(out_c.tobytes(), "little")]),
    }


def expand_stream_host(prep, s_rounds: int | None = None):
    """Numpy mirror of ops.msm.expand_stream: dense stream -> padded
    (S, WK) gather table. For layout tests and debugging; the verifier
    expands on the device so the wire stays compact."""
    counts = prep["counts"].astype(np.int64)
    S = s_rounds if s_rounds is not None else prep["s_rounds"]
    offsets = np.cumsum(counts) - counts
    pos = offsets[None, :] + np.arange(S)[:, None]
    valid = np.arange(S)[:, None] < counts[None, :]
    pos = np.where(valid, pos, len(prep["stream"]) - 1)
    idx = prep["stream"][pos].astype(np.int64)
    negbits = np.unpackbits(prep["stream_neg"], bitorder="little")
    neg = (negbits[pos] != 0) & valid
    return idx, neg
