"""Random-linear-combination batch verification as one multi-scalar
multiplication.

Twin of `cometbft_tpu/ops/msm.py`. The reference's CPU batch verifier
(crypto/ed25519/ed25519.go:207-240) collapses N verifications into one
check

    [8]( [c]B - sum_i [z_i]R_i - sum_i [z_i h_i]A_i ) == identity,
    c = sum_i z_i s_i  (mod L),  z_i random 128-bit, h_i = H(R||A||M)

which is a 2N-point multi-scalar multiplication. The host
(`crypto/rlc.py`) computes every scalar and signed base-2^C digit and
sorts the (window, bucket) contributions into a dense stream; the device
then runs

  1. ZIP-215 decompression of every A_i, R_i (`curve.decompress`),
  2. `accumulate_weighted`: S rounds of lane-parallel mixed additions,
     each gathering one point per bucket lane, then each lane multiplied
     by its bucket weight (the `accum_weight` kernel),
  3. `region_tree_sum`: a pairwise tree over each region's 512 lanes
     (the `region_sum` kernel),
  4. `window_combine`: Horner over regions (10 doublings per window; the
     `window_combine` kernel),
  5. [8](msm + [c]B) as one `curve.ladder_sub_mul8` at B = 1, i.e.
     [8]([c]B + [0]A - R) with A the identity and R = -msm, then the
     identity check: one scalar verdict.

Steps 2-4 launch their kernel on CUDA tensors and run their plain version
(`*_plain`, on the plain field routes) on CPU tensors; the reference runs
3-5 inside its one XLA program, where a kernel per field product costs no
launch. Both devices take the reference's kernel route (its
`_accum_weight_kernel`, then `_region_tree_sum`); the reference's
non-Pallas `_bucket_reduce` computes the same sums another way and has
no twin here. Each `lax.scan` of the reference is a Python loop, and
its `lax.cond` a Python branch on the static `REGION_DBL`.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from . import kernels as K

# Signed digit decomposition: base 2^C_BITS, buckets hold |digit| in
# [1, K]; every (scalar-class, window) pair owns its own K-lane region
# (26 windows for the 253-bit z*h scalars + 13 for the 128-bit z),
# ordered by descending weight. REGION_DBL[r] is how many doublings the
# Horner chain applies before folding region r in: 10 when the weight
# drops a window, 0 when region r shares its window with the previous
# one (the z/m split of windows 0..12). Layout authority:
# crypto/rlc.py region_of_m / region_of_z.
C_BITS = 10
K_BUCKETS = 1 << (C_BITS - 1)  # 512
N_WINDOWS = 26
Z_WINDOWS = 13
N_REGIONS = N_WINDOWS + Z_WINDOWS  # 39
WK = N_REGIONS * K_BUCKETS  # 19968 bucket lanes
REGION_DBL = tuple(
    [0]
    + [C_BITS] * 13  # m24..m12
    + [0 if i % 2 else C_BITS for i in range(1, 26)]  # z12, m11, z11, ...
)
# regions: r0=m25; r1..r13 = m24..m12 (10 dbl each); r14=z12 (0);
# r15=m11 (10); r16=z11 (0); ...; r37=m0 (10); r38=z0 (0)
assert len(REGION_DBL) == N_REGIONS


def _identity_niels(batch: int, device):
    one = F.const(1, torch.device(device)).expand(F.NLIMBS, batch)
    zero = torch.zeros((F.NLIMBS, batch), dtype=torch.int32, device=device)
    return one, one, zero  # (Y+X, Y-X, 2dT) of (0, 1)


def _gather_madd(ops, acc, niels, idx, neg):
    """One round: gather a niels point per lane by `idx` (WK,), swap
    Y+X / Y-X and negate 2dT where `neg`, madd it into `acc`."""
    ypx, ymx, t2d = (c[:, idx] for c in niels)
    a = F.select(neg, ymx, ypx)
    b = F.select(neg, ypx, ymx)
    t = F.select(neg, F.neg(t2d), t2d)
    return ops.madd(acc, (a, b, t))


def _accumulate(niels, gather_idx, gather_neg, ops=C._PLAIN):
    """S rounds of lane-parallel mixed adds, through `ops`' field routes.

    niels: (ypx, ymx, t2d) each (22, M): all points + identity sentinel.
    gather_idx: (S, WK) int32 into M; gather_neg: (S, WK) bool.
    Returns extended-coordinate accumulators, 4 x (22, WK).
    """
    acc = C.identity(gather_idx.shape[1], gather_idx.device)
    for s in range(gather_idx.shape[0]):
        acc = _gather_madd(ops, acc, niels, gather_idx[s].long(), gather_neg[s])
    return acc


def _weight_step(ops, acc, weights):
    """[w]acc per lane, w < 2^C_BITS: the top bit selects acc or the
    identity, then a double-and-add (dbl, add, select) over the other
    C_BITS - 1 bits, as the reference kernel's `_finish` does."""
    ident = C.identity(acc[0].shape[1], acc[0].device)
    top = ((weights >> (C_BITS - 1)) & 1) != 0
    r = tuple(F.select(top, a, i) for a, i in zip(acc, ident))
    for bit in range(C_BITS - 2, -1, -1):
        r = ops.dbl(r)
        radd = ops.add(r, acc)
        sel = ((weights >> bit) & 1) != 0
        r = tuple(F.select(sel, ra, rr) for ra, rr in zip(radd, r))
    return r


def accumulate_weighted_plain(niels, gather_idx, gather_neg, weights):
    """Plain PyTorch version of the `accum_weight` kernel (reference
    `_accum_weight_kernel`) on any device: `_accumulate` then the per-lane
    weight step, through the plain field routes. weights: (WK,) or
    (N_REGIONS, K_BUCKETS) int32. Returns (4, 22, WK) loose limbs."""
    acc = _accumulate(niels, gather_idx, gather_neg)
    return torch.stack(_weight_step(C._PLAIN, acc, weights.reshape(-1).to(torch.int32)))


def accumulate_weighted(niels, gather_idx, gather_neg, weights):
    """Weighted per-lane bucket points [w_l](sum of lane l's gathered
    points), stacked (4, 22, WK). One `accum_weight` launch on CUDA tensors
    (canonical limbs); `accumulate_weighted_plain` on CPU tensors."""
    if F.on_gpu(gather_idx):
        return K.accum_weight(
            tuple(c.contiguous() for c in niels),
            gather_idx.to(torch.int32).contiguous(),
            gather_neg.to(torch.int32).contiguous(),
            weights.reshape(-1).to(torch.int32).contiguous(),
        )
    return accumulate_weighted_plain(niels, gather_idx, gather_neg, weights)


def region_tree_sum_plain(weighted, ops=C._PLAIN):
    """Plain PyTorch version of the `region_sum` kernel (the reference's
    `_region_tree_sum`) on any device, through `ops`' field routes: a
    pairwise tree over the K axis of each region, lane i plus lane
    i + half at each level. (4, 22, R * K_BUCKETS) -> (4, 22, R)."""
    pts = tuple(x.reshape(F.NLIMBS, -1, K_BUCKETS) for x in weighted)
    regions = pts[0].shape[1]
    k = K_BUCKETS
    while k > 1:
        half = k // 2
        p = tuple(x[..., :half].reshape(F.NLIMBS, -1) for x in pts)
        q = tuple(x[..., half : 2 * half].reshape(F.NLIMBS, -1) for x in pts)
        s = ops.add(p, q)
        pts = tuple(x.reshape(F.NLIMBS, regions, half) for x in s)
        k = half
    return torch.stack([x[..., 0] for x in pts])


def region_tree_sum(weighted):
    """Region sums of the weighted lanes, (4, 22, WK) -> (4, 22, N_REGIONS).
    One `region_sum` launch on a CUDA tensor (the stack `accum_weight`
    returned; canonical limbs); `region_tree_sum_plain` on a CPU tensor."""
    if F.on_gpu(weighted):
        return K.region_sum(weighted)
    return region_tree_sum_plain(weighted)


def window_combine_plain(win_sums, ops=C._PLAIN):
    """Plain PyTorch version of the `window_combine` kernel (the
    reference's `_window_combine`) on any device, through `ops`' field
    routes: Horner over regions (ordered by descending weight),
    REGION_DBL[r] doublings, then fold region r's sum in. Regions that
    share a window (the z/m split) get 0 doublings between them.

    win_sums: extended coords (4, 22, N_REGIONS). Returns (4, 22, 1)."""
    acc = C.identity(1, win_sums[0].device)
    for r, n_dbl in enumerate(REGION_DBL):
        for _ in range(n_dbl):
            acc = ops.dbl(acc)
        acc = ops.add(acc, tuple(x[:, r : r + 1] for x in win_sums))
    return torch.stack(acc)


def window_combine(win_sums):
    """The MSM's total, (4, 22, N_REGIONS) -> (4, 22, 1). One
    `window_combine` launch on a CUDA tensor (canonical limbs);
    `window_combine_plain` on a CPU tensor."""
    if F.on_gpu(win_sums):
        return K.window_combine(win_sums.contiguous())
    return window_combine_plain(win_sums)


def expand_stream(stream, stream_neg, counts, s_rounds: int):
    """Dense contribution stream -> (S, WK) gather table, on the device.

    stream: (L,) uint16/uint32 (or any integer tensor) point indices: the
    first C entries are the contributions, every trailing slot holds the
    identity sentinel, and invalid gathers target L-1; stream_neg:
    bit-packed signs over the full padded length (L/8 uint8); counts:
    (WK,) with sum(counts) = C. Returns (idx int32 (S, WK), neg bool).
    """
    dev = stream.device
    counts = counts.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix
    rounds = torch.arange(s_rounds, dtype=torch.int64, device=dev)[:, None]
    valid = rounds < counts[None, :]
    pos = torch.where(valid, offsets[None, :] + rounds, stream.shape[0] - 1)
    idx = stream.to(torch.int64)[pos].to(torch.int32)
    negb = stream_neg.to(torch.int64)[pos >> 3]
    neg = ((negb >> (pos & 7)) & 1) != 0
    return idx, neg & valid  # padding gathers the identity, sign irrelevant


def rlc_verify(a_bytes, r_bytes, live, gather_idx, gather_neg, weights, c_digits):
    """One-scalar RLC batch verification.

    a_bytes, r_bytes: (B, 32) uint8 encodings.
    live: (B,) bool: padding and skipped lanes excluded from the
          decompression check (their z_i are zero host-side, so they
          never enter the sum).
    gather_idx: (S, WK) int32: point index per round per bucket lane;
          R_i at i, A_i at B+i, identity sentinel at 2B.
    gather_neg: (S, WK) bool: effective sign (digit sign pre-negated
          host-side to absorb the -R, -A in the equation).
    weights: (W, K) int32 per-lane digit weights (host layout).
    c_digits: (64, 1) int32 signed nibble digits of c = sum z_i s_i.

    Returns a scalar bool tensor on the device: the whole batch verifies.
    """
    ok_a, a_pt = C.decompress(a_bytes)
    ok_r, r_pt = C.decompress(r_bytes)
    # affine niels (Z = 1 after decompress): (Y+X, Y-X, 2dT)
    na, nr = C.to_niels(a_pt)[:3], C.to_niels(r_pt)[:3]
    ident = _identity_niels(1, a_bytes.device)
    niels = tuple(torch.cat([r_c, a_c, i_c], dim=1) for r_c, a_c, i_c in zip(nr, na, ident))

    weighted = accumulate_weighted(niels, gather_idx, gather_neg, weights)
    msm = window_combine(region_tree_sum(weighted))
    # [8](msm + [c]B) = [8]([c]B + [0]A - R) with A the identity, R = -msm
    X, Y, Z = C.ladder_sub_mul8(c_digits, torch.zeros_like(c_digits),
                                C.identity(1, a_bytes.device), C.neg(msm))
    # the identity test, X == 0 and Y == Z, as one freeze of two lanes, not
    # three: each freeze is some 370 small kernels on the card
    ok_eq = torch.all(F.is_zero(torch.cat([X, F.sub(Y, Z)], dim=1)))
    ok_points = torch.all(ok_a | ~live) & torch.all(ok_r | ~live)
    return ok_eq & ok_points


def rlc_verify_stream(a_bytes, r_bytes, live, stream, stream_neg, counts, weights, c_digits,
                      *, s_rounds: int):
    """rlc_verify over the compact wire format: the (S, WK) table is
    expanded on the device (expand_stream) from the dense contribution
    stream, so the host->device copy carries ~2 B per contribution."""
    gather_idx, gather_neg = expand_stream(stream, stream_neg, counts, s_rounds)
    return rlc_verify(a_bytes, r_bytes, live, gather_idx, gather_neg, weights, c_digits)
