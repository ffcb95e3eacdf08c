// Fused bucket accumulation and per-lane weighting of the RLC/MSM route,
// one bucket lane per group of four threads.
//
// accum_weight_kernel replaces cometbft_tpu/ops/msm.py:_accum_weight_kernel
// (launched by _accumulate_weighted_pallas, reached through rlc_verify).
// For each of the WK bucket lanes it folds S gathered affine niels points
// into an extended accumulator (curve.madd), then multiplies the
// accumulator by the lane's bucket weight w < 2^10: the top bit selects
// it or the identity, and 9 rounds of dbl, add and a select follow (the
// reference's _finish). Padded rounds gather the identity sentinel and
// are applied like any other: they leave the point but scale its
// coordinates, so the output agrees with the plain version
// (ops/msm.py accumulate_weighted_plain) exactly after canonicalization.
//
//   Bound on the H100: operations. 7 S + 153 field products per lane (601
//   at S = 64) against 264 B of table and 8 B of gather row read per
//   round, 4 B of weight and 352 B of output; the niels table (M points)
//   is read at random but fits in L2 (5.4 MB for a 10,240 bucket).
//   Design: four threads per lane with the ladder's 4-way formulas
//   (edwards25519.cuh, grp_*), so a round is 2 product stages of one
//   product per thread, not 7 products in a row, and WK = 19,968 lanes
//   give 79,872 threads: about 605 an SM, all resident at once at 92
//   registers, where one thread a lane gave the 132 SMs 156 blocks, two
//   on 24 of them. Each round is a grp_add of the gathered point, each
//   thread multiplying by its own niels component (Y-X on thread 0, the
//   constant 2Z2 = 2 on thread 2, Y+X and 2dT on threads 1 and 3 by turns
//   as the layout alternates), the sign a coefficient of grp_add, never
//   an address. The thread reads its gather row and its 88-byte component
//   (of the point-major (M, 3, 22) table, which the wrapper lays out so
//   that one point is 264 contiguous bytes) when the round starts: with
//   some 19 warps an SM the others hide the latency, and loading them a
//   round ahead, in registers or by cp.async into shared memory, measured
//   slower (PERF.md). The weight step takes the accumulator's niels
//   form once (grp_niels) and then runs grp_dbl and grp_add a bit, the
//   sum brought back to layout A by one shuffle so that the select
//   compares like with like. Every shuffle needs the whole warp, so
//   threads past the last lane compute it again and store nothing.
//
// region_sum_kernel and window_combine_kernel replace the field products
// that the reference's XLA tail runs after the weighted lanes:
// cometbft_tpu/ops/field.py:_mul_kernel and :_sq_kernel, as launched from
// cometbft_tpu/ops/msm.py:_region_tree_sum (:206) and _window_combine
// (:322). The reference fuses that tail into one XLA program; run eagerly
// it is one launch per field product (4,768 a commit, most of them one
// lane wide), so here each step is one kernel.
//
// region_sum_kernel: the pairwise tree over each region's K_BUCKETS lanes
// (ops/msm.py region_tree_sum_plain), lane i plus lane i + half for half =
// 256, 128, ..., 1, each addition add-2008-hwcd-3 (ge_add), so the sums
// agree with the plain version after canonicalization.
//   Bound on the H100: bytes. 39 regions x 511 additions x 9 products
//   (179,361 products, 100 wide multiplies each: 1.07 us) against the 7.03
//   MB of weighted lanes read once (2.10 us at 3.35 TB/s).
//   Design: one block of SUM_THREADS = 256 threads per region. Each thread
//   adds its two lanes of the first level straight from device memory
//   (coalesced: neighbouring threads, neighbouring lanes), then the partial
//   sums stay in shared memory, word w of slot i at w * SUM_THREADS + i so
//   a warp's accesses hit 32 distinct banks: 256 points of 40 words, 40 KB,
//   under the 48 KB a launch may take without cudaFuncSetAttribute. Eight
//   levels follow, each halving the active threads, with a barrier between
//   levels; the chain is 9 additions deep, so latency, not the card's
//   rate, sets its time.
//
// window_combine_kernel: Horner over the regions in descending weight
// (ops/msm.py window_combine_plain): REGION_DBL[r] doublings, then region
// r added in; 250 doublings and 39 additions, one lane.
//   Bound on the H100: operations, (1,000 x 55 + 1,351 x 100) wide
//   multiplies, 0.011 us: meaningless for one dependent chain, whose floor
//   is its 578 product stages (2 per doubling, 2 per addition) times the
//   latency of one product.
//   Design: one lane on a group of four threads with the ladder's 4-way
//   formulas (edwards25519.cuh, grp_dbl / grp_add), so each doubling and
//   addition is 2 stages of one product per thread, not 8 or 9 products
//   in a row. A region's point enters as its niels form (curve.add_niels:
//   the same products as curve.add), each thread computing its own
//   component (one product) before the doublings, off the chain. grp_dbl
//   computes T, which dbl_no_t would drop, so every doubling is curve.dbl.
//   The launch is one warp (every shuffle needs all 32 threads): its
//   eight groups compute the same lane and group 0 stores it.

#include "edwards25519.cuh"

using namespace f25519;

namespace {

// accum_weight: 16 lanes of LANE_THREADS threads a block, chosen by timing
// (tools/kernel_sweep.py, PERF.md). Its __launch_bounds__ states a minimum
// of 1 block an SM: ptxas then gives it 92 registers, not the one-argument
// form's 90, and it runs faster.
constexpr int ACCUM_THREADS = 64;
constexpr int C_BITS = 10;
constexpr int NIELS_WORDS = 3 * NLIMBS12;  // one point of the (M, 3, 22) table

constexpr int K_BUCKETS = 1 << (C_BITS - 1);          // lanes per region
constexpr int SUM_THREADS = K_BUCKETS / 2;             // one first-level addition each
constexpr int SUM_SMEM_WORDS = 4 * NL * SUM_THREADS;  // one point per thread
constexpr int COMBINE_THREADS = 32;                    // one warp
constexpr int N_REGIONS = 39;

// Doublings before region r is added in (ops/msm.py REGION_DBL): 10 when
// the weight drops a window, 0 when region r shares its window with the
// region before it.
__constant__ int REGION_DBL[N_REGIONS] = {0,  10, 10, 10, 10, 10, 10, 10, 10, 10,
                                          10, 10, 10, 10, 0,  10, 0,  10, 0,  10,
                                          0,  10, 0,  10, 0,  10, 0,  10, 0,  10,
                                          0,  10, 0,  10, 0,  10, 0,  10, 0};

// Component `role` (Y+X, Y-X or 2dT: words 0, 22 and 44; not Z2) of point
// j of the (M, 3, 22) niels table, as its 12-bit limbs, loaded 8 bytes at
// a time (a point is 264 bytes, so every component starts on an 8-byte
// boundary).
__device__ __forceinline__ void load_component(int32_t raw[NLIMBS12],
                                               const int32_t* __restrict__ niels, int64_t j,
                                               int role) {
  const int word = role == YPX ? 0 : (role == YMX ? NLIMBS12 : 2 * NLIMBS12);
  const int2* src = reinterpret_cast<const int2*>(niels + j * NIELS_WORDS + word);
#pragma unroll
  for (int k = 0; k < NLIMBS12 / 2; ++k) {
    const int2 v = __ldg(src + k);
    raw[2 * k] = v.x;
    raw[2 * k + 1] = v.y;
  }
}

// Gather row s of this lane: the point's index, clamped into [0, M) for
// memory safety only (the layout never gives one outside).
__device__ __forceinline__ int64_t gather_index(const int32_t* __restrict__ idx, int64_t s,
                                                int64_t lane, int64_t lanes, int64_t points) {
  const int64_t j = idx[s * lanes + lane];
  return j < 0 ? 0 : (j >= points ? points - 1 : j);
}

__global__ void __launch_bounds__(ACCUM_THREADS, 1)
    accum_weight_kernel(const int32_t* __restrict__ niels, const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ neg, const int32_t* __restrict__ weights,
                        int32_t* __restrict__ out, int64_t points, int64_t rounds,
                        int64_t lanes) {
  const int q = threadIdx.x % LANE_THREADS;
  const int64_t my_lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANE_THREADS;
  const bool live = my_lane < lanes;
  const int64_t lane = live ? my_lane : lanes - 1;

  // Thread 2 multiplies by 2Z2 = 2 and loads nothing; the others load
  // their component under a predicate and every thread converts `raw`,
  // with no branch (a branch around the load and conversion ran 1.5%
  // slower).
  const bool reads = niels_role(q, 0) != Z2;
  int32_t raw[NLIMBS12] = {};
  fe r = fe_small((q == 1 || q == 2) ? 1u : 0u);  // the identity, layout A
  int lay = 0;
#pragma unroll 1
  for (int64_t s = 0; s < rounds; ++s) {
    const int64_t j = gather_index(idx, s, lane, lanes, points);
    if (reads) load_component(raw, niels, j, niels_role(q, lay));
    const uint32_t sign = (uint32_t)(neg[s * lanes + lane] != 0);
    const fe opnd = reads ? fe_from_limbs12(raw, 1) : fe_small(2);
    r = grp_add(r, q, lay, opnd, sign);
    lay ^= 1;
  }

  // [w] acc: the accumulator in layout A (an odd S leaves it in B), its
  // niels form with layout A's roles (grp_niels gives layout B's: 2dT
  // and Y+X swap), then the double-and-add, each sum back in layout A.
  const int swap_b = nib(0x1230u, q);
  const fe acc = lay ? shfl4(r, swap_b) : r;
  const fe acc_niels = shfl4(grp_niels(acc, q, 0), swap_b);
  const uint32_t w = (uint32_t)weights[lane];
  r = fe_select(((w >> (C_BITS - 1)) & 1u) != 0, acc, fe_small((q == 1 || q == 2) ? 1u : 0u));
#pragma unroll 1
  for (int bit = C_BITS - 2; bit >= 0; --bit) {
    r = grp_dbl(r, q, 0);
    const fe radd = shfl4(grp_add(r, q, 0, acc_niels, 0u), swap_b);
    r = fe_select(((w >> bit) & 1u) != 0, radd, r);
  }

  // thread q holds coordinate q (X, Y, Z, T)
  if (live) fe_to_limbs12(out + q * (int64_t)NLIMBS12 * lanes + lane, lanes, r);
}

// Extended point `lane` of a (4, 22, lanes) stack of limb planes.
__device__ __forceinline__ ge load_point(const int32_t* pts, int64_t lane, int64_t lanes) {
  const int64_t plane = (int64_t)NLIMBS12 * lanes;
  ge r;
  r.X = load_fe(pts, lane, lanes);
  r.Y = load_fe(pts + plane, lane, lanes);
  r.Z = load_fe(pts + 2 * plane, lane, lanes);
  r.T = load_fe(pts + 3 * plane, lane, lanes);
  return r;
}

// Coordinate c of shared-memory slot i, word w at (c * NL + w) * SUM_THREADS + i.
__device__ __forceinline__ fe smem_fe(const uint32_t* sm, int c, int i) {
  fe r;
#pragma unroll
  for (int w = 0; w < NL; ++w) r.v[w] = sm[(c * NL + w) * SUM_THREADS + i];
  return r;
}

__device__ __forceinline__ void smem_put(uint32_t* sm, int c, int i, const fe& v) {
#pragma unroll
  for (int w = 0; w < NL; ++w) sm[(c * NL + w) * SUM_THREADS + i] = v.v[w];
}

__device__ __forceinline__ ge smem_point(const uint32_t* sm, int i) {
  ge r;
  r.X = smem_fe(sm, 0, i);
  r.Y = smem_fe(sm, 1, i);
  r.Z = smem_fe(sm, 2, i);
  r.T = smem_fe(sm, 3, i);
  return r;
}

__device__ __forceinline__ void smem_put_point(uint32_t* sm, int i, const ge& p) {
  smem_put(sm, 0, i, p.X);
  smem_put(sm, 1, i, p.Y);
  smem_put(sm, 2, i, p.Z);
  smem_put(sm, 3, i, p.T);
}

// pts: (4, 22, regions * K_BUCKETS) extended points; out: (4, 22, regions),
// canonical. Block b sums region b.
__global__ void __launch_bounds__(SUM_THREADS)
    region_sum_kernel(const int32_t* __restrict__ pts, int32_t* __restrict__ out,
                      int64_t regions) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x;
  const int64_t lanes = regions * K_BUCKETS;
  const int64_t first = (int64_t)blockIdx.x * K_BUCKETS + t;
  {
    ge p = load_point(pts, first, lanes);
    ge_add(p, load_point(pts, first + SUM_THREADS, lanes));
    smem_put_point(smem, t, p);
  }
#pragma unroll 1
  for (int half = SUM_THREADS / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (t < half) {  // slots [half, 2 half) are read only, slot t written only by thread t
      ge p = smem_point(smem, t);
      ge_add(p, smem_point(smem, t + half));
      smem_put_point(smem, t, p);
    }
  }
  __syncthreads();
  if (t < 4) fe_to_limbs12(out + t * NLIMBS12 * regions + blockIdx.x, regions, smem_fe(smem, t, 0));
}

// sums: (4, 22, regions) extended points, regions <= N_REGIONS; out:
// (4, 22, 1), canonical.
__global__ void __launch_bounds__(COMBINE_THREADS)
    window_combine_kernel(const int32_t* __restrict__ sums, int32_t* __restrict__ out,
                          int64_t regions) {
  const int q = threadIdx.x % LANE_THREADS;
  const int64_t plane = (int64_t)NLIMBS12 * regions;
  fe r = fe_small((q == 1 || q == 2) ? 1u : 0u);  // the identity, layout A
  int lay = 0;
#pragma unroll 1
  for (int reg = 0; reg < regions; ++reg) {
    const int n_dbl = REGION_DBL[reg];
    const int add_lay = n_dbl > 0 ? 0 : lay;  // grp_dbl returns layout A
    // this thread's niels component of region reg's point (curve.to_niels)
    const int role = niels_role(q, add_lay);
    const int u_coord = role == T2D ? 3 : (role == Z2 ? 2 : 0);
    const fe u = load_fe(sums + u_coord * plane, reg, regions);
    const fe v = load_fe(sums + plane, reg, regions);
    const fe opnd = niels_part(u, v, role);
#pragma unroll 1
    for (int i = 0; i < n_dbl; ++i) r = grp_dbl(r, q, i == 0 ? lay : 0);
    r = grp_add(r, q, add_lay, opnd, 0u);
    lay = add_lay ^ 1;
  }
  // thread q holds X, Y, Z, T (layout A) or X, T, Z, Y (layout B)
  if (threadIdx.x < LANE_THREADS) {
    fe_to_limbs12(out + nib(lay ? 0x1230u : 0x3210u, q) * NLIMBS12, 1, r);
  }
}

}  // namespace

extern "C" int accum_weight_launch(const void* niels, const void* idx, const void* neg,
                                   const void* weights, void* out, int64_t points, int64_t rounds,
                                   int64_t lanes, void* stream) {
  const unsigned blocks = (unsigned)((lanes * LANE_THREADS + ACCUM_THREADS - 1) / ACCUM_THREADS);
  accum_weight_kernel<<<blocks, ACCUM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)niels, (const int32_t*)idx, (const int32_t*)neg, (const int32_t*)weights,
      (int32_t*)out, points, rounds, lanes);
  return (int)cudaGetLastError();
}

extern "C" int region_sum_launch(const void* pts, void* out, int64_t regions, void* stream) {
  region_sum_kernel<<<(unsigned)regions, SUM_THREADS, sizeof(uint32_t) * SUM_SMEM_WORDS,
                      (cudaStream_t)stream>>>((const int32_t*)pts, (int32_t*)out, regions);
  return (int)cudaGetLastError();
}

extern "C" int window_combine_launch(const void* sums, void* out, int64_t regions,
                                     void* stream) {
  if (regions < 1 || regions > N_REGIONS) return (int)cudaErrorInvalidValue;
  window_combine_kernel<<<1, COMBINE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sums, (int32_t*)out, regions);
  return (int)cudaGetLastError();
}
