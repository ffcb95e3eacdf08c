// ZIP-215 point decompression (one lane per thread) and the fused
// verification ladder (one lane per group of four threads). Point formulas
// and their order are those of cometbft_tpu/ops/curve.py, so X, Y and Z
// agree with the plain PyTorch versions (cometbft_tpu_torch/ops/curve.py)
// after canonicalization.
//
// decompress_kernel replaces cometbft_tpu/ops/curve.py:_decompress_kernel
// (launched by _decompress_pallas, reached through curve.decompress).
//   Bound on the H100: operations. 20 multiplies and 255 squarings per
//   lane (251 of them the chain of pow2523) against 92 B read and 180 B
//   written.
//   Design: straight-line per thread, pow2523 as squaring loops on the
//   dedicated 55-multiply square; the square-root checks and sign fix are
//   masked selects, not branches. One warp a block, so a 10,240-lane
//   batch gives 320 blocks and every SM gets work; the chain of squarings
//   is serial per lane, so latency, not the multiplies, sets the time.
//
// ladder_sub_mul8_kernel replaces cometbft_tpu/ops/curve.py:
// _ladder_sub_kernel (launched by _ladder_sub_mul8_pallas, reached through
// curve.ladder_sub_mul8): [8]([s]B + [k]A - R) per lane.
//   Bound on the H100: operations. 1,874 multiplies and 1,036 squarings
//   per lane against 1,480 B of inputs and outputs.
//   Design: four threads per lane (edwards25519.cuh, grp_*): each of the
//   12 product stages of a window has one product per thread, so a
//   10,240-lane commit runs 40,960 threads (1,280 warps, about 2.4 per
//   warp scheduler) and each thread keeps one coordinate, not four.
//   Each thread multiplies by one component of a table entry, so it keeps
//   only that column of the per-lane niels table of [e]A (9 entries x 10
//   words) in dynamic shared memory, word w of thread t at w * blockDim +
//   t so a warp's accesses hit 32 distinct banks; the constant BASE_NIELS
//   table, with a fourth column 2Z2 = 2, is converted once per block into
//   shared memory and read as a broadcast. Table entries are selected the
//   reference's way (_select_rows): every entry is added under a mask, so
//   the secret digit never becomes an address or a branch, and its sign
//   is a coefficient (grp_add). 64-thread blocks (16 lanes, 24 KB of
//   shared memory) give 640 blocks for a 10,240-lane commit.

#include "edwards25519.cuh"

using namespace f25519;

namespace {

// ---------------------------------------------------------------- decompress

constexpr int DECOMPRESS_THREADS = 32;  // one warp a block: 320 blocks for 10,240 lanes

__global__ void __launch_bounds__(DECOMPRESS_THREADS)
    decompress_kernel(const int32_t* __restrict__ y12, const int32_t* __restrict__ sign,
                      int32_t* __restrict__ valid_out, int32_t* __restrict__ x_out,
                      int32_t* __restrict__ t_out, int64_t batch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const fe y = load_fe(y12, lane, batch);
  const fe one = fe_small(1);
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, one);
  const fe v = fe_add(fe_mul(yy, fe_const(D_C)), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  fe x = fe_mul(fe_mul(u, v3), fe_pow2523(fe_mul(u, v7)));
  const fe vxx = fe_mul(v, fe_sq(x));
  const bool ok_direct = fe_eq(vxx, u);
  const bool ok_flip = fe_eq(vxx, fe_neg(u));
  x = fe_select(ok_flip, fe_mul(x, fe_const(SQRTM1_C)), x);
  const bool flip_sign = fe_parity(x) != (uint32_t)sign[lane];
  x = fe_select(flip_sign, fe_neg(x), x);
  const fe t = fe_mul(x, y);
  valid_out[lane] = (ok_direct || ok_flip) ? 1 : 0;
  fe_to_limbs12(x_out + lane, batch, x);
  fe_to_limbs12(t_out + lane, batch, t);
}

// ------------------------------------------------------------------- ladder

constexpr int LADDER_THREADS = 64;      // 16 lanes of LANE_THREADS threads per block
constexpr int BASE_WORDS = 9 * 4 * NL;  // BASE_NIELS and a 2Z2 = 2 column, converted
constexpr int TBL_WORDS = 9 * NL;       // per thread: its component of the lane table

// Word l of entry `entry` of this thread's table column, at
// (entry * NL + l) * blockDim + threadIdx, so a warp's accesses hit 32
// distinct banks.
__device__ __forceinline__ void tbl_store(uint32_t* tbl, int entry, const fe& v) {
#pragma unroll
  for (int l = 0; l < NL; ++l) tbl[(entry * NL + l) * blockDim.x + threadIdx.x] = v.v[l];
}

// All ones when idx == e, else zero (idx, e < 16), computed in a register
// rather than a predicate, so that each masked word costs one LOP3.
__device__ __forceinline__ uint32_t eq_mask(uint32_t idx, uint32_t e) {
  return (uint32_t)((int32_t)((idx ^ e) - 1u) >> 31);
}

// Entry `idx` (0..8) of this thread's table column, by masked sum: one
// mask is all ones and the rest zero, so an OR sums.
__device__ __forceinline__ fe tbl_select(const uint32_t* tbl, uint32_t idx) {
  fe acc = fe_small(0);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const uint32_t m = eq_mask(idx, (uint32_t)e);
#pragma unroll
    for (int l = 0; l < NL; ++l) acc.v[l] |= tbl[(e * NL + l) * blockDim.x + threadIdx.x] & m;
  }
  return acc;
}

// Entry `idx` of component `comp` of the base table, by masked sum.
__device__ __forceinline__ fe base_select(const uint32_t* base, uint32_t idx, int comp) {
  fe acc = fe_small(0);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const uint32_t m = eq_mask(idx, (uint32_t)e);
#pragma unroll
    for (int l = 0; l < NL; ++l) acc.v[l] |= base[(e * 4 + comp) * NL + l] & m;
  }
  return acc;
}

__global__ void __launch_bounds__(LADDER_THREADS)
    ladder_sub_mul8_kernel(const int32_t* __restrict__ a4, const int32_t* __restrict__ r4,
                           const int32_t* __restrict__ s_dig, const int32_t* __restrict__ k_dig,
                           const int32_t* __restrict__ base12, int32_t* __restrict__ out,
                           int64_t batch) {
  extern __shared__ uint32_t smem[];
  uint32_t* base = smem;
  uint32_t* tbl = smem + BASE_WORDS;

  // base[(e * 4 + c) * NL + l]: components Y+X, Y-X, 2dT of [e]B, then 2
  for (int idx = threadIdx.x; idx < 36; idx += blockDim.x) {
    const int e = idx / 4, c = idx % 4;
    const fe v = c < 3 ? fe_from_limbs12(base12 + (e * 3 + c) * NLIMBS12, 1) : fe_small(2);
#pragma unroll
    for (int l = 0; l < NL; ++l) base[idx * NL + l] = v.v[l];
  }
  __syncthreads();

  // Every thread of a warp takes part in the shuffles: the threads past
  // the batch's end compute the last lane again and store nothing.
  const int q = threadIdx.x % LANE_THREADS;
  const int64_t my_lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANE_THREADS;
  const bool live = my_lane < batch;
  const int64_t lane = live ? my_lane : batch - 1;
  const int64_t plane = (int64_t)NLIMBS12 * batch;

  // This thread's column of the lane table of [e]A, e = 0..8, in niels
  // form (curve.lane_table): P_{e+1} = P_e + A, the additions alternating
  // between the layouts. Each thread reads back only its own column, so
  // no barrier is needed.
  {
    const fe pa = load_fe(a4 + q * plane, lane, batch);  // layout A
    const fe n1 = grp_niels(pa, q, 0);
    const fe n1_a = shfl4(n1, nib(0x1230u, q));  // the same with 2dT and Y+X swapped
    tbl_store(tbl, 0, fe_small(q == 2 ? 2u : (q == 1 ? 0u : 1u)));  // the identity
    tbl_store(tbl, 1, n1);
    fe pk = pa;
    int lay = 0;
#pragma unroll 1
    for (int e = 2; e < 9; ++e) {
      pk = grp_add(pk, q, lay, lay ? n1 : n1_a, 0u);
      lay ^= 1;
      tbl_store(tbl, e, grp_niels(pk, q, lay));
    }
  }

  // curve._window_step: 3 dbl_no_t + dbl (all four as dbl here: the T a
  // doubling computes is not read), signed base madd (layout A -> B),
  // signed lane add (B -> A).
  fe r = fe_small((q == 1 || q == 2) ? 1u : 0u);  // the identity, layout A
  const int base_comp = nib(0x2301u, q);          // Y-X, Y+X, 2, 2dT
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    const int ws = s_dig[w * batch + lane];
    const int wk = k_dig[w * batch + lane];
#pragma unroll 1
    for (int i = 0; i < 4; ++i) r = grp_dbl(r, q, 0);
    r = grp_add(r, q, 0, base_select(base, (uint32_t)(ws < 0 ? -ws : ws), base_comp),
                (uint32_t)(ws < 0));
    r = grp_add(r, q, 1, tbl_select(tbl, (uint32_t)(wk < 0 ? -wk : wk)), (uint32_t)(wk < 0));
  }

  // r + (-R) (curve.add with neg(R)) as a negated addition of R's niels
  // form, then [8] by three doublings without T.
  {
    const int role = niels_role(q, 0);
    const int u_coord = role == T2D ? 3 : (role == Z2 ? 2 : 0);
    const fe u = load_fe(r4 + u_coord * plane, lane, batch);
    const fe v = load_fe(r4 + plane, lane, batch);
    r = grp_add(r, q, 0, niels_part(u, v, role), 1u);
  }
#pragma unroll 1
  for (int i = 0; i < 3; ++i) r = grp_dbl(r, q, i == 0 ? 1 : 0);

  if (live && q < 3) fe_to_limbs12(out + q * plane + lane, batch, r);
}

unsigned blocks_for(int64_t batch, int threads) {
  return (unsigned)((batch + threads - 1) / threads);
}

}  // namespace

extern "C" int decompress_launch(const void* y, const void* sign, void* valid, void* x, void* t,
                                 int64_t batch, void* stream) {
  decompress_kernel<<<blocks_for(batch, DECOMPRESS_THREADS), DECOMPRESS_THREADS, 0,
                      (cudaStream_t)stream>>>((const int32_t*)y, (const int32_t*)sign,
                                              (int32_t*)valid, (int32_t*)x, (int32_t*)t, batch);
  return (int)cudaGetLastError();
}

extern "C" int ladder_sub_mul8_launch(const void* a4, const void* r4, const void* s_dig,
                                      const void* k_dig, const void* base_niels, void* out,
                                      int64_t batch, void* stream) {
  const size_t smem = sizeof(uint32_t) * (BASE_WORDS + (size_t)TBL_WORDS * LADDER_THREADS);
  ladder_sub_mul8_kernel<<<blocks_for(batch * LANE_THREADS, LADDER_THREADS), LADDER_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const int32_t*)a4, (const int32_t*)r4, (const int32_t*)s_dig, (const int32_t*)k_dig,
      (const int32_t*)base_niels, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
