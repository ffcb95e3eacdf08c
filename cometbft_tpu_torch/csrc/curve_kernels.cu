// ZIP-215 point decompression and the fused verification ladder, one lane
// per thread. Point formulas and their order are those of
// cometbft_tpu/ops/curve.py, so X, Y and Z agree with the plain PyTorch
// versions (cometbft_tpu_torch/ops/curve.py) after canonicalization.
//
// decompress_kernel replaces cometbft_tpu/ops/curve.py:_decompress_kernel
// (launched by _decompress_pallas, reached through curve.decompress).
//   Bound on the H100: operations. 275 field products per lane (251 of
//   them the squarings of pow2523) against 92 B read and 180 B written.
//   Design: straight-line per thread, pow2523 as squaring loops; the
//   square-root checks and sign fix are masked selects, not branches.
//
// ladder_sub_mul8_kernel replaces cometbft_tpu/ops/curve.py:
// _ladder_sub_kernel (launched by _ladder_sub_mul8_pallas, reached through
// curve.ladder_sub_mul8): [8]([s]B + [k]A - R) per lane.
//   Bound on the H100: operations. 2,910 field products per lane against
//   1,480 B of inputs and outputs.
//   Design: the per-lane niels table of [e]A (9 entries x 4 elements,
//   1,440 B) lives in dynamic shared memory, word w of thread t at
//   w * blockDim + t so a warp's accesses hit 32 distinct banks; the
//   constant BASE_NIELS table is converted once per block into shared
//   memory and read as a broadcast. Table entries are selected the
//   reference's way (_select_rows): every entry is added under a mask, so
//   the secret digit never becomes an address or a branch. 64-thread
//   blocks (93 KB of shared memory each, above the 48 KB default, so the
//   launcher opts in) give 160 blocks for a 10,240-lane commit.

#include "edwards25519.cuh"

using namespace f25519;

namespace {

// ---------------------------------------------------------------- decompress

__global__ void decompress_kernel(const int32_t* __restrict__ y12, const int32_t* __restrict__ sign,
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

constexpr int LADDER_THREADS = 64;
constexpr int BASE_WORDS = 9 * 3 * NL;  // BASE_NIELS, converted
constexpr int TBL_WORDS = 9 * 4 * NL;   // per-lane niels table

__device__ __forceinline__ void tbl_store(uint32_t* tbl, int entry, int comp, const fe& v) {
#pragma unroll
  for (int l = 0; l < NL; ++l)
    tbl[((entry * 4 + comp) * NL + l) * blockDim.x + threadIdx.x] = v.v[l];
}

__device__ __forceinline__ fe tbl_load(const uint32_t* tbl, int entry, int comp) {
  fe r;
#pragma unroll
  for (int l = 0; l < NL; ++l) r.v[l] = tbl[((entry * 4 + comp) * NL + l) * blockDim.x + threadIdx.x];
  return r;
}

// Entry `idx` (0..8) of component `comp` of the lane table, by masked sum.
__device__ __forceinline__ fe tbl_select(const uint32_t* tbl, uint32_t idx, int comp) {
  fe acc = fe_small(0);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const uint32_t m = 0u - (uint32_t)(idx == (uint32_t)e);
#pragma unroll
    for (int l = 0; l < NL; ++l)
      acc.v[l] += tbl[((e * 4 + comp) * NL + l) * blockDim.x + threadIdx.x] & m;
  }
  return acc;
}

// Entry `idx` of component `comp` of the base table, by masked sum.
__device__ __forceinline__ fe base_select(const uint32_t* base, uint32_t idx, int comp) {
  fe acc = fe_small(0);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const uint32_t m = 0u - (uint32_t)(idx == (uint32_t)e);
#pragma unroll
    for (int l = 0; l < NL; ++l) acc.v[l] += base[(e * 3 + comp) * NL + l] & m;
  }
  return acc;
}

__device__ __forceinline__ void store_niels(uint32_t* tbl, int entry, const ge& p) {
  tbl_store(tbl, entry, 0, fe_add(p.Y, p.X));
  tbl_store(tbl, entry, 1, fe_sub(p.Y, p.X));
  tbl_store(tbl, entry, 2, fe_mul(p.T, fe_const(D2_C)));
  tbl_store(tbl, entry, 3, fe_add(p.Z, p.Z));
}

__global__ void __launch_bounds__(LADDER_THREADS)
    ladder_sub_mul8_kernel(const int32_t* __restrict__ a4, const int32_t* __restrict__ r4,
                           const int32_t* __restrict__ s_dig, const int32_t* __restrict__ k_dig,
                           const int32_t* __restrict__ base12, int32_t* __restrict__ out,
                           int64_t batch) {
  extern __shared__ uint32_t smem[];
  uint32_t* base = smem;
  uint32_t* tbl = smem + BASE_WORDS;

  for (int idx = threadIdx.x; idx < 27; idx += blockDim.x) {
    const fe v = fe_from_limbs12(base12 + idx * NLIMBS12, 1);
#pragma unroll
    for (int l = 0; l < NL; ++l) base[idx * NL + l] = v.v[l];
  }
  __syncthreads();

  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;

  // Lane table of [e]A, e = 0..8, niels form (curve.lane_table).
  {
    const ge a = load_ge(a4, lane, batch);
    tbl_store(tbl, 0, 0, fe_small(1));
    tbl_store(tbl, 0, 1, fe_small(1));
    tbl_store(tbl, 0, 2, fe_small(0));
    tbl_store(tbl, 0, 3, fe_small(2));
    store_niels(tbl, 1, a);
    ge pk = a;
#pragma unroll 1
    for (int e = 2; e < 9; ++e) {
      ge_add_niels(pk, tbl_load(tbl, 1, 0), tbl_load(tbl, 1, 1), tbl_load(tbl, 1, 2),
                   tbl_load(tbl, 1, 3));
      store_niels(tbl, e, pk);
    }
  }

  ge r = ge_identity();
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    const int ws = s_dig[w * batch + lane];
    const int wk = k_dig[w * batch + lane];
    // curve._window_step: 3 dbl_no_t + dbl, signed base madd, signed lane add
#pragma unroll 1
    for (int i = 0; i < 4; ++i) ge_dbl(r, i == 3);
    {
      const uint32_t idx = (uint32_t)(ws < 0 ? -ws : ws);
      const bool negd = ws < 0;
      const fe ypx = base_select(base, idx, 0);
      const fe ymx = base_select(base, idx, 1);
      const fe t2d = base_select(base, idx, 2);
      ge_madd(r, fe_select(negd, ymx, ypx), fe_select(negd, ypx, ymx),
              fe_select(negd, fe_neg(t2d), t2d));
    }
    {
      const uint32_t idx = (uint32_t)(wk < 0 ? -wk : wk);
      const bool negd = wk < 0;
      const fe ypx = tbl_select(tbl, idx, 0);
      const fe ymx = tbl_select(tbl, idx, 1);
      const fe t2d = tbl_select(tbl, idx, 2);
      ge_add_niels(r, fe_select(negd, ymx, ypx), fe_select(negd, ypx, ymx),
                   fe_select(negd, fe_neg(t2d), t2d), tbl_select(tbl, idx, 3));
    }
  }

  // r + (-R), then [8] by three doublings without T.
  {
    ge nr = load_ge(r4, lane, batch);
    nr.X = fe_neg(nr.X);
    nr.T = fe_neg(nr.T);
    ge_add(r, nr);
  }
#pragma unroll 1
  for (int i = 0; i < 3; ++i) ge_dbl(r, false);

  fe_to_limbs12(out + lane, batch, r.X);
  fe_to_limbs12(out + 1 * NLIMBS12 * batch + lane, batch, r.Y);
  fe_to_limbs12(out + 2 * NLIMBS12 * batch + lane, batch, r.Z);
}

unsigned blocks_for(int64_t batch, int threads) {
  return (unsigned)((batch + threads - 1) / threads);
}

}  // namespace

extern "C" int decompress_launch(const void* y, const void* sign, void* valid, void* x, void* t,
                                 int64_t batch, void* stream) {
  constexpr int threads = 128;
  decompress_kernel<<<blocks_for(batch, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)y, (const int32_t*)sign, (int32_t*)valid, (int32_t*)x, (int32_t*)t, batch);
  return (int)cudaGetLastError();
}

extern "C" int ladder_sub_mul8_launch(const void* a4, const void* r4, const void* s_dig,
                                      const void* k_dig, const void* base_niels, void* out,
                                      int64_t batch, void* stream) {
  const size_t smem = sizeof(uint32_t) * (BASE_WORDS + (size_t)TBL_WORDS * LADDER_THREADS);
  cudaError_t err = cudaFuncSetAttribute(ladder_sub_mul8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ladder_sub_mul8_kernel<<<blocks_for(batch, LADDER_THREADS), LADDER_THREADS, smem,
                           (cudaStream_t)stream>>>(
      (const int32_t*)a4, (const int32_t*)r4, (const int32_t*)s_dig, (const int32_t*)k_dig,
      (const int32_t*)base_niels, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
