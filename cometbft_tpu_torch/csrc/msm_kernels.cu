// Fused bucket accumulation and per-lane weighting of the RLC/MSM route,
// one bucket lane per thread.
//
// accum_weight_kernel replaces cometbft_tpu/ops/msm.py:_accum_weight_kernel
// (launched by _accumulate_weighted_pallas, reached through rlc_verify).
// For each of the WK bucket lanes it folds S gathered affine niels points
// into an extended accumulator (curve.madd, 7 products a round), then
// multiplies the accumulator by the lane's bucket weight w < 2^10: the top
// bit selects it or the identity, and 9 rounds of dbl, add and a select
// follow (the reference's _finish). Padded rounds gather the identity
// sentinel and are applied like any other: they leave the point but scale
// its coordinates, so the output agrees with the plain version
// (ops/msm.py accumulate_weighted_plain) exactly after canonicalization.
//
//   Bound on the H100: operations. 7 S + 153 field products per lane (601
//   at S = 64) against 264 B of table and 8 B of gather row read per
//   round, 4 B of weight and 352 B of output; the niels table (M points)
//   is read at random but fits in L2 (5.4 MB for a 10,240 bucket).
//   Design: the accumulator stays in registers across the S rounds (the
//   TPU kernel carries it in VMEM scratch across its grid's S axis, and
//   materializes the gathered (S * 72, WK) stream with XLA first; neither
//   is needed here). Each thread reads its own gather index per round
//   (one coalesced row load for the warp) and the 66 words of its point
//   from a point-major (M, 3, 22) table, which the wrapper lays out so
//   that one point is 264 contiguous bytes. The sign is applied the
//   reference's way: swap Y+X and Y-X and negate 2dT under a mask. One
//   thread per lane gives 19,968 threads, 156 blocks of 128 on 132 SMs:
//   occupancy, not the multiplies, is expected to limit it.

#include "edwards25519.cuh"

using namespace f25519;

namespace {

constexpr int THREADS = 128;
constexpr int C_BITS = 10;
constexpr int NIELS_WORDS = 3 * NLIMBS12;  // one point of the (M, 3, 22) table

__global__ void __launch_bounds__(THREADS)
    accum_weight_kernel(const int32_t* __restrict__ niels, const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ neg, const int32_t* __restrict__ weights,
                        int32_t* __restrict__ out, int64_t points, int64_t rounds,
                        int64_t lanes) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  ge acc = ge_identity();
#pragma unroll 1
  for (int64_t s = 0; s < rounds; ++s) {
    int64_t j = idx[s * lanes + lane];
    j = j < 0 ? 0 : (j >= points ? points - 1 : j);  // memory safety only: the layout never
                                                      // gives an index outside [0, M)
    const bool negd = neg[s * lanes + lane] != 0;
    const int32_t* p = niels + j * NIELS_WORDS;
    const fe ypx = fe_from_limbs12(p, 1);
    const fe ymx = fe_from_limbs12(p + NLIMBS12, 1);
    const fe t2d = fe_from_limbs12(p + 2 * NLIMBS12, 1);
    ge_madd(acc, fe_select(negd, ymx, ypx), fe_select(negd, ypx, ymx),
            fe_select(negd, fe_neg(t2d), t2d));
  }

  const uint32_t w = (uint32_t)weights[lane];
  ge r = ge_select(((w >> (C_BITS - 1)) & 1u) != 0, acc, ge_identity());
#pragma unroll 1
  for (int bit = C_BITS - 2; bit >= 0; --bit) {
    ge_dbl(r, true);
    ge radd = r;
    ge_add(radd, acc);
    r = ge_select(((w >> bit) & 1u) != 0, radd, r);
  }

  const int64_t plane = (int64_t)NLIMBS12 * lanes;
  fe_to_limbs12(out + lane, lanes, r.X);
  fe_to_limbs12(out + plane + lane, lanes, r.Y);
  fe_to_limbs12(out + 2 * plane + lane, lanes, r.Z);
  fe_to_limbs12(out + 3 * plane + lane, lanes, r.T);
}

}  // namespace

extern "C" int accum_weight_launch(const void* niels, const void* idx, const void* neg,
                                   const void* weights, void* out, int64_t points, int64_t rounds,
                                   int64_t lanes, void* stream) {
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  accum_weight_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)niels, (const int32_t*)idx, (const int32_t*)neg, (const int32_t*)weights,
      (int32_t*)out, points, rounds, lanes);
  return (int)cudaGetLastError();
}
