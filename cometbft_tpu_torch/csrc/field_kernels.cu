// Standalone elementwise field multiply and square, one lane per thread.
//
// Replaces cometbft_tpu/ops/field.py:_mul_kernel and :_sq_kernel (launched
// by _pallas_binop, reached through field.mul / field.sq): the 22x22-limb
// schoolbook product mod 2^255 - 19 of (22, B) int32 loose limbs, folded
// back to the loose invariant.
//
// Bound on the H100: bytes. Each lane reads 176 B (88 for sq), writes 88 B
// and does one field product, 100 wide integer multiplies (55 for sq) plus
// the radix conversions at both ends; at B = 10,240 the bytes take about
// 0.8 us and the multiplies under 0.1 us, and a launch's fixed cost
// exceeds both.
// Design: reads and writes are limb-major (limb j of lane l at j * B + l),
// so a warp touches 32 neighbouring words per limb; the product is
// computed in radix 2^25.5 (field25519.cuh) and written back canonical.
// 64-thread blocks: a 10,240-lane launch gives 160 blocks, so each of the
// 132 SMs gets work (256-thread blocks gave 40).

#include "field25519.cuh"

using namespace f25519;

namespace {

constexpr int THREADS = 64;

__global__ void fe_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int64_t batch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const fe x = fe_from_limbs12(a + lane, batch);
  const fe y = fe_from_limbs12(b + lane, batch);
  fe_to_limbs12(out + lane, batch, fe_mul(x, y));
}

__global__ void fe_sq_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                             int64_t batch) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const fe x = fe_from_limbs12(a + lane, batch);
  fe_to_limbs12(out + lane, batch, fe_sq(x));
}

unsigned blocks_for(int64_t batch) { return (unsigned)((batch + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int fe_mul_launch(const void* a, const void* b, void* out, int64_t batch,
                             void* stream) {
  fe_mul_kernel<<<blocks_for(batch), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int fe_sq_launch(const void* a, void* out, int64_t batch, void* stream) {
  fe_sq_kernel<<<blocks_for(batch), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
