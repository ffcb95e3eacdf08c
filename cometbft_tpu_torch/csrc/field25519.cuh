// GF(2^255 - 19) arithmetic, shared by every kernel.
//
// Inside a kernel an element is ten unsigned limbs in radix 2^25.5
// (ref10's layout: limb i holds bits [off(i), off(i+1)), widths 26, 25,
// 26, 25, ...) and products are 32x32->64-bit multiplies. The reference's
// 12-bit radix (cometbft_tpu/ops/field.py) exists because the TPU VPU has
// no 64-bit accumulate; Hopper has one, so a field product here is 100
// wide multiplies (55 for a square) instead of 484 narrow ones.
//
// At a kernel's boundary elements are the reference's (22, B) int32 limbs
// with the batch on the trailing axis (limb j of lane l at j * B + l).
// fe_from_limbs12 accepts the loose invariant (limbs in [0, 2^14)) and
// fe_to_limbs12 writes the canonical representative, which satisfies it.
//
// Limb bounds (walked limb by limb with Python ints at these extremes by
// tests/test_torch_field_bounds.py; all values stay non-negative):
//
//   reduced (what carry32, carry64 and so every mul, sq, add, sub and neg
//   return): even limbs < 2^26; odd limbs < 2^25, except limbs 1 and 5,
//   which take the last carries and stay below 2^25 + 2^11. The carry is
//   ref10's order, two interleaved chains (0->1->2->3->4->5 and
//   4->5->6->7->8->9->0, then 0->1 once more), so its dependency chain is
//   7 steps, not 11.
//
//   lazy (what fe_lin returns without a carry, and what fe_mul and fe_sq
//   accept): limb i <= reduced_i + 2p_i, i.e. the sum, or the difference
//   plus 2p, of two reduced elements, or carry_once of limbs below 2^29. Then 19 * limb < 2^31.84 and
//   4 * odd limb < 2^28.6 stay in 32 bits, and every product column sums
//   to less than 2^62.2 before its carry.
//
// sub and neg add 2p limbwise first: 2p's smallest limb, 2^26 - 2,
// exceeds every reduced limb.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f25519 {

constexpr int NL = 10;        // internal limbs
constexpr int NLIMBS12 = 22;  // boundary limbs (the reference's layout)

__host__ __device__ constexpr int off(int i) { return 25 * i + (i + 1) / 2; }
__host__ __device__ constexpr int width(int i) { return (i & 1) ? 25 : 26; }
__host__ __device__ constexpr uint32_t lmask(int i) { return (1u << width(i)) - 1u; }
__host__ __device__ constexpr int limb_of(int bit) {
  int i = 0;
  while (i + 1 < NL && off(i + 1) <= bit) ++i;
  return i;
}

// Curve constants in this radix (checked against crypto/ed25519_ref.py by
// tests/test_torch_kernels_source.py): d, 2d and sqrt(-1).
__constant__ uint32_t D_C[NL] = {0x35978a3, 0x0d37284, 0x3156ebd, 0x06a0a0e, 0x001c029,
                                 0x179e898, 0x3a03cbb, 0x1ce7198, 0x2e2b6ff, 0x1480db3};
__constant__ uint32_t D2_C[NL] = {0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052,
                                  0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67};
__constant__ uint32_t SQRTM1_C[NL] = {0x20ea0b0, 0x186c9d2, 0x08f189d, 0x035697f, 0x0bd0c60,
                                      0x1fbd7a7, 0x2804c9e, 0x1e16569, 0x004fc1d, 0x0ae0c92};

struct fe {
  uint32_t v[NL];
};

__device__ __forceinline__ fe fe_small(uint32_t x) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = 0;
  r.v[0] = x;
  return r;
}

__device__ __forceinline__ fe fe_const(const uint32_t* c) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = c[i];
  return r;
}

// 2p limbwise.
__device__ __forceinline__ uint32_t two_p(int i) {
  return i == 0 ? 2u * ((1u << 26) - 19u) : 2u * lmask(i);
}

// One carry step out of limb I (into limb I + 1; out of limb 9 into limb
// 0 times 19, since 2^255 = 19 mod p).
template <int I, typename T>
__device__ __forceinline__ void carry_step(T h[NL]) {
  const T c = h[I] >> width(I);
  h[I] &= lmask(I);
  if constexpr (I == NL - 1) {
    h[0] += 19u * c;
  } else {
    h[I + 1] += c;
  }
}

// ref10's carry: two interleaved chains, then limb 0 -> 1 again. The
// order is CARRY_ORDER; tests/test_torch_field_bounds.py reads it from
// here and walks the bounds through it.
// CARRY_ORDER = {0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0}
template <typename T>
__device__ __forceinline__ void carry_ref10(T h[NL]) {
  carry_step<0>(h);
  carry_step<4>(h);
  carry_step<1>(h);
  carry_step<5>(h);
  carry_step<2>(h);
  carry_step<6>(h);
  carry_step<3>(h);
  carry_step<7>(h);
  carry_step<4>(h);
  carry_step<8>(h);
  carry_step<9>(h);
  carry_step<0>(h);
}

// 32-bit limbs below 2^31 -> reduced.
__device__ __forceinline__ void carry32(fe& h) { carry_ref10<uint32_t>(h.v); }

// 64-bit limbs < 2^63 (product columns, boundary conversion) -> reduced.
__device__ __forceinline__ fe carry64(uint64_t h[NL]) {
  carry_ref10<uint64_t>(h);
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = (uint32_t)h[i];
  return r;
}

// One round of carries, every limb at once (the top one times 19 into
// limb 0): depth 3 instead of carry32's chain. On limbs below 2^29 the
// result is lazy, not reduced (each limb exceeds its width by at most 19
// times the carry out of limb 9).
__device__ __forceinline__ fe carry_once(const fe& h) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = h.v[i] & lmask(i);
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[(i + 1) % NL] += (i == NL - 1 ? 19u : 1u) * (h.v[i] >> width(i));
  return r;
}

__device__ __forceinline__ fe fe_add(const fe& f, const fe& g) {
  fe h;
#pragma unroll
  for (int i = 0; i < NL; ++i) h.v[i] = f.v[i] + g.v[i];
  carry32(h);
  return h;
}

__device__ __forceinline__ fe fe_sub(const fe& f, const fe& g) {
  fe h;
#pragma unroll
  for (int i = 0; i < NL; ++i) h.v[i] = f.v[i] + two_p(i) - g.v[i];
  carry32(h);
  return h;
}

__device__ __forceinline__ fe fe_neg(const fe& f) {
  fe h;
#pragma unroll
  for (int i = 0; i < NL; ++i) h.v[i] = two_p(i) - f.v[i];
  carry32(h);
  return h;
}

// a * f + b * g + k * 2p limbwise, modulo 2^32 and without a carry. The
// coefficients are small signed integers passed as uint32 (0u - 1u for
// -1), so a thread picks its combination of two elements by arithmetic,
// not by a branch. The caller keeps every true limb in [0, 2^32); the
// result of f + g or f - g + 2p on reduced inputs is lazy.
__device__ __forceinline__ fe fe_lin(const fe& f, uint32_t a, const fe& g, uint32_t b,
                                     uint32_t k) {
  fe h;
#pragma unroll
  for (int i = 0; i < NL; ++i) h.v[i] = a * f.v[i] + b * g.v[i] + k * two_p(i);
  return h;
}

// One column term, (hi:lo) += a * b, as two 32-bit multiply-adds chained
// by the carry flag (mad.lo.cc, madc.hi), which ptxas turns into one
// accumulating IMAD.WIDE. Written as a 64-bit `h += (uint64_t)a * b`,
// ptxas may instead emit the multiply and a separate 64-bit add: such a
// product ran 1.4x slower on the H100 (PERF.md). The host branch is for compiling the kernels' code on a CPU
// (tests/test_torch_kernels_host.py).
__device__ __forceinline__ void mac(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.u32 %1, %2, %3, %1;"
      : "+r"(lo), "+r"(hi)
      : "r"(a), "r"(b));
#else
  const uint64_t t = (((uint64_t)hi << 32) | lo) + (uint64_t)a * b;
  lo = (uint32_t)t;
  hi = (uint32_t)(t >> 32);
#endif
}

// Columns as (hi:lo) word pairs -> reduced, through carry64.
__device__ __forceinline__ fe carry_columns(const uint32_t lo[NL], const uint32_t hi[NL]) {
  uint64_t h[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) h[k] = ((uint64_t)hi[k] << 32) | lo[k];
  return carry64(h);
}

// Schoolbook product: 100 32x32->64 multiplies. With i + j >= 10 the term
// wraps past 2^255 (factor 19, folded into g); with i and j both odd the
// limb offsets add up to one bit more than off(i + j) (factor 2, folded
// into f). Accepts lazy inputs; returns reduced.
__device__ __forceinline__ fe fe_mul(const fe& f, const fe& g) {
  uint32_t g19[NL], f2[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    g19[i] = 19u * g.v[i];
    f2[i] = (i & 1) ? 2u * f.v[i] : f.v[i];
  }
  uint32_t lo[NL], hi[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const uint32_t fi = (i & j & 1) ? f2[i] : f.v[i];
      const uint32_t gj = (i + j >= NL) ? g19[j] : g.v[j];
      mac(lo[(i + j) % NL], hi[(i + j) % NL], fi, gj);
    }
  }
  return carry_columns(lo, hi);
}

// Dedicated square: 55 multiplies. Each cross term f_i f_j (i < j) is
// taken once with its factor 2 on the left operand (4 when both limbs are
// odd), the factor 19 of a wrapped term on the right one, so no operand
// leaves 32 bits. Accepts lazy inputs; returns reduced.
__device__ __forceinline__ fe fe_sq(const fe& f) {
  uint32_t f2[NL], f19[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    f2[i] = 2u * f.v[i];
    f19[i] = 19u * f.v[i];
  }
  uint32_t lo[NL], hi[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = i; j < NL; ++j) {
      const bool both_odd = (i & j & 1) != 0;
      uint32_t fi;
      if (i < j) {
        fi = both_odd ? 2u * f2[i] : f2[i];
      } else {
        fi = both_odd ? f2[i] : f.v[i];
      }
      const uint32_t fj = (i + j >= NL) ? f19[j] : f.v[j];
      mac(lo[(i + j) % NL], hi[(i + j) % NL], fi, fj);
    }
  }
  return carry_columns(lo, hi);
}

__device__ __forceinline__ fe fe_sqn(fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe_sq(x);
  return x;
}

// x^((p-5)/8) = x^(2^252 - 3): the reference's addition chain
// (field.py pow2523), 251 squarings and 11 multiplies.
__device__ __noinline__ fe fe_pow2523(fe x) {
  const fe x2 = fe_sq(x);
  const fe x9 = fe_mul(fe_sq(fe_sq(x2)), x);
  const fe x11 = fe_mul(x9, x2);
  const fe x31 = fe_mul(fe_sq(x11), x9);
  const fe x_10 = fe_mul(fe_sqn(x31, 5), x31);
  const fe x_20 = fe_mul(fe_sqn(x_10, 10), x_10);
  const fe x_40 = fe_mul(fe_sqn(x_20, 20), x_20);
  const fe x_50 = fe_mul(fe_sqn(x_40, 10), x_10);
  const fe x_100 = fe_mul(fe_sqn(x_50, 50), x_50);
  const fe x_200 = fe_mul(fe_sqn(x_100, 100), x_100);
  const fe x_250 = fe_mul(fe_sqn(x_200, 50), x_50);
  return fe_mul(fe_sq(fe_sq(x_250)), x);
}

// Canonical representative: limbs exactly within their widths, value < p.
__device__ __forceinline__ fe fe_canon(const fe& f) {
  fe h = f;
  // Two folded passes leave exact limbs and a value < 2^255: after the
  // first the fold adds at most 19 * 2 to limb 0, so a second carry out
  // of the top can only happen when the masked value is below 38.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      h.v[i] += c;
      c = h.v[i] >> width(i);
      h.v[i] &= lmask(i);
    }
    h.v[0] += 19u * c;
  }
  // q = 1 iff value + 19 reaches 2^255, i.e. value >= p; then subtract p
  // by adding 19 and dropping bit 255.
  uint32_t q = (h.v[0] + 19u) >> 26;
#pragma unroll
  for (int i = 1; i < NL; ++i) q = (h.v[i] + q) >> width(i);
  h.v[0] += 19u * q;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    h.v[i] += c;
    c = h.v[i] >> width(i);
    h.v[i] &= lmask(i);
  }
  return h;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  const fe x = fe_canon(a);
  const fe y = fe_canon(b);
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) d |= x.v[i] ^ y.v[i];
  return d == 0;
}

__device__ __forceinline__ uint32_t fe_parity(const fe& a) { return fe_canon(a).v[0] & 1u; }

// cond ? a : b, limb by limb under a mask (no branch on the condition).
__device__ __forceinline__ fe fe_select(bool cond, const fe& a, const fe& b) {
  const uint32_t m = 0u - (uint32_t)cond;
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = (a.v[i] & m) | (b.v[i] & ~m);
  return r;
}

// Loose 12-bit boundary limbs (src[j * stride], j < 22) -> reduced element.
__device__ __forceinline__ fe fe_from_limbs12(const int32_t* src, int64_t stride) {
  uint64_t h[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) h[i] = 0;
#pragma unroll
  for (int j = 0; j < NLIMBS12; ++j) {
    const int bit = 12 * j;
    const int i = limb_of(bit);
    h[i] += (uint64_t)(uint32_t)src[j * stride] << (bit - off(i));
  }
  return carry64(h);
}

// Element -> canonical 12-bit boundary limbs (dst[j * stride], j < 22).
__device__ __forceinline__ void fe_to_limbs12(int32_t* dst, int64_t stride, const fe& f) {
  const fe h = fe_canon(f);
#pragma unroll
  for (int j = 0; j < NLIMBS12; ++j) {
    const int bit = 12 * j;
    const int i = limb_of(bit);
    const int sh = bit - off(i);
    uint32_t v = h.v[i] >> sh;
    if (i + 1 < NL && width(i) - sh < 12) v |= h.v[i + 1] << (width(i) - sh);
    dst[j * stride] = (int32_t)(v & 0xFFFu);
  }
}

}  // namespace f25519
