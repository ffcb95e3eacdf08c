// Extended-coordinate edwards25519 point formulas, shared by every kernel
// that does point arithmetic (curve_kernels.cu, msm_kernels.cu). The
// formulas and their order are those of cometbft_tpu/ops/curve.py
// (add-2008-hwcd-3 and dbl-2008-hwcd, a = -1), so a kernel built from them
// agrees with the plain PyTorch versions (cometbft_tpu_torch/ops/curve.py)
// after canonicalization.
//
// Two forms: one lane per thread (ge_*, used by msm_kernels.cu), and one
// lane per group of four threads (grp_*, used by the ladder; see the
// section below).

#pragma once

#include "field25519.cuh"

namespace f25519 {

struct ge {
  fe X, Y, Z, T;
};

// The shared tail of add and madd (add-2008-hwcd-3, a = -1).
__device__ __forceinline__ void ge_efgh_out(ge& r, const fe& a, const fe& b, const fe& c,
                                            const fe& d) {
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
}

// Complete unified addition r + q (curve.add). 9 products.
__device__ __forceinline__ void ge_add(ge& r, const ge& q) {
  const fe a = fe_mul(fe_sub(r.Y, r.X), fe_sub(q.Y, q.X));
  const fe b = fe_mul(fe_add(r.Y, r.X), fe_add(q.Y, q.X));
  const fe c = fe_mul(fe_mul(r.T, fe_const(D2_C)), q.T);
  const fe d = fe_mul(fe_add(r.Z, r.Z), q.Z);
  ge_efgh_out(r, a, b, c, d);
}

// Extended + affine niels point (Z2 = 1) (curve.madd). 7 products.
__device__ __forceinline__ void ge_madd(ge& r, const fe& ypx, const fe& ymx, const fe& t2d) {
  const fe a = fe_mul(fe_sub(r.Y, r.X), ymx);
  const fe b = fe_mul(fe_add(r.Y, r.X), ypx);
  const fe c = fe_mul(r.T, t2d);
  const fe d = fe_add(r.Z, r.Z);
  ge_efgh_out(r, a, b, c, d);
}

// Doubling (curve.dbl; with want_t false, curve.dbl_no_t). 7 or 8 products.
__device__ __forceinline__ void ge_dbl(ge& r, bool want_t) {
  const fe a = fe_sq(r.X);
  const fe b = fe_sq(r.Y);
  const fe zz = fe_sq(r.Z);
  const fe c = fe_add(zz, zz);
  const fe e = fe_sub(fe_sub(fe_sq(fe_add(r.X, r.Y)), a), b);
  const fe g = fe_sub(b, a);
  const fe f = fe_sub(g, c);
  const fe h = fe_neg(fe_add(a, b));
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  if (want_t) r.T = fe_mul(e, h);
}

__device__ __forceinline__ fe load_fe(const int32_t* base, int64_t lane, int64_t batch) {
  return fe_from_limbs12(base + lane, batch);
}

// cond ? p : q, coordinate by coordinate under a mask.
__device__ __forceinline__ ge ge_select(bool cond, const ge& p, const ge& q) {
  ge r;
  r.X = fe_select(cond, p.X, q.X);
  r.Y = fe_select(cond, p.Y, q.Y);
  r.Z = fe_select(cond, p.Z, q.Z);
  r.T = fe_select(cond, p.T, q.T);
  return r;
}

__device__ __forceinline__ ge ge_identity() {
  ge r;
  r.X = fe_small(0);
  r.Y = fe_small(1);
  r.Z = fe_small(1);
  r.T = fe_small(0);
  return r;
}

// ----------------------------------------------- four threads per lane
//
// The 4-way parallel formulas of Hisil, Wong, Carter and Dawson, "Twisted
// Edwards Curves Revisited" (ASIACRYPT 2008, section 4): each stage of
// dbl-2008-hwcd and add-2008-hwcd-3 has four independent products, so
// four neighbouring threads of a warp share one lane and each computes
// one product per stage. Thread q = threadIdx.x % 4 holds one coordinate
// of the lane's point, in one of two layouts:
//
//   layout A (lay 0): X, Y, Z, T on threads 0, 1, 2, 3;
//   layout B (lay 1): X, T, Z, Y on threads 0, 1, 2, 3.
//
// grp_dbl takes either layout and returns A; grp_add turns A into B and
// B into A. The operands move between the four threads with __shfl_sync
// (10 words an element): 4 exchanges per doubling, 3 per addition.
//
// The values are exactly those of the one-thread formulas: every product
// has the same operands (the final addition takes T1 * (2d T2) for
// (T1 2d) T2, the same value), so outputs agree after canonicalization.

constexpr int LANE_THREADS = 4;

// Thread q's entry of a table of four 4-bit values packed into one word.
__device__ __forceinline__ int nib(uint32_t packed, int q) {
  return (int)((packed >> (4 * q)) & 15u);
}

// v from thread `src` (0..3) of this thread's group.
__device__ __forceinline__ fe shfl4(const fe& v, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = __shfl_sync(0xffffffffu, v.v[i], src, LANE_THREADS);
  return r;
}

__device__ __forceinline__ uint32_t pick(uint32_t mask, uint32_t if_set, uint32_t if_clear) {
  return (if_set & mask) | (if_clear & ~mask);
}

// The four components of a niels point, one per thread of an addition:
// thread 0 multiplies by Y-X, thread 2 by 2Z; in layout A thread 1 by Y+X
// and thread 3 by 2dT, in layout B the other way round.
enum NielsRole { YMX = 0, YPX = 1, T2D = 2, Z2 = 3 };

__device__ __forceinline__ int niels_role(int q, int lay) {
  if (q == 0) return YMX;
  if (q == 2) return Z2;
  return (q == (lay ? 3 : 1)) ? YPX : T2D;
}

// One niels component from u (X for Y-X and Y+X, T for 2dT, Z for 2Z) and
// v = Y: a lazy combination, then one product (by 2d, else by 1), so
// every thread runs the same product and the result is reduced.
__device__ __forceinline__ fe niels_part(const fe& u, const fe& v, int role) {
  const uint32_t a = role == YMX ? 0u - 1u : (role == Z2 ? 2u : 1u);
  const uint32_t b = role <= YPX ? 1u : 0u;
  const uint32_t k = role == YMX ? 1u : 0u;
  const fe by = role == T2D ? fe_const(D2_C) : fe_small(1);
  return fe_mul(fe_lin(u, a, v, b, k), by);
}

// This thread's layout-B niels component (the form the lane table keeps)
// of a point held in layout `lay` (curve.to_niels).
__device__ __forceinline__ fe grp_niels(const fe& own, int q, int lay) {
  const int role = niels_role(q, 1);
  const int t_q = lay ? 1 : 3;
  const fe u = shfl4(own, role == T2D ? t_q : (role == Z2 ? 2 : 0));
  const fe v = shfl4(own, lay ? 3 : 1);
  return niels_part(u, v, role);
}

// Doubling (curve.dbl; curve.dbl_no_t is the same with T dropped).
//   stage 1: squares of X + Y (thread 0), Z (thread 2), and of X and Y on
//            the other two threads;
//   stage 2: e = (X+Y)^2 - X^2 - Y^2, g = Y^2 - X^2, f = g - 2 Z^2 and
//            h = -(X^2 + Y^2) on threads 0, 1, 2, 3, then the products
//            e f, g h, f g, e h, each thread fetching its second factor.
__device__ __forceinline__ fe grp_dbl(const fe& own, int q, int lay) {
  const int y_q = lay ? 3 : 1;  // holds Y, squares it
  const int x_q = lay ? 1 : 3;  // fetches X, squares it
  const fe x = shfl4(own, q == 0 ? y_q : (q == x_q ? 0 : q));
  const fe s = fe_sq(fe_lin(own, q == x_q ? 0u : 1u, x, (q == 0 || q == x_q) ? 1u : 0u, 0u));
  const fe xx = shfl4(s, x_q);
  const fe yy = shfl4(s, y_q);
  // coefficient of this thread's square and of Y^2; each line adds 4p and
  // takes one round of carries, which leaves it lazy (a product operand)
  const uint32_t c_own = q == 0 ? 1u : (q == 2 ? 0u - 2u : 0u);
  const uint32_t c_yy = (q == 1 || q == 2) ? 1u : 0u - 1u;
  fe m;
#pragma unroll
  for (int i = 0; i < NL; ++i) m.v[i] = c_own * s.v[i] + c_yy * yy.v[i] - xx.v[i] + 2u * two_p(i);
  m = carry_once(m);
  return fe_mul(m, shfl4(m, nib(0x0132u, q)));  // f, h, g, e from threads 2, 3, 1, 0
}

// Addition of a niels point (curve.add_niels; curve.madd is the same with
// 2Z2 = 2), this thread's component `opnd` (niels_role(q, lay)), the
// point negated when `neg` (0 or 1, a secret digit's sign) is 1.
//   stage 1: a = (Y-X) * ymx on thread 0, b = (Y+X) * ypx on its mate,
//            c = T * t2d, d = Z * z2;
//   stage 2: mates swap a/b and c/d; e = b - a, h = b + a, g = d + c and
//            f = d - c; then e f, e h, f g, g h as in grp_dbl.
// The negation is never a branch or an address: the reference swaps Y+X
// and Y-X and negates 2dT; here the same products come from -(-r + q)
// (r = (X, Y, Z, T) -> (-X, Y, Z, -T)), whose signs are coefficients of
// the lazy combinations, so every thread reads the same component of the
// table whatever the sign.
__device__ __forceinline__ fe grp_add(const fe& own, int q, int lay, const fe& opnd,
                                      uint32_t neg) {
  const int mate = q ^ (lay ? 3 : 1);
  const bool is_b = q == (lay ? 3 : 1);
  const uint32_t nm = 0u - neg;
  const uint32_t M1 = 0u - 1u;
  uint32_t a1 = 1u, b1 = 0u, k1 = 0u;  // c and d threads: own alone
  if (q == 0) {                        // Y - X, negated r: Y + X
    a1 = pick(nm, 1u, M1);
    b1 = 1u;
    k1 = pick(nm, 0u, 1u);
  } else if (is_b) {                   // Y + X, negated r: Y - X
    b1 = pick(nm, M1, 1u);
    k1 = pick(nm, 1u, 0u);
  }
  const fe p = fe_mul(fe_lin(own, a1, shfl4(own, mate), b1, k1), opnd);

  uint32_t a2 = 1u, b2 = 1u, k2 = 0u;  // b thread: h = b + a
  if (q == 0) {                        // e = b - a; -e when negated
    a2 = pick(nm, 1u, M1);
    b2 = pick(nm, M1, 1u);
    k2 = 1u;
  } else if (q == 2) {                 // f = d - c; d + c when negated
    b2 = pick(nm, 1u, M1);
    k2 = pick(nm, 0u, 1u);
  } else if (!is_b) {                  // g = d + c; d - c when negated
    a2 = pick(nm, M1, 1u);
    k2 = pick(nm, 1u, 0u);
  }
  const fe m = fe_lin(p, a2, shfl4(p, mate), b2, k2);
  // layout A -> B: e f on 0, e h on 1, f g on 2, g h on 3;
  // layout B -> A: e f on 0, g h on 1, f g on 2, e h on 3
  return fe_mul(m, shfl4(m, nib(lay ? 0x0132u : 0x1302u, q)));
}

}  // namespace f25519
