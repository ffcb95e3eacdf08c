// Extended-coordinate edwards25519 point formulas for one lane per thread,
// shared by every kernel that does point arithmetic (curve_kernels.cu,
// msm_kernels.cu). The formulas and their order are those of
// cometbft_tpu/ops/curve.py (add-2008-hwcd-3 and dbl-2008-hwcd, a = -1),
// so a kernel built from them agrees with the plain PyTorch versions
// (cometbft_tpu_torch/ops/curve.py) after canonicalization.

#pragma once

#include "field25519.cuh"

namespace f25519 {

struct ge {
  fe X, Y, Z, T;
};

// The shared tail of add, add_niels and madd (add-2008-hwcd-3, a = -1).
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

// Extended + cached niels point (Y+X, Y-X, 2dT, 2Z) (curve.add_niels). 8 products.
__device__ __forceinline__ void ge_add_niels(ge& r, const fe& ypx, const fe& ymx, const fe& t2d,
                                             const fe& z2) {
  const fe a = fe_mul(fe_sub(r.Y, r.X), ymx);
  const fe b = fe_mul(fe_add(r.Y, r.X), ypx);
  const fe c = fe_mul(r.T, t2d);
  const fe d = fe_mul(r.Z, z2);
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

__device__ __forceinline__ ge load_ge(const int32_t* p4, int64_t lane, int64_t batch) {
  ge r;
  r.X = load_fe(p4, lane, batch);
  r.Y = load_fe(p4 + 1 * NLIMBS12 * batch, lane, batch);
  r.Z = load_fe(p4 + 2 * NLIMBS12 * batch, lane, batch);
  r.T = load_fe(p4 + 3 * NLIMBS12 * batch, lane, batch);
  return r;
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

}  // namespace f25519
