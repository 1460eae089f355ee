// Device functions shared by every GSRB kernel (csrc/gsrb_relax.cu: both
// one-launch forms; csrc/gsrb_sweep.cu: the one-sweep and one-pass kernels;
// csrc/tower.cu: the towers' colour passes): the folded red-black Gauss-Seidel update of ONE cell, split into
// the terms of its (i, j) row (row_fold) and the rest (gsrb_update_row), so
// that a kernel that updates several cells of one z row works the row out
// once; every caller computes the same expressions in the same order.
// gsrb_cell reads the state through `get(q)`, u at the linear index q: the
// level array itself for a pass in place, or a fresh state that the first
// pass writes out whole. Indices are of type I: long long for a whole level
// of any size, int where the level is below 2^31 cells. PER says which axes
// are periodic when the caller knows it: 1 every axis, 0 none, -1 read
// p.periodic (a branch the compiler resolves by computing both forms).
// C is the type of the colour passes' arithmetic: the storage type T
// itself, or __nv_bfloat16 beside float storage (smoother_precision =
// bfloat16: gsrb_update_row_bf16).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "mg_kernels.h"

// x as colour passes of compute type C read it: unchanged where C is the
// storage type T, else rounded to bf16 and held in T (exactly). The state
// is rounded so where it enters a relaxation: the caller's u, a prolonged
// state; every value a bf16 pass writes is a bf16 value already.
template <typename C, typename T>
__device__ __forceinline__ T as_compute(T x) {
  if constexpr (std::is_same<C, T>::value)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The neighbours of a cell along one axis, one load each way whatever the
// axis: across a periodic face the wrapped neighbour, across another face
// the cell itself (its weight 0 masks it).
template <typename T, typename I, int PER, typename Get>
__device__ __forceinline__ void axis_pair(const Get& get, I idx, int i, int n,
                                          I stride, bool periodic_axis,
                                          T& up, T& um) {
  const bool periodic = PER < 0 ? periodic_axis : PER == 1;
  const bool is_lo = i == 0, is_hi = i == n - 1;
  up = get(is_hi ? (periodic ? idx - (I)(n - 1) * stride : idx)
                 : idx + stride);
  um = get(is_lo ? (periodic ? idx + (I)(n - 1) * stride : idx)
                 : idx - stride);
}

// The terms of one non-periodic axis that depend only on the cell's index
// along it (fold_terms' weights and the c0 feed-through of a face).
template <typename T>
struct AxisFold {
  T wa, wb;     // weights of up and um: 0 across a face, 1 + c1 at it
  bool lo, hi;  // the cell is at the low / high face: its value is masked
  T c;          // c0 of the faces the cell touches
};

// The fold of a cell at the low face (lo), the high face (hi), both or
// neither: the marches pass their own face flags (a shard's x faces may be
// seams).
template <typename T>
__device__ __forceinline__ AxisFold<T> face_fold(bool lo, bool hi, T c0lo,
                                                 T c1lo, T c0hi, T c1hi) {
  const T one = (T)1;
  AxisFold<T> f;
  f.lo = lo;
  f.hi = hi;
  f.wa = f.hi ? (T)0 : (f.lo ? one + c1lo : one);
  f.wb = f.lo ? (T)0 : (f.hi ? one + c1hi : one);
  f.c = (f.lo ? c0lo : (T)0) + (f.hi ? c0hi : (T)0);
  return f;
}

template <typename T>
__device__ __forceinline__ AxisFold<T> axis_fold(int i, int n, T c0lo,
                                                 T c1lo, T c0hi, T c1hi) {
  return face_fold<T>(i == 0, i == n - 1, c0lo, c1lo, c0hi, c1hi);
}

// Adds (weight_plus * up + weight_minus * um) of one axis to acc: P * (up +
// um) across a periodic axis, else fold_terms' sum with the axis's terms.
template <typename T>
__device__ __forceinline__ void fold_axis(T up, T um, bool periodic,
                                          const AxisFold<T>& f, T P, T& acc) {
  if (periodic) {
    acc = acc + P * (up + um);
    return;
  }
  acc = acc + (P * f.wa) * (f.hi ? (T)0 : up) + (P * f.wb) * (f.lo ? (T)0 : um);
}

// The x and y terms of a cell's update, which depend on (i, j) only: the
// axes' folds and the c0 sum so far, (0 + c_x) + c_y over the non-periodic
// ones (gsrb_update adds z's).
template <typename T>
struct RowFold {
  AxisFold<T> x, y;
  bool px, py;  // the axis is periodic
  T c_xy;
};

template <typename T, int PER>
__device__ __forceinline__ RowFold<T> row_fold(const LevelParams<T>& p, int i,
                                               int j) {
  RowFold<T> r;
  r.px = PER < 0 ? p.periodic[0] != 0 : PER == 1;
  r.py = PER < 0 ? p.periodic[1] != 0 : PER == 1;
  r.x = axis_fold<T>(i, p.nx, p.c0[0][0], p.c1[0][0], p.c0[0][1],
                     p.c1[0][1]);
  r.y = axis_fold<T>(j, p.ny, p.c0[1][0], p.c1[1][0], p.c0[1][1],
                     p.c1[1][1]);
  T c_sum = (T)0;
  if (!r.px) c_sum += r.x.c;
  if (!r.py) c_sum += r.y.c;
  r.c_xy = c_sum;
  return r;
}

// The update of one cell in the bf16 tier (T float, C bf16), from its
// value uc, its neighbours (up[axis], um[axis]), a = av, rhs = rv, whether
// each axis is periodic (per), the folds of the three axes (fx, fy, fz:
// unused on a periodic axis) and c_sum, the c0 feed-through of the faces
// the cell touches, summed x, then y, then z over the non-periodic axes:
// the fold in f32, each operation rounded once as in the plain version
// (fused_sweeps.gsrb_sweeps_folded; no contraction into an fma), each folded
// term (K, lambda * rhs, P, the weights PA = P * wa and PB = P * wb of an
// open axis) rounded to bf16 once; then, in bf16 with one rounding an
// operation and in the plain version's order, acc = K * uc + T and per axis
// acc + P * (up + um) across a periodic one, else (acc + PA * up) + PB * um.
// The operations are __hmul_rn / __hadd_rn: the compiler contracts __hmul
// and __hadd into a bf16 fma (one rounding where torch rounds twice).
// uc and the neighbours hold bf16 values (as_compute), so reading them as
// bf16 is exact. The result is a bf16 value, returned in f32 exactly.
// 1/diag is the division in every kernel of the tier, the towers' too (not
// their recip()), so that each is its plain version's twin bit for bit.
// The one update of the tier: gsrb_update_row_bf16 (gsrb_relax, the towers)
// and the marches (csrc/multisweep.cu, csrc/multisweep_halo.cu) call it.
__device__ __forceinline__ float gsrb_update_bf16(
    float uc, const float (&up)[3], const float (&um)[3], float av, float rv,
    const bool (&per)[3], const AxisFold<float>& fx,
    const AxisFold<float>& fy, const AxisFold<float>& fz, float c_sum,
    float alpha, float six_b_inv, float b_inv) {
  const auto bf = [](float x) { return __float2bfloat16_rn(x); };
  const float diag = __fadd_rn(__fmul_rn(alpha, av), six_b_inv);
  const float lam = __fdiv_rn(1.0f, diag);
  const float P = __fmul_rn(lam, b_inv);
  const float k_uc =
      __fadd_rn(__fsub_rn(1.0f, __fmul_rn(lam, __fmul_rn(alpha, av))),
                __fmul_rn(P, __fsub_rn(c_sum, 6.0f)));
  __nv_bfloat16 acc =
      __hadd_rn(__hmul_rn(bf(k_uc), bf(uc)), bf(__fmul_rn(lam, rv)));
  const AxisFold<float>* fold[3] = {&fx, &fy, &fz};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const AxisFold<float>& f = *fold[ax];
    if (per[ax]) {
      acc = __hadd_rn(
          acc, __hmul_rn(bf(P), __hadd_rn(bf(up[ax]), bf(um[ax]))));
    } else {
      acc = __hadd_rn(acc, __hmul_rn(bf(__fmul_rn(P, f.wa)),
                                     bf(f.hi ? 0.0f : up[ax])));
      acc = __hadd_rn(acc, __hmul_rn(bf(__fmul_rn(P, f.wb)),
                                     bf(f.lo ? 0.0f : um[ax])));
    }
  }
  return __bfloat162float(acc);
}

// gsrb_update_bf16 of cell (i, j, k) from the row's terms rf (row_fold of
// (i, j)): the bf16 form of gsrb_update_row.
template <int PER>
__device__ __forceinline__ float gsrb_update_row_bf16(
    float uc, const float (&up)[3], const float (&um)[3], float av, float rv,
    const RowFold<float>& rf, const LevelParams<float>& p, int k) {
  const bool pz = PER < 0 ? p.periodic[2] != 0 : PER == 1;
  const AxisFold<float> z = axis_fold<float>(k, p.nz, p.c0[2][0],
                                             p.c1[2][0], p.c0[2][1],
                                             p.c1[2][1]);
  const float c_sum = pz ? rf.c_xy : rf.c_xy + z.c;
  const bool per[3] = {rf.px, rf.py, pz};
  return gsrb_update_bf16(uc, up, um, av, rv, per, rf.x, rf.y, z, c_sum,
                          p.alpha, p.six_b_inv, p.b_inv);
}

// The new value of cell (i, j, k) from its own value uc, its neighbours
// (up[axis], um[axis]: i + 1 and i - 1 along each axis, as axis_pair gives
// them), a = av, rhs = rv, bCoef = bv (with_b; else constant 1) and the
// row's terms rf (row_fold of (i, j)). FAST: 1/diag by recip() (within an
// ulp of the quotient; the towers), else by division (gsrb_relax). C: the
// arithmetic's type (gsrb_update_row_bf16 where it is not T, which divides
// whatever FAST says; constant b).
template <typename T, bool FAST, int PER, typename C = T>
__device__ __forceinline__ T gsrb_update_row(T uc, const T (&up)[3],
                                             const T (&um)[3], T av, T rv,
                                             bool with_b, T bv,
                                             const RowFold<T>& rf,
                                             const LevelParams<T>& p, int k) {
  if constexpr (!std::is_same<C, T>::value) {
    static_assert(std::is_same<T, float>::value &&
                      std::is_same<C, __nv_bfloat16>::value,
                  "the bf16 tier sweeps f32 storage");
    return gsrb_update_row_bf16<PER>(uc, up, um, av, rv, rf, p, k);
  } else {
    const T diag = p.alpha * av + p.six_b_inv;
    const T lam = FAST ? recip(diag) : (T)1 / diag;
    T P = lam * p.b_inv;
    if (with_b) P = P * bv;
    const bool pz = PER < 0 ? p.periodic[2] != 0 : PER == 1;
    T nb = (T)0;  // neighbour part of the update
    fold_axis<T>(up[0], um[0], rf.px, rf.x, P, nb);
    fold_axis<T>(up[1], um[1], rf.py, rf.y, P, nb);
    const AxisFold<T> z = axis_fold<T>(k, p.nz, p.c0[2][0], p.c1[2][0],
                                       p.c0[2][1], p.c1[2][1]);
    fold_axis<T>(up[2], um[2], pz, z, P, nb);
    // c0 feed-through of the faces this cell touches
    const T c_sum = pz ? rf.c_xy : rf.c_xy + z.c;
    const T k_uc = ((T)1 - lam * (p.alpha * av)) + P * (c_sum - (T)6);
    return (k_uc * uc + lam * rv) + nb;
  }
}

// gsrb_update_row with the row's terms worked out for the one cell.
template <typename T, bool FAST = false, int PER = -1, typename C = T>
__device__ __forceinline__ T gsrb_update(T uc, const T (&up)[3],
                                         const T (&um)[3], T av, T rv,
                                         bool with_b, T bv,
                                         const LevelParams<T>& p, int i,
                                         int j, int k) {
  return gsrb_update_row<T, FAST, PER, C>(uc, up, um, av, rv, with_b, bv,
                                          row_fold<T, PER>(p, i, j), p, k);
}

// The new value of cell (i, j, k) at linear index idx, its state read
// through get(q), from a = av, rhs = rv and b (null: constant bCoef = 1),
// in the arithmetic of C.
template <typename T, typename I, bool FAST = false, int PER = -1,
          typename C = T, typename Get>
__device__ __forceinline__ T gsrb_cell(const Get& get, T av, T rv,
                                       const T* b, const LevelParams<T>& p,
                                       int i, int j, int k, I idx) {
  const I sy = p.nz, sx = (I)p.ny * p.nz;
  T up[3], um[3];
  axis_pair<T, I, PER>(get, idx, i, p.nx, sx, p.periodic[0], up[0], um[0]);
  axis_pair<T, I, PER>(get, idx, j, p.ny, sy, p.periodic[1], up[1], um[1]);
  axis_pair<T, I, PER>(get, idx, k, p.nz, (I)1, p.periodic[2], up[2],
                       um[2]);
  return gsrb_update<T, FAST, PER, C>(get(idx), up, um, av, rv,
                                      b != nullptr,
                                      b != nullptr ? b[idx] : (T)0, p, i, j,
                                      k);
}
