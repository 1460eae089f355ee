// Device functions shared by the gsrb_relax pass kernel (csrc/gsrb_relax.cu)
// and the towers' colour passes (csrc/tower.cu): the folded red-black
// Gauss-Seidel update of ONE cell. The state is read through `get(q)`, u at
// the linear index q: the level array itself for a pass in place, or a
// fresh state that the tower's first pass of a depth writes out whole.
// Indices are of type I: long long for a whole level of any size, int in
// the towers, whose depths fit the L2 cache. PER says which axes are
// periodic when the caller knows it: 1 every axis, 0 none, -1 read
// p.periodic (a branch the compiler resolves by computing both forms).
#pragma once

#include "mg_kernels.h"

// One axis of the folded update: adds (weight_plus * u_plus + weight_minus *
// u_minus) to acc and the c0 feed-through of a face to c_sum. One load each
// way, whatever the axis: across a periodic face the wrapped neighbour,
// across another face the cell itself, which the weight 0 there masks.
template <typename T, typename I, int PER, typename Get>
__device__ __forceinline__ void fold_axis(const Get& get, I idx, int i, int n,
                                          I stride, bool periodic_axis, T c0lo,
                                          T c1lo, T c0hi, T c1hi, T P, T& acc,
                                          T& c_sum) {
  const bool periodic = PER < 0 ? periodic_axis : PER == 1;
  const bool is_lo = i == 0, is_hi = i == n - 1;
  const T up = get(is_hi ? (periodic ? idx - (I)(n - 1) * stride : idx)
                         : idx + stride);
  const T um = get(is_lo ? (periodic ? idx + (I)(n - 1) * stride : idx)
                         : idx - stride);
  if (periodic) {
    acc = acc + P * (up + um);
    return;
  }
  fold_terms<T>(up, um, is_lo, is_hi, c0lo, c1lo, c0hi, c1hi, P, acc, c_sum);
}

// The new value of cell (i, j, k) at linear index idx, from a = av, rhs = rv
// and b (null: constant bCoef = 1). FAST: 1/diag by recip() (within an ulp
// of the quotient; the towers), else by division (gsrb_relax).
template <typename T, typename I, bool FAST = false, int PER = -1,
          typename Get>
__device__ __forceinline__ T gsrb_cell(const Get& get, T av, T rv,
                                       const T* b, const LevelParams<T>& p,
                                       int i, int j, int k, I idx) {
  const T diag = p.alpha * av + p.six_b_inv;
  const T lam = FAST ? recip(diag) : (T)1 / diag;
  T P = lam * p.b_inv;
  if (b != nullptr) P = P * b[idx];

  const I sy = p.nz, sx = (I)p.ny * p.nz;
  const T uc = get(idx);
  T nb = (T)0;      // neighbour part of the update
  T c_sum = (T)0;   // c0 feed-through of the faces this cell touches
  fold_axis<T, I, PER>(get, idx, i, p.nx, sx, p.periodic[0], p.c0[0][0],
                  p.c1[0][0], p.c0[0][1], p.c1[0][1], P, nb, c_sum);
  fold_axis<T, I, PER>(get, idx, j, p.ny, sy, p.periodic[1], p.c0[1][0],
                  p.c1[1][0], p.c0[1][1], p.c1[1][1], P, nb, c_sum);
  fold_axis<T, I, PER>(get, idx, k, p.nz, (I)1, p.periodic[2], p.c0[2][0],
                  p.c1[2][0], p.c0[2][1], p.c1[2][1], P, nb, c_sum);
  const T k_uc = ((T)1 - lam * (p.alpha * av)) + P * (c_sum - (T)6);
  return (k_uc * uc + lam * rv) + nb;
}
