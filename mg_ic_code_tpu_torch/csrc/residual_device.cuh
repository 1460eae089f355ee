// Device function shared by the residual kernel and the tower's fused
// residual-and-restrict kernel: the residual of ONE cell,
//     rhs - (alpha * a * u - beta * b / dx^2 * lap u),
// with the homogeneous ghost rule (c0 * u0 + c1 * u1) standing in for the
// neighbour across a non-periodic face and wrap-around on a periodic axis.
#pragma once

#include "mg_kernels.h"

template <typename T>
__device__ __forceinline__ T axis_neighbour_sum(const T* __restrict__ u,
                                                long long idx, int i, int n,
                                                long long stride, bool periodic,
                                                T c0lo, T c1lo, T c0hi, T c1hi) {
  T up, um;
  if (periodic) {
    up = u[i + 1 < n ? idx + stride : idx - (long long)(n - 1) * stride];
    um = u[i > 0 ? idx - stride : idx + (long long)(n - 1) * stride];
  } else {
    const T uc = u[idx];
    up = (i == n - 1) ? c0hi * uc + c1hi * u[idx - stride] : u[idx + stride];
    um = (i == 0) ? c0lo * uc + c1lo * u[idx + stride] : u[idx - stride];
  }
  return up + um;
}

template <typename T>
__device__ __forceinline__ T cell_residual(const T* __restrict__ u,
                                           const T* __restrict__ rhs,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           const LevelParams<T>& p, int i,
                                           int j, int k) {
  const long long sy = p.nz, sx = (long long)p.ny * p.nz;
  const long long idx = i * sx + j * sy + k;
  const T s0 = axis_neighbour_sum<T>(u, idx, i, p.nx, sx, p.periodic[0],
                                     p.c0[0][0], p.c1[0][0], p.c0[0][1], p.c1[0][1]);
  const T s1 = axis_neighbour_sum<T>(u, idx, j, p.ny, sy, p.periodic[1],
                                     p.c0[1][0], p.c1[1][0], p.c0[1][1], p.c1[1][1]);
  const T s2 = axis_neighbour_sum<T>(u, idx, k, p.nz, 1, p.periodic[2],
                                     p.c0[2][0], p.c1[2][0], p.c0[2][1], p.c1[2][1]);
  const T uc = u[idx];
  const T lap = (s0 + (s1 + s2)) - (T)6 * uc;
  T b_inv = p.b_inv;
  if (b != nullptr) b_inv = b_inv * b[idx];
  return rhs[idx] - (p.alpha * a[idx] * uc - b_inv * lap);
}
