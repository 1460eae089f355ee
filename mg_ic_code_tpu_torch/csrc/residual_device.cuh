// Device function of the towers' fused residual-and-restriction
// (csrc/tower.cu): the residual of ONE cell,
//     rhs - (alpha * a * u - beta * b / dx^2 * lap u),
// with the homogeneous ghost rule (c0 * u0 + c1 * u1) standing in for the
// neighbour across a non-periodic face and wrap-around on a periodic axis.
// The residual kernels (csrc/residual.cu) evaluate the same expression from
// their shared-memory planes, each rounding fixed in intrinsics as the one
// thread a cell kernel that called this function compiled it. Indices are
// of type I: int in the towers, whose depths fit the L2 cache; PER as in
// gsrb_device.cuh (1 every axis periodic, 0 none, -1 read p.periodic). The
// pointers carry no __restrict__: the towers read arrays that their own
// launch wrote before a grid barrier, which must not take the read-only
// (non-coherent) load path.
#pragma once

#include "mg_kernels.h"

// One load each way, whatever the axis: across a periodic face the wrapped
// neighbour, across another face the interior neighbour its ghost rule
// reads.
template <typename T, typename I, int PER>
__device__ __forceinline__ T axis_neighbour_sum(const T* u, I idx, int i,
                                                int n, I stride,
                                                bool periodic_axis, T c0lo,
                                                T c1lo, T c0hi, T c1hi) {
  const bool periodic = PER < 0 ? periodic_axis : PER == 1;
  const bool is_lo = i == 0, is_hi = i == n - 1;
  const T vp = u[is_hi ? (periodic ? idx - (I)(n - 1) * stride : idx - stride)
                       : idx + stride];
  const T vm = u[is_lo ? (periodic ? idx + (I)(n - 1) * stride : idx + stride)
                       : idx - stride];
  if (periodic) return vp + vm;
  const T uc = u[idx];
  const T up = is_hi ? c0hi * uc + c1hi * vp : vp;
  const T um = is_lo ? c0lo * uc + c1lo * vm : vm;
  return up + um;
}

template <typename T, typename I = long long, int PER = -1>
__device__ __forceinline__ T cell_residual(const T* u, const T* rhs,
                                           const T* a, const T* b,
                                           const LevelParams<T>& p, int i,
                                           int j, int k) {
  const I sy = p.nz, sx = (I)p.ny * p.nz;
  const I idx = i * sx + j * sy + k;
  const T s0 = axis_neighbour_sum<T, I, PER>(
      u, idx, i, p.nx, sx, p.periodic[0], p.c0[0][0], p.c1[0][0], p.c0[0][1],
      p.c1[0][1]);
  const T s1 = axis_neighbour_sum<T, I, PER>(
      u, idx, j, p.ny, sy, p.periodic[1], p.c0[1][0], p.c1[1][0], p.c0[1][1],
      p.c1[1][1]);
  const T s2 = axis_neighbour_sum<T, I, PER>(
      u, idx, k, p.nz, (I)1, p.periodic[2], p.c0[2][0], p.c1[2][0],
      p.c0[2][1], p.c1[2][1]);
  const T uc = u[idx];
  const T lap = (s0 + (s1 + s2)) - (T)6 * uc;
  T b_inv = p.b_inv;
  if (b != nullptr) b_inv = b_inv * b[idx];
  return rhs[idx] - (p.alpha * a[idx] * uc - b_inv * lap);
}
