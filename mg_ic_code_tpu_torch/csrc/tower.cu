// tower_down / tower_up: the V-cycle over a chain of multigrid depths.
//
// Replace the TPU kernels mg_ic_code_tpu/ops/coarse_tower.py:
// _tower_down_call (kernel _tower_down_kernel) and _tower_up_call (kernel
// _tower_up_kernel). tower_down: per depth, nsmooth red-black sweeps, then
// the residual restricted by full weighting (mean of the 2^3 children) as
// the next depth's rhs, the next depth starting from u = 0; the bottom
// depth is pre-smoothed too. tower_up: from the bottom correction upward,
// u += e[i/2, j/2, k/2] (piecewise-constant prolongation), then nsmooth
// sweeps. The coarsest-depth solve happens between the two, outside.
//
// What bounds them on this card: launch latency, then bytes. Below the top
// depth a level is a few thousand cells, so each of the ~10 launches per
// depth costs its few microseconds of launch overhead and almost no
// device time; only the top depth moves real bytes. What the design does
// about it: the whole chain is enqueued back to back from ONE C call on
// one stream (no host round trip between depths); restriction is fused
// with the residual — a thread per COARSE cell evaluates the residual of
// its eight children from registers and writes one value, so the fine
// residual never reaches device memory; prolongation indexes the parent
// directly. The TPU kernel's 0/1 pairing matmuls (its way of regrouping
// lanes) have no counterpart: children are addressed by index.
#include "residual_device.cuh"

template <typename T>
__global__ void residual_restrict_kernel(const T* __restrict__ u,
                                         const T* __restrict__ rhs,
                                         const T* __restrict__ a,
                                         T* __restrict__ rc,
                                         const LevelParams<T> p) {
  const int cy = p.ny >> 1, cz = p.nz >> 1;
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)cy * cz) return;
  const int ci = blockIdx.y;
  const int cj = (int)(m / cz);
  const int ck = (int)(m - (long long)cj * cz);
  // pairing order of the plain version: x pairs, then z, then y
  T y_sum = (T)0;
  for (int dj = 0; dj < 2; ++dj) {
    T z_sum = (T)0;
    for (int dk = 0; dk < 2; ++dk) {
      const T r0 = cell_residual<T>(u, rhs, a, nullptr, p, 2 * ci, 2 * cj + dj, 2 * ck + dk);
      const T r1 = cell_residual<T>(u, rhs, a, nullptr, p, 2 * ci + 1, 2 * cj + dj, 2 * ck + dk);
      z_sum += (T)0.125 * (r0 + r1);
    }
    y_sum += z_sum;
  }
  rc[(long long)ci * cy * cz + m] = y_sum;
}

template <typename T>
__global__ void prolong_inc_kernel(T* __restrict__ u, const T* __restrict__ e,
                                   int nx, int ny, int nz) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)ny * nz) return;
  const int i = blockIdx.y;
  const int j = (int)(m / nz);
  const int k = (int)(m - (long long)j * nz);
  const int cy = ny >> 1, cz = nz >> 1;
  u[(long long)i * ny * nz + m] +=
      e[((long long)(i >> 1) * cy + (j >> 1)) * cz + (k >> 1)];
}

static inline dim3 plane_grid(long long per_plane, int nx, int threads) {
  return dim3((unsigned)((per_plane + threads - 1) / threads), (unsigned)nx);
}

// Down pass over depths 0..ndep-1 (depth 0 the finest of the chain).
//   u[d]   : in/out. u[0] holds the caller's start state; u[d>0] must be
//            zero on entry. On return u[d] is the pre-smoothed state.
//   rhs[d] : rhs[0] is input, rhs[d>0] are written (restricted residuals).
//   a[d]   : aCoef per depth.
//   shapes : ndep * 3 ints; dxs, rhos: ndep doubles; bases: ndep ints.
template <typename T>
static cudaError_t tower_down_impl(void* const* u, void* const* rhs,
                                   const void* const* a, int ndep,
                                   const int* shapes, const int* kinds,
                                   const double* dxs, const double* rhos,
                                   const int* bases, double alpha, double beta,
                                   int nsmooth, cudaStream_t st) {
  const int threads = 128;
  for (int d = 0; d < ndep; ++d) {
    const int nx = shapes[3 * d], ny = shapes[3 * d + 1], nz = shapes[3 * d + 2];
    auto p = make_level_params<T>(nx, ny, nz, kinds, rhos[d], alpha, beta, dxs[d]);
    cudaError_t err = launch_gsrb_relax<T>((T*)u[d], (const T*)rhs[d],
                                           (const T*)a[d], nullptr, p,
                                           bases[d], nsmooth, st);
    if (err != cudaSuccess) return err;
    if (d + 1 < ndep) {
      const long long per_plane = (long long)(ny >> 1) * (nz >> 1);
      residual_restrict_kernel<T><<<plane_grid(per_plane, nx >> 1, threads), threads, 0, st>>>(
          (const T*)u[d], (const T*)rhs[d], (const T*)a[d], (T*)rhs[d + 1], p);
    }
  }
  return cudaGetLastError();
}

// Up pass: e_bot is the solved bottom depth (depth ndep-1); for depths
// ndep-2 .. 0: u[d] += prolong(e), then nsmooth sweeps in place; the
// smoothed u[d] is the next e. The result is u[0].
template <typename T>
static cudaError_t tower_up_impl(const void* e_bot, void* const* u,
                                 const void* const* rhs, const void* const* a,
                                 int ndep, const int* shapes, const int* kinds,
                                 const double* dxs, const double* rhos,
                                 const int* bases, double alpha, double beta,
                                 int nsmooth, cudaStream_t st) {
  const int threads = 256;
  const T* e = (const T*)e_bot;
  for (int d = ndep - 2; d >= 0; --d) {
    const int nx = shapes[3 * d], ny = shapes[3 * d + 1], nz = shapes[3 * d + 2];
    auto p = make_level_params<T>(nx, ny, nz, kinds, rhos[d], alpha, beta, dxs[d]);
    prolong_inc_kernel<T><<<plane_grid((long long)ny * nz, nx, threads), threads, 0, st>>>(
        (T*)u[d], e, nx, ny, nz);
    cudaError_t err = launch_gsrb_relax<T>((T*)u[d], (const T*)rhs[d],
                                           (const T*)a[d], nullptr, p,
                                           bases[d], nsmooth, st);
    if (err != cudaSuccess) return err;
    e = (const T*)u[d];
  }
  return cudaGetLastError();
}

extern "C" int mgk_tower_down(void* const* u, void* const* rhs,
                              const void* const* a, int is_double, int ndep,
                              const int* shapes, const int* kinds,
                              const double* dxs, const double* rhos,
                              const int* bases, double alpha, double beta,
                              int nsmooth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_double
      ? tower_down_impl<double>(u, rhs, a, ndep, shapes, kinds, dxs, rhos, bases, alpha, beta, nsmooth, st)
      : tower_down_impl<float>(u, rhs, a, ndep, shapes, kinds, dxs, rhos, bases, alpha, beta, nsmooth, st));
}

extern "C" int mgk_tower_up(const void* e_bot, void* const* u,
                            const void* const* rhs, const void* const* a,
                            int is_double, int ndep, const int* shapes,
                            const int* kinds, const double* dxs,
                            const double* rhos, const int* bases, double alpha,
                            double beta, int nsmooth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_double
      ? tower_up_impl<double>(e_bot, u, rhs, a, ndep, shapes, kinds, dxs, rhos, bases, alpha, beta, nsmooth, st)
      : tower_up_impl<float>(e_bot, u, rhs, a, ndep, shapes, kinds, dxs, rhos, bases, alpha, beta, nsmooth, st));
}
