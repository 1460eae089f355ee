// residual: res = rhs - L(u) of one whole level with homogeneous ghosts.
//
// Replaces the TPU kernel mg_ic_code_tpu/ops/fused_sweeps.py:
// resident_residual (body resident_residual_values).
//
// What bounds it on this card: bytes — one read each of u, rhs, a (and b)
// and one write of res against ~15 flops per cell. The design keeps to
// that: one thread per cell with z fastest so every load coalesces, the six
// neighbour reads are served by L1/L2 (each u value is read from device
// memory once), and the ghost rule is evaluated from the cell's index in
// registers, so no ghosted copy of u is ever written.
#include "residual_device.cuh"

template <typename T>
__global__ void residual_kernel(const T* __restrict__ u,
                                const T* __restrict__ rhs,
                                const T* __restrict__ a,
                                const T* __restrict__ b, T* __restrict__ res,
                                const LevelParams<T> p) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)p.ny * p.nz) return;
  const int i = blockIdx.y;
  const int j = (int)(m / p.nz);
  const int k = (int)(m - (long long)j * p.nz);
  res[(long long)i * p.ny * p.nz + m] = cell_residual<T>(u, rhs, a, b, p, i, j, k);
}

template <typename T>
static cudaError_t launch_residual(const T* u, const T* rhs, const T* a,
                                   const T* b, T* res, const LevelParams<T>& p,
                                   cudaStream_t stream) {
  const int threads = 256;
  const long long per_plane = (long long)p.ny * p.nz;
  dim3 grid((unsigned)((per_plane + threads - 1) / threads), (unsigned)p.nx);
  residual_kernel<T><<<grid, threads, 0, stream>>>(u, rhs, a, b, res, p);
  return cudaGetLastError();
}

// C entry point; b may be null (constant bCoef = 1); res must not alias u.
extern "C" int mgk_residual(const void* u, const void* rhs, const void* a,
                            const void* b, void* res, int is_double, int nx,
                            int ny, int nz, const int* kinds, double rho,
                            double alpha, double beta, double dx,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    auto p = make_level_params<double>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_residual<double>((const double*)u, (const double*)rhs,
                                        (const double*)a, (const double*)b,
                                        (double*)res, p, st);
  }
  auto p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_residual<float>((const float*)u, (const float*)rhs,
                                     (const float*)a, (const float*)b,
                                     (float*)res, p, st);
}
