// gsrb_relax: red-black Gauss-Seidel sweeps of one whole level.
//
// Replaces the TPU kernel mg_ic_code_tpu/ops/fused_sweeps.py:resident_relax
// (body resident_relax_values): nsweeps full sweeps, each two colour passes,
// with the homogeneous ghost rules folded into per-cell neighbour weights.
//
// What bounds it on this card: bytes. A colour pass does ~20 flops per
// updated cell against 16-32 bytes of device-memory traffic, far below the
// card's flops-per-byte balance, so the time is the number of passes times
// one read of u, rhs, a (and b) plus one write of u. The TPU kernel pinned
// the level in on-chip memory and paid that traffic once per call; here a
// colour pass needs every value of the previous pass from every block, and
// blocks cannot wait on each other inside one launch, so each pass is its
// own launch and pays the traffic again (levels up to ~12 MB stay in the
// 50 MB L2 between passes). What the design does about it: the folded
// weights (lambda, P, the face-dependent neighbour weights, K) are computed
// in registers from a, rhs, b and the cell's index instead of being read
// from precomputed coefficient arrays, only cells of the pass's colour are
// visited, consecutive threads walk z so that loads coalesce, and u is
// updated in place (a pass reads only the other colour and the cell
// itself), so a pass writes half a level.
#include "gsrb_device.cuh"

template <typename T>
LevelParams<T> make_level_params(int nx, int ny, int nz, const int* kinds,
                                 double rho, double alpha, double beta,
                                 double dx) {
  LevelParams<T> p;
  p.nx = nx; p.ny = ny; p.nz = nz;
  const double b_inv = beta * (1.0 / (dx * dx));
  p.alpha = (T)alpha;
  p.b_inv = (T)b_inv;
  p.six_b_inv = (T)(6.0 * b_inv);
  for (int ax = 0; ax < 3; ++ax) {
    p.periodic[ax] = kinds[2 * ax] == FACE_PERIODIC;
    for (int s = 0; s < 2; ++s) {
      double c0 = 0.0, c1 = 0.0;
      switch (kinds[2 * ax + s]) {
        case FACE_DIRICHLET: c0 = -2.0; c1 = 1.0 / 3.0; break;
        case FACE_NEUMANN: c0 = 1.0; c1 = 0.0; break;
        case FACE_CF:
          c0 = 2.0 * (rho - 1.0) / (1.0 + rho);
          c1 = (1.0 - rho) / (3.0 + rho);
          break;
        default: break;  // periodic: unused
      }
      p.c0[ax][s] = (T)c0;
      p.c1[ax][s] = (T)c1;
    }
  }
  return p;
}

template LevelParams<float> make_level_params<float>(int, int, int, const int*, double, double, double, double);
template LevelParams<double> make_level_params<double>(int, int, int, const int*, double, double, double, double);

template <typename T>
__global__ void gsrb_pass_kernel(T* u, const T* __restrict__ rhs,
                                 const T* __restrict__ a,
                                 const T* __restrict__ b,
                                 const LevelParams<T> p, const int par) {
  // thread -> (i, j, kk): only the cells this pass updates are visited
  const int hz = (p.nz + 1) >> 1;
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)p.ny * hz) return;
  const int i = blockIdx.y;
  const int j = (int)(m / hz);
  const int kk = (int)(m - (long long)j * hz);
  // the pass updates cells with (i + j + k + par) even
  const int k = 2 * kk + ((i + j + par) & 1);
  if (k >= p.nz) return;

  const long long idx = ((long long)i * p.ny + j) * p.nz + k;
  u[idx] = gsrb_cell<T, long long>([u](long long q) { return u[q]; }, a[idx],
                                   rhs[idx], b, p, i, j, k, idx);
}

// One colour pass in place on u: the cells with (i + j + k + par) even are
// updated.
template <typename T>
static cudaError_t launch_gsrb_pass(T* u, const T* rhs, const T* a,
                                    const T* b, const LevelParams<T>& p,
                                    int par, cudaStream_t stream) {
  const int threads = 256;
  const long long per_plane = (long long)p.ny * ((p.nz + 1) >> 1);
  dim3 grid((unsigned)((per_plane + threads - 1) / threads), (unsigned)p.nx);
  gsrb_pass_kernel<T><<<grid, threads, 0, stream>>>(u, rhs, a, b, p,
                                                    ((par % 2) + 2) % 2);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_gsrb_relax(T* u, const T* rhs, const T* a,
                                     const T* b, const LevelParams<T>& p,
                                     int base, int nsweeps,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  for (int pass = 0; pass < 2 * nsweeps && err == cudaSuccess; ++pass)
    err = launch_gsrb_pass<T>(u, rhs, a, b, p, base + pass, stream);
  return err;
}

// One colour pass in place on u: the cells with (i + j + k + par) even are
// updated, par = (sum(lo) + colour) & 1. The entry point of the one-pass and
// one-sweep forms (the TPU kernels mg_ic_code_tpu/ops/pallas_kernels.py:
// gsrb_half_sweep and :gsrb_full_sweep, which is two of these).
extern "C" int mgk_gsrb_pass(void* u, const void* rhs, const void* a,
                             const void* b, int is_double, int nx, int ny,
                             int nz, const int* kinds, double rho,
                             double alpha, double beta, double dx, int par,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    auto p = make_level_params<double>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_gsrb_pass<double>((double*)u, (const double*)rhs,
                                         (const double*)a, (const double*)b,
                                         p, par, st);
  }
  auto p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_gsrb_pass<float>((float*)u, (const float*)rhs,
                                      (const float*)a, (const float*)b, p,
                                      par, st);
}

// C entry point. is_double selects the element type; b may be null
// (constant bCoef = 1). u is updated in place.
extern "C" int mgk_gsrb_relax(void* u, const void* rhs, const void* a,
                              const void* b, int is_double, int nx, int ny,
                              int nz, const int* kinds, double rho,
                              double alpha, double beta, double dx, int base,
                              int nsweeps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    auto p = make_level_params<double>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_gsrb_relax<double>((double*)u, (const double*)rhs,
                                          (const double*)a, (const double*)b,
                                          p, base, nsweeps, st);
  }
  auto p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_gsrb_relax<float>((float*)u, (const float*)rhs,
                                       (const float*)a, (const float*)b, p,
                                       base, nsweeps, st);
}
