// Shared declarations of the multigrid stencil kernels (CUDA C++, sm_90a).
//
// Every kernel works on one dense level array of shape (nx, ny, nz), C
// order (z fastest), float or double. The homogeneous one-ring ghost rule
// of a face is LINEAR in the two interior planes next to it,
//     ghost = c0 * u0 + c1 * u1,
// (Dirichlet: -2, 1/3; Neumann: 1, 0; coarse-fine with spacing ratio rho:
// 2(rho-1)/(1+rho), (1-rho)/(3+rho)), so no ghost array is ever built: each
// thread derives the rule of its own cell from the cell's index.
//
// The library has a plain C interface (loaded with ctypes): pointers come
// from tensor.data_ptr(), the stream from torch's current stream. Every
// entry point enqueues on that stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_runtime.h>

// face kind codes shared with the Python wrappers (ops/fused_sweeps.py)
enum FaceKind { FACE_DIRICHLET = 0, FACE_NEUMANN = 1, FACE_PERIODIC = 2, FACE_CF = 3 };

template <typename T>
struct LevelParams {
  int nx, ny, nz;
  T alpha;      // operator: alpha * a * u - beta * b * lap(u)
  T b_inv;      // beta / dx^2
  T six_b_inv;  // 6 * beta / dx^2 (rounded once, as the plain version does)
  T c0[3][2];   // ghost rule per axis, side (unused on a periodic axis)
  T c1[3][2];
  int periodic[3];
};

// Build the per-level parameters from the static description of a level.
// kinds[axis*2+side] is a FaceKind.
template <typename T>
LevelParams<T> make_level_params(int nx, int ny, int nz, const int* kinds,
                                 double rho, double alpha, double beta,
                                 double dx);

// nsweeps red-black sweeps in place on u: 2*nsweeps colour-pass launches.
// base = sum of the box's lo corner (global checkerboard parity).
template <typename T>
cudaError_t launch_gsrb_relax(T* u, const T* rhs, const T* a, const T* b,
                              const LevelParams<T>& p, int base, int nsweeps,
                              cudaStream_t stream);
