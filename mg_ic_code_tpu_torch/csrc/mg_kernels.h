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

// 1/d. For float: the hardware's approximate reciprocal and one Newton
// step (within an ulp of the rounded quotient, and no slow path to branch
// to); d = alpha*a + 6*beta/dx^2 is far from the denormal range.
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}
__device__ __forceinline__ double recip(double d) { return 1.0 / d; }

// One axis of the folded GSRB update on a non-periodic axis, from the two
// neighbour values: adds (weight_plus * up + weight_minus * um) to acc and
// the c0 feed-through of a face to c_sum. The neighbour across a face
// contributes through the ghost rule instead: weight 0 across it (its value
// is never used), 1 + c1 on the far neighbour, c0 into the centre.
template <typename T>
__device__ __forceinline__ void fold_terms(T up, T um, bool is_lo, bool is_hi,
                                           T c0lo, T c1lo, T c0hi, T c1hi,
                                           T P, T& acc, T& c_sum) {
  const T one = (T)1;
  const T wa = is_hi ? (T)0 : (is_lo ? one + c1lo : one);
  const T wb = is_lo ? (T)0 : (is_hi ? one + c1hi : one);
  acc = acc + (P * wa) * (is_hi ? (T)0 : up) + (P * wb) * (is_lo ? (T)0 : um);
  c_sum += (is_lo ? c0lo : (T)0) + (is_hi ? c0hi : (T)0);
}

// Devices a launch set-up is kept for (march_capacity).
constexpr int kMaxDevices = 64;

inline cudaError_t multiprocessors(int* count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of `kern` (`threads` each, `smem` bytes of dynamic shared memory)
// that the current device runs at once. A kernel's shared-memory limit is an
// attribute of the kernel on one device, so it is set, and the capacity
// asked, once per kernel and device: `cache` is the caller's table for its
// kernel, indexed by device. The one-launch kernels size their grids by it:
// the march (csrc/multisweep.cu, csrc/multisweep_halo.cu) and the towers'
// cooperative launches (csrc/tower.cu), which need every block resident.
inline cudaError_t march_capacity(const void* kern, int threads, size_t smem,
                                  int* cache, int* capacity) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = multiprocessors(&sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 1) return cudaErrorLaunchOutOfResources;
    cache[dev] = sms * per_sm;
  }
  *capacity = cache[dev];
  return cudaSuccess;
}
