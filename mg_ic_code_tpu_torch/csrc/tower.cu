// tower_down / tower_up: the V-cycle over a chain of multigrid depths, each
// half ONE cooperative launch.
//
// Replace the TPU kernels mg_ic_code_tpu/ops/coarse_tower.py:
// _tower_down_call (kernel _tower_down_kernel) and _tower_up_call (kernel
// _tower_up_kernel). tower_down: per depth, nsmooth red-black sweeps, then
// the residual restricted by full weighting (mean of the 2^3 children; pairs
// summed along x, then z with the single 1/8, then y) as the next depth's
// rhs, the next depth starting from u = 0; the bottom depth is pre-smoothed
// too. tower_up: from the bottom correction upward, u += e[i/2, j/2, k/2]
// (piecewise-constant prolongation), then nsmooth sweeps. The coarsest-depth
// solve happens between the two, outside. A colour pass updates the cells
// with (i + j + k + sum(lo) + pass) even.
//
// What bounds them on this card: barriers and instruction issue, not bytes
// (the whole 64^3 -> 4^3 chain moves ~1.4 us worth of bytes). The earlier form
// enqueued one launch per colour pass and per restriction (44 + 36 launches
// at 64^3 -> 4^3) and paid ~9 us of launch and host time for each. This one
// is ONE cooperative launch per call (every block resident: at most the
// blocks march_capacity says the card runs at once), with a grid barrier
// (cooperative_groups, ~1.1 us on an H100 whatever the block count) between
// dependent steps, and no other launch in the wrapper:
//  * The depths too big for one block walk their z pairs in grid-stride
//    loops over a grid sized to whole x planes of pairs (tower_geometry), so
//    a thread keeps its (j, pair) and steps along x. A pass visits only its
//    colour, updates u in place (it reads only the other colour and the
//    cell itself), takes two cells a thread at a time with every load ahead
//    of both stores, and has fixed forms for the all-periodic and the
//    no-periodic level (the periodic box, the canonical base) beside the
//    general one. 1/diag is recip() (within an ulp of the quotient; the
//    division made a call 8-11 % slower at 64^3 and 128^3 on an H100).
//  * tower_down folds each depth's fresh state into its first pass: at depth
//    0 the pass's colour gets the update and the other cell of each z pair
//    the caller's u; below, the residual-and-restriction (a thread per
//    coarse cell, the fine residual never in memory) also makes the next
//    depth's first pass, which starts from zero and so needs only the
//    cell's own rhs. Nothing is copied or zeroed before the launch, and the
//    caller's arrays are only read. tower_up writes u_in + P e into its
//    output in its prolongation step.
//  * The small depths run in ONE block's shared memory with block barriers
//    only: from the first depth whose u, rhs and a (and the next depth's
//    rhs or correction) fit the wrapper's budget down to the bottom.
//    tower_down runs that tail after its last grid barrier while the other
//    blocks exit; tower_up runs it first, then one grid barrier, then the
//    big depths. A 16^3 -> 4^3 chain is one block and no grid barrier.
//  * Only the bottom depth may have an odd extent (every other is
//    restricted). Along a periodic axis of odd extent n, cells 0 and n - 1
//    are neighbours of one colour, so tower_down's passes in place on such a
//    bottom read them from a copy of the wrap faces made before the pass
//    (csrc/gsrb_walk.cuh's Faces: each pass saves the next pass's, whose
//    cells it does not write): in shared memory beside the tail's arrays,
//    or, where the bottom is grid-wide, in a scratch the caller passes
//    (mgk_tower_down's `faces`). The depth's first pass (from zero, fused
//    into the restriction) reads no neighbour and leaves the next pass's
//    cells zero. tower_up never smooths the bottom.
// Grid barriers per call with 4 smooths: tower_down one before each pass
// but a depth's first and one before each restriction, and one before the
// tail (17 at 64^3 -> 4^3, 25 at 128^3 -> 4^3); tower_up one after the
// tail, one before each pass and one after each depth but the last (18,
// 27). Every array is read with plain loads, never the read-only path: the
// launch writes u and the restricted rhs between grid barriers.
//
// The bf16 tier (smoother_precision = bfloat16; the C entries' `compute` 1,
// f32 chains): every depth's colour passes in bf16 (C = __nv_bfloat16 beside
// T = float: gsrb_update_row_bf16), the counterpart of the TPU towers'
// compute_dtype (each depth's relax is resident_relax_values). Each depth's
// relax rounds its starting state to bf16: depth 0's u from the caller where
// tower_down's first pass (or the tail) reads it, the prolonged state where
// tower_up writes it; the depths below start from zero, which is exact. The
// residual, the restriction and the prolongation stay f32.
#include <cooperative_groups.h>

#include "gsrb_walk.cuh"
#include "residual_device.cuh"

namespace cg = cooperative_groups;

extern __shared__ __align__(16) unsigned char tower_smem[];

namespace {

// Threads per block (ops/coarse_tower.TOWER_THREADS): 512 leave a thread
// the registers it wants (96 in f32), where 1024 held it to 64 and were
// 12-14 % slower at 64^3 and 16^3 chains on an H100, level at 128^3.
constexpr int kThreads = 512;
constexpr int kMaxDepths = 12;  // ops/coarse_tower.MAX_DEPTHS

// Everything one launch needs, passed by value as a __grid_constant__
// kernel parameter (indexed by depth without a local copy).
template <typename T>
struct TowerArgs {
  LevelParams<T> p[kMaxDepths];
  const T* a[kMaxDepths];
  T* r[kMaxDepths];          // rhs per depth; tower_down writes r[1..]
  T* u[kMaxDepths];          // down: every depth's smoothed state; up: the
                             // new state of depths 0..ndep-2
  const T* uin[kMaxDepths];  // up: the states the correction is added to
  const T* top;              // down: the caller's u; up: the bottom's
  T* faces;                  // down: the grid-wide bottom's wrap faces
                             // (null unless it has an odd periodic axis)
  int par[kMaxDepths];       // sum(lo) & 1 per depth
  int ndep, nsmooth, tail;   // depths [tail, ndep) run in one block
};

template <typename T>
__device__ __forceinline__ int cells_of(const LevelParams<T>& p) {
  return p.nx * p.ny * p.nz;
}

// The residual of depth p restricted to the next depth by full weighting, a
// thread per coarse cell, in the plain version's pairing order: x pairs,
// then z pairs with the single 1/8, then y pairs. Written to rc, and handed
// to start(m, ci, cj, ck, value) with the coarse cell's index.
template <int PER, typename T, typename Start>
__device__ __forceinline__ void restrict_per(const T* u, const T* rhs,
                                             const T* a, T* rc,
                                             const LevelParams<T>& p,
                                             int first, int stride,
                                             const Start& start) {
  const int cy = p.ny >> 1, cz = p.nz >> 1;
  Walk w;
  for (w.init(first, stride, cy, cz); w.a < (p.nx >> 1); w.next()) {
    const int ci = w.a, cj = w.b, ck = w.c;
    T y_sum = (T)0;
    for (int dj = 0; dj < 2; ++dj) {
      T z_sum = (T)0;
      for (int dk = 0; dk < 2; ++dk) {
        const T r0 = cell_residual<T, int, PER>(u, rhs, a, nullptr, p, 2 * ci,
                                                2 * cj + dj, 2 * ck + dk);
        const T r1 = cell_residual<T, int, PER>(u, rhs, a, nullptr, p,
                                                2 * ci + 1, 2 * cj + dj,
                                                2 * ck + dk);
        z_sum += (T)0.125 * (r0 + r1);
      }
      y_sum += z_sum;
    }
    const int m = (ci * cy + cj) * cz + ck;
    rc[m] = y_sum;
    start(m, ci, cj, ck, y_sum);
  }
}

template <typename T, typename Start>
__device__ __forceinline__ void restrict_depth(const T* u, const T* rhs,
                                               const T* a, T* rc,
                                               const LevelParams<T>& p,
                                               int first, int stride,
                                               const Start& start) {
  const int per = periodic_axes(p);
  if (per == 1)
    restrict_per<1>(u, rhs, a, rc, p, first, stride, start);
  else if (per == 0)
    restrict_per<0>(u, rhs, a, rc, p, first, stride, start);
  else
    restrict_per<-1>(u, rhs, a, rc, p, first, stride, start);
}

// u = uin + e[i/2, j/2, k/2] over depth p, e the depth below.
// The sum is rounded as the passes of C read it (as_compute): it is the state
// the depth's relax starts from.
template <int U, typename C, typename T>
__device__ __forceinline__ void prolong_u(T* u, const T* uin, const T* e,
                                          const LevelParams<T>& p, Walk w) {
  const int cy = p.ny >> 1, cz = p.nz >> 1;
  while (w.a < p.nx) {
    int idx[U];
    T v[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const bool live = w.a < p.nx;
      const int i = live ? w.a : 0, j = live ? w.b : 0, k = live ? w.c : 0;
      const int m = (i * p.ny + j) * p.nz + k;
      v[s] = as_compute<C>(uin[m] +
                           e[((i >> 1) * cy + (j >> 1)) * cz + (k >> 1)]);
      idx[s] = live ? m : -1;
      w.next();
    }
#pragma unroll
    for (int s = 0; s < U; ++s)
      if (idx[s] >= 0) u[idx[s]] = v[s];
  }
}

template <typename C, typename T>
__device__ __forceinline__ void prolong_depth(T* u, const T* uin, const T* e,
                                              const LevelParams<T>& p,
                                              int first, int stride) {
  Walk w;
  w.init(first, stride, p.ny, p.nz);
  if (p.nx * p.ny * p.nz > stride)
    prolong_u<2, C>(u, uin, e, p, w);
  else
    prolong_u<1, C>(u, uin, e, p, w);
}

// tower_down's depths [tail, ndep) in this block's shared memory: u, a and
// the rhs of the depth at work, the restricted rhs of the next beside it
// (the two rhs buffers alternate), then the bottom's wrap faces (ODD: the
// bottom has a periodic axis of odd extent). Each depth's state and
// restricted rhs are written out for tower_up.
template <typename T, typename C, bool ODD>
__device__ void tail_down(const TowerArgs<T>& g, T* sm) {
  const int t = g.tail, n0 = cells_of(g.p[t]);
  const int n1 = t + 1 < g.ndep ? cells_of(g.p[t + 1]) : 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* U = sm;
  T* A = U + n0;
  T* R0 = A + n0;
  T* R1 = A + 2 * n0;
  T* F = R1 + n1;
  for (int m = tid; m < n0; m += nt) R0[m] = g.r[t][m];
  for (int d = t; d < g.ndep; ++d) {
    const LevelParams<T>& p = g.p[d];
    const int n = cells_of(p);
    T* rhs = (d - t) & 1 ? R1 : R0;
    for (int m = tid; m < n; m += nt) {
      A[m] = g.a[d][m];
      U[m] = d == 0 ? as_compute<C>(g.top[m]) : (T)0;
    }
    bool many;
    const Walk w = pair_walk(p, tid, nt, many);
    if (ODD && d + 1 == g.ndep) {
      // the wrapped neighbours from the faces F, each pass saving the next
      // pass's, the first's from the depth's starting state
      const Faces<T> fc = make_faces(p, F);
      const T* top = g.top;
      save_faces(fc, [d, top](int q) {
        return d == 0 ? as_compute<C>(top[q]) : (T)0;
      }, p, g.par[d], tid, nt);
      __syncthreads();
      for (int pass = 0; pass < 2 * g.nsmooth; ++pass) {
        pass_faces<true, C>(U, rhs, A, (const T*)nullptr, p,
                            (g.par[d] + pass) & 1, w, many,
                            periodic_axes(p), fc);
        if (pass + 1 < 2 * g.nsmooth)
          save_faces(fc, [U](int q) { return U[q]; }, p,
                     (g.par[d] + pass + 1) & 1, tid, nt);
        __syncthreads();
      }
    } else {
      __syncthreads();
      for (int pass = 0; pass < 2 * g.nsmooth; ++pass) {
        pass_in_place<true, C>(U, rhs, A, (const T*)nullptr, p,
                               (g.par[d] + pass) & 1, w, many,
                               periodic_axes(p));
        __syncthreads();
      }
    }
    for (int m = tid; m < n; m += nt) g.u[d][m] = U[m];
    if (d + 1 < g.ndep) {
      T* next = (d - t) & 1 ? R0 : R1;
      restrict_depth(U, rhs, A, g.r[d + 1], p, tid, nt,
                     [next](int m, int, int, int, T v) { next[m] = v; });
      __syncthreads();
    }
  }
}

// tower_up's depths ndep-2 .. tail in this block's shared memory: the state
// at work and the correction from below alternate between two buffers,
// beside a and rhs. Only the last (depth tail) is written out.
template <typename T, typename C>
__device__ void tail_up(const TowerArgs<T>& g, T* sm) {
  const int t = g.tail, bot = g.ndep - 1;
  const int n0 = cells_of(g.p[t]), n1 = cells_of(g.p[t + 1]);
  const int tid = threadIdx.x, nt = blockDim.x;
  T* U0 = sm;
  T* U1 = sm + n0;
  T* A = sm + n0 + n1;
  T* R = A + n0;
  {
    T* e = (bot - t) & 1 ? U1 : U0;
    const int nb = cells_of(g.p[bot]);
    for (int m = tid; m < nb; m += nt) e[m] = g.top[m];
  }
  __syncthreads();
  for (int d = bot - 1; d >= t; --d) {
    const LevelParams<T>& p = g.p[d];
    const int n = cells_of(p);
    T* u = (d - t) & 1 ? U1 : U0;
    for (int m = tid; m < n; m += nt) {
      A[m] = g.a[d][m];
      R[m] = g.r[d][m];
    }
    prolong_depth<C>(u, g.uin[d], (d - t) & 1 ? U0 : U1, p, tid, nt);
    bool many;
    const Walk w = pair_walk(p, tid, nt, many);
    __syncthreads();
    for (int pass = 0; pass < 2 * g.nsmooth; ++pass) {
      pass_in_place<true, C>(u, R, A, (const T*)nullptr, p,
                             (g.par[d] + pass) & 1, w, many,
                             periodic_axes(p));
      __syncthreads();
    }
  }
  for (int m = tid; m < n0; m += nt) g.u[t][m] = U0[m];
}

template <typename T, typename C, bool ODD>
__global__ void __launch_bounds__(kThreads, 1)
tower_down_kernel(const __grid_constant__ TowerArgs<T> g) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int np = 2 * g.nsmooth;
  const int wide = g.tail < g.ndep ? g.tail : g.ndep;
  for (int d = 0; d < wide; ++d) {
    const LevelParams<T>& p = g.p[d];
    bool many;
    const Walk w = pair_walk(p, first, stride, many);
    // below depth 0 the first pass was made with the restriction that gave
    // the depth its rhs
    if (d == 0) {
      const T* u0 = g.top;
      first_pass<true, -1, C>(g.u[0],
                              [u0](int q) { return as_compute<C>(u0[q]); },
                              g.r[0], g.a[0], (const T*)nullptr, p, g.par[0],
                              np > 0, w, many);
    }
    if (ODD && d + 1 == g.ndep) {
      // a grid-wide bottom: the wrapped neighbours from the faces in g.faces
      const Faces<T> fc = make_faces(p, g.faces);
      T* u = g.u[d];
      for (int pass = 1; pass < np; ++pass) {
        grid.sync();
        pass_faces<true, C>(u, g.r[d], g.a[d], (const T*)nullptr, p,
                            (g.par[d] + pass) & 1, w, many,
                            periodic_axes(p), fc);
        if (pass + 1 < np)
          save_faces(fc, [u](int q) { return u[q]; }, p,
                     (g.par[d] + pass + 1) & 1, first, stride);
      }
    } else {
      for (int pass = 1; pass < np; ++pass) {
        grid.sync();
        pass_in_place<true, C>(g.u[d], g.r[d], g.a[d], (const T*)nullptr,
                               p, (g.par[d] + pass) & 1, w, many,
                               periodic_axes(p));
      }
    }
    if (d + 1 == g.ndep) break;
    grid.sync();
    if (d + 1 < wide) {
      // the next depth's first colour pass from zero, fused: it reads only
      // its own cell's rhs, which this thread has just made
      const LevelParams<T>& pn = g.p[d + 1];
      const T* an = g.a[d + 1];
      T* un = g.u[d + 1];
      const int parn = g.par[d + 1];
      const bool update = np > 0;
      restrict_depth(g.u[d], g.r[d], g.a[d], g.r[d + 1], p, first, stride,
                     [&](int m, int ci, int cj, int ck, T v) {
                       un[m] = update && ((ci + cj + ck + parn) & 1) == 0
                           ? gsrb_cell<T, int, true, -1, C>(
                                 [](int) { return (T)0; }, an[m], v,
                                 (const T*)nullptr, pn, ci, cj, ck, m)
                           : (T)0;
                     });
      // a grid-wide odd bottom: its second pass reads the faces of the
      // cells the first left zero
      if (ODD && d + 2 == g.ndep)
        for (int m = first; m < face_cells(pn); m += stride) g.faces[m] = 0;
    } else {
      restrict_depth(g.u[d], g.r[d], g.a[d], g.r[d + 1], p, first, stride,
                     [](int, int, int, int, T) {});
      grid.sync();  // the tail reads the restricted rhs
    }
  }
  if (g.tail < g.ndep && blockIdx.x == 0)
    tail_down<T, C, ODD>(g, reinterpret_cast<T*>(tower_smem));
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, 1)
tower_up_kernel(const __grid_constant__ TowerArgs<T> g) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int bot = g.ndep - 1;
  const int top = g.tail < bot ? g.tail : bot;  // tail depths [top, bot)
  if (top < bot) {
    if (blockIdx.x == 0) tail_up<T, C>(g, reinterpret_cast<T*>(tower_smem));
    if (top > 0) grid.sync();
  }
  for (int d = top - 1; d >= 0; --d) {
    const LevelParams<T>& p = g.p[d];
    T* u = g.u[d];
    prolong_depth<C>(u, g.uin[d],
                     d + 1 == bot ? g.top : (const T*)g.u[d + 1], p, first,
                     stride);
    bool many;
    const Walk w = pair_walk(p, first, stride, many);
    for (int pass = 0; pass < 2 * g.nsmooth; ++pass) {
      grid.sync();
      pass_in_place<true, C>(u, g.r[d], g.a[d], (const T*)nullptr, p,
                             (g.par[d] + pass) & 1, w, many,
                             periodic_axes(p));
    }
    if (d > 0) grid.sync();
  }
}

// For measurement only (chip_smoke.py): n grid barriers and nothing else,
// the price of one in a launch of the towers' block size.
__global__ void __launch_bounds__(kThreads, 1)
tower_barriers_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// Blocks of the tower kernels of the type and arithmetic the current device
// runs at once with `smem` bytes of dynamic shared memory each (the
// wrapper's budget), asked once per kernel and device; also sets that
// shared-memory limit on each. odd: tower_down's form for a bottom with a
// periodic axis of odd extent, else its even form (so that the odd form
// decides no even chain's blocks); tower_up has one form.
template <typename T, typename C>
cudaError_t tower_capacity(int smem, bool odd, int* capacity) {
  static int cache_down[2][kMaxDevices] = {};
  static int cache_up[kMaxDevices] = {};
  int down = 0, up = 0;
  cudaError_t err = march_capacity(
      odd ? (const void*)tower_down_kernel<T, C, true>
          : (const void*)tower_down_kernel<T, C, false>,
      kThreads, smem, cache_down[odd], &down);
  if (err != cudaSuccess) return err;
  err = march_capacity((const void*)tower_up_kernel<T, C>, kThreads, smem,
                       cache_up, &up);
  if (err != cudaSuccess) return err;
  *capacity = down < up ? down : up;
  return cudaSuccess;
}

long long cells_host(const int* shapes, int d) {
  return (long long)shapes[3 * d] * shapes[3 * d + 1] * shapes[3 * d + 2];
}

// The static part of the arguments, with the checks of the geometry: at
// most kMaxDepths depths, cells indexed by int, the tail inside the chain
// and its shared memory (with the bottom's wrap faces) within `smem`,
// and only the bottom may have an odd extent (the restriction halves every
// other depth).
template <typename T>
cudaError_t chain_args(TowerArgs<T>& g, int ndep, const int* shapes,
                       const int* kinds, const double* dxs,
                       const double* rhos, const int* bases, double alpha,
                       double beta, int nsmooth, int blocks, int tail,
                       int smem) {
  if (ndep < 2 || ndep > kMaxDepths || nsmooth < 0 || blocks < 1 ||
      tail < 0 || tail > ndep)
    return cudaErrorInvalidValue;
  for (int d = 0; d < ndep; ++d) {
    if (cells_host(shapes, d) > (1LL << 30)) return cudaErrorInvalidValue;
    if (d + 1 < ndep && (shapes[3 * d] % 2 || shapes[3 * d + 1] % 2 ||
                         shapes[3 * d + 2] % 2))
      return cudaErrorInvalidValue;
    g.p[d] = make_level_params<T>(shapes[3 * d], shapes[3 * d + 1],
                                  shapes[3 * d + 2], kinds, rhos[d], alpha,
                                  beta, dxs[d]);
    g.par[d] = ((bases[d] % 2) + 2) % 2;
  }
  g.ndep = ndep;
  g.nsmooth = nsmooth;
  g.tail = tail;
  if (tail < ndep) {
    const long long n1 = tail + 1 < ndep ? cells_host(shapes, tail + 1) : 0;
    if ((3 * cells_host(shapes, tail) + n1 + face_cells(g.p[ndep - 1])) *
            (long long)sizeof(T) > smem)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_tower(const void* kern, TowerArgs<T>& g, int blocks,
                         int smem, cudaStream_t st) {
  void* params[] = {(void*)&g};
  return cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(kThreads),
                                     params, (size_t)smem, st);
}

// Down pass. u0, rhs0: the caller's depth-0 state and rhs (read only). out:
// one buffer of every depth's smoothed state (depth 0 first), then the
// restricted rhs of depths 1 .. ndep-1. faces: mgk_tower_down's. C: the
// passes' arithmetic.
template <typename T, typename C>
cudaError_t tower_down_impl(const void* u0, const void* rhs0, void* out,
                            void* faces,
                            const void* const* a, int ndep, const int* shapes,
                            const int* kinds, const double* dxs,
                            const double* rhos, const int* bases, double alpha,
                            double beta, int nsmooth, int blocks, int tail,
                            int smem, cudaStream_t st) {
  TowerArgs<T> g = {};
  cudaError_t err = chain_args<T>(g, ndep, shapes, kinds, dxs, rhos, bases,
                                  alpha, beta, nsmooth, blocks, tail, smem);
  if (err != cudaSuccess) return err;
  T* next = (T*)out;
  for (int d = 0; d < ndep; ++d) {
    g.u[d] = next;
    next += cells_host(shapes, d);
  }
  g.r[0] = (T*)rhs0;  // never written
  for (int d = 1; d < ndep; ++d) {
    g.r[d] = next;
    next += cells_host(shapes, d);
  }
  for (int d = 0; d < ndep; ++d) g.a[d] = (const T*)a[d];
  g.top = (const T*)u0;
  const bool odd = face_cells(g.p[ndep - 1]) > 0;
  if (odd && tail == ndep && faces == nullptr) return cudaErrorInvalidValue;
  g.faces = odd && tail == ndep ? (T*)faces : nullptr;
  return launch_tower<T>(odd ? (const void*)tower_down_kernel<T, C, true>
                             : (const void*)tower_down_kernel<T, C, false>,
                         g, blocks, smem, st);
}

// Up pass. e_bot: the solved bottom depth; u_in, rhs, a: ndep-1 arrays each
// (depths 0 .. ndep-2); out: one buffer of the new states of depths 0 ..
// ndep-2 (depth 0, the result, first). C: the passes' arithmetic.
template <typename T, typename C>
cudaError_t tower_up_impl(const void* e_bot, const void* const* u_in,
                          const void* const* rhs, const void* const* a,
                          void* out, int ndep, const int* shapes,
                          const int* kinds, const double* dxs,
                          const double* rhos, const int* bases, double alpha,
                          double beta, int nsmooth, int blocks, int tail,
                          int smem, cudaStream_t st) {
  TowerArgs<T> g = {};
  cudaError_t err = chain_args<T>(g, ndep, shapes, kinds, dxs, rhos, bases,
                                  alpha, beta, nsmooth, blocks, tail, smem);
  if (err != cudaSuccess) return err;
  T* next = (T*)out;
  for (int d = 0; d + 1 < ndep; ++d) {
    g.u[d] = next;
    next += cells_host(shapes, d);
    g.uin[d] = (const T*)u_in[d];
    g.r[d] = (T*)rhs[d];  // never written
    g.a[d] = (const T*)a[d];
  }
  g.top = (const T*)e_bot;
  return launch_tower<T>((const void*)tower_up_kernel<T, C>, g, blocks,
                         smem, st);
}

}  // namespace

// C entry points (csrc/mg_kernels.h's conventions). shapes: ndep * 3 ints;
// dxs, rhos: ndep doubles; bases: ndep ints (sum(lo) per depth); blocks,
// tail, smem: the launch geometry (ops/coarse_tower.tower_geometry).
// compute: 0 the passes at the operands' precision, 1 in bf16 (f32).
// tower_down's faces: where the bottom depth has a periodic axis of odd
// extent and runs grid-wide (tail == ndep), a scratch of its wrap faces,
// face_cells(bottom) elements (gsrb_walk.cuh; fused_sweeps.face_cells); else
// null (the tail keeps them in shared memory).
extern "C" int mgk_tower_down(const void* u0, const void* rhs0, void* out,
                              void* faces, const void* const* a,
                              int is_double,
                              int compute, int ndep, const int* shapes,
                              const int* kinds, const double* dxs,
                              const double* rhos, const int* bases,
                              double alpha, double beta, int nsmooth,
                              int blocks, int tail, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (compute < 0 || compute > 1 || (compute == 1 && is_double))
    return (int)cudaErrorInvalidValue;
  if (compute == 1)
    return (int)tower_down_impl<float, __nv_bfloat16>(
        u0, rhs0, out, faces, a, ndep, shapes, kinds, dxs, rhos, bases, alpha,
        beta, nsmooth, blocks, tail, smem, st);
  return (int)(is_double
      ? tower_down_impl<double, double>(u0, rhs0, out, faces, a, ndep,
                                        shapes, kinds, dxs, rhos, bases,
                                        alpha, beta, nsmooth, blocks, tail,
                                        smem, st)
      : tower_down_impl<float, float>(u0, rhs0, out, faces, a, ndep, shapes,
                                      kinds, dxs, rhos, bases, alpha, beta,
                                      nsmooth, blocks, tail, smem, st));
}

extern "C" int mgk_tower_up(const void* e_bot, const void* const* u_in,
                            const void* const* rhs, const void* const* a,
                            void* out, int is_double, int compute, int ndep,
                            const int* shapes, const int* kinds,
                            const double* dxs, const double* rhos,
                            const int* bases, double alpha, double beta,
                            int nsmooth, int blocks, int tail, int smem,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (compute < 0 || compute > 1 || (compute == 1 && is_double))
    return (int)cudaErrorInvalidValue;
  if (compute == 1)
    return (int)tower_up_impl<float, __nv_bfloat16>(
        e_bot, u_in, rhs, a, out, ndep, shapes, kinds, dxs, rhos, bases,
        alpha, beta, nsmooth, blocks, tail, smem, st);
  return (int)(is_double
      ? tower_up_impl<double, double>(e_bot, u_in, rhs, a, out, ndep, shapes,
                                      kinds, dxs, rhos, bases, alpha, beta,
                                      nsmooth, blocks, tail, smem, st)
      : tower_up_impl<float, float>(e_bot, u_in, rhs, a, out, ndep, shapes,
                                    kinds, dxs, rhos, bases, alpha, beta,
                                    nsmooth, blocks, tail, smem, st));
}

// C entry point of the barrier probe: one cooperative launch of `blocks`
// blocks that passes n grid barriers.
extern "C" int mgk_tower_barriers(int blocks, int n, void* stream) {
  if (blocks < 1 || n < 0) return (int)cudaErrorInvalidValue;
  void* params[] = {(void*)&n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)tower_barriers_kernel, dim3(blocks), dim3(kThreads),
      params, 0, (cudaStream_t)stream);
}

// C entry point: *capacity <- blocks of both tower kernels of the type and
// arithmetic (compute as mgk_tower_down's) that the current device runs at
// once with `smem` bytes of shared memory each, for a chain whose bottom has
// (odd 1) or has not (0) a periodic axis of odd extent.
extern "C" int mgk_tower_capacity(int is_double, int compute, int odd,
                                  int smem, int* capacity) {
  if (compute < 0 || compute > 1 || (compute == 1 && is_double) || odd < 0 ||
      odd > 1)
    return (int)cudaErrorInvalidValue;
  if (compute == 1)
    return (int)tower_capacity<float, __nv_bfloat16>(smem, odd, capacity);
  return (int)(is_double
      ? tower_capacity<double, double>(smem, odd, capacity)
      : tower_capacity<float, float>(smem, odd, capacity));
}
