// gsrb_relax: red-black Gauss-Seidel sweeps of one whole level, ONE
// cooperative launch per call.
//
// Replaces the TPU kernel mg_ic_code_tpu/ops/fused_sweeps.py:resident_relax
// (its pallas_call _resident_call; body resident_relax_values): nsweeps
// full sweeps, each two colour passes, with the homogeneous ghost rules
// folded into per-cell neighbour weights (csrc/gsrb_device.cuh). The TPU
// kernel pinned the level in VMEM: one read and one write of each array
// whatever nsweeps.
//
// What bounds it on this card: not the bytes (a level the solver sends here
// fits the 50 MB L2, and its arrays read once and u written once take 3-8
// us at 3.35 TB/s) but the 2 * nsweeps dependent passes: the instructions
// of each cell's update (~110 a cell, issue-bound: 1.5-2 us a pass for
// 300-800K cells on 132 SMs) and a grid-wide synchronisation between
// passes (~1.1 us, more with the exchange). What the design does about it:
// no launch, copy or host work per pass (ONE cooperative launch, every
// block resident: at most the blocks march_capacity says the card runs at
// once, a grid barrier between passes), the level held on chip where that
// wins, and the update's row terms worked out once for several cells; in
// one of two forms that fused_sweeps.gsrb_geometry picks before the launch
// from the shape, the type, b and the capacity:
//  * "grid" (any level, f32 or f64, variable b): the towers' grid-wide pass
//    (csrc/gsrb_walk.cuh): z pairs in grid-stride loops, two cells in
//    flight a thread, fixed forms for the all-periodic and the no-periodic
//    level; the first pass reads the caller's u and writes the whole of out
//    (the other colour copied), the others update out in place, reading u,
//    rhs and a again from the L2.
//  * "slab" (f32, constant b, where a block's share fits its shared memory
//    and the tiles are large enough to win): the counterpart of the TPU
//    kernel's residency. The level is cut into tiles of x planes and y rows
//    (all of z); a block holds its tile's u with one plane and one row more
//    on each side (its window), and the tile's a and rhs, in shared memory,
//    loaded once. Every pass runs on chip, a thread taking 4 cells of one z
//    row at a time so that the row's index and x and y terms are worked out
//    once; between passes only the tile's first and last planes and rows
//    along a cut axis go out to `out`, and after a grid barrier the
//    neighbours' come into the window (along a whole periodic axis the
//    tile's own far plane or row). u is stored once at the end. A level of
//    one block needs no exchange and no grid barrier.
//    Point-to-point flags between neighbouring blocks in place of the grid
//    barrier were slower in every form measured (PERF.md §6), as were
//    1024 threads a block: the update is issue-bound.
// Both forms compute every cell with gsrb_update_row's arithmetic in its
// order, as the one-sweep and one-pass kernels do (csrc/gsrb_sweep.cu):
// gsrb_full_sweep == gsrb_relax(nsweeps = 1) bitwise. At nsweeps = 1 the
// grid form is gsrb_full_sweep's "grid" form.
//
// The bf16 tier (smoother_precision = bfloat16; mgk_gsrb_relax's `compute`
// 1, f32 levels with constant b): the same two forms with the colour passes'
// arithmetic in bf16 (C = __nv_bfloat16 beside T = float:
// gsrb_update_row_bf16), the counterpart of resident_relax's compute_dtype
// (the body resident_relax_values: fold in f32, round the folded terms and
// the state to bf16 once, passes in bf16, the result back in f32). The
// state is rounded where it enters: the grid form's first pass rounds every
// cell it reads from the caller's u (both colours), the slab form its window
// once loaded. Storage stays f32 (bf16 values in f32: no halved tile, no
// packed pairs); the f32 and f64 instantiations are the ones without it.
//
// A batch (mgk_gsrb_relax_batch: the same-shape sibling patches of an AMR
// depth, which the JAX package sweeps as one vmapped XLA body): P levels of
// one shape, face kinds and checker parity in ONE cooperative launch, each
// given by its own pointers (a table of P base pointers: no stacked copy).
// Blocks [k * tiles, (k + 1) * tiles) take patch k in the form and grid one
// patch takes at capacity / P, and every grid barrier serves all patches.
// Where the P patches' arrays overflow the L2 that one patch's fit (two
// 144^3 f32 patches: 96 MB), the passes of patches side by side go to
// device memory and the batch ran 25 % slower than P single calls on an
// H100; there the "serial" form takes the patches one after the other,
// every block on each, in one patch's grid form at the whole capacity (a
// launch and its wrapper call saved, not the barriers). Each cell's update
// is the single launch's, so a batch is bit for bit P single calls; one
// call is a batch of one.
#include <cooperative_groups.h>

#include "gsrb_walk.cuh"

namespace cg = cooperative_groups;

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

extern __shared__ __align__(16) unsigned char relax_smem[];

namespace {

// Threads per block of both forms (fused_sweeps.GSRB_THREADS; 1024 were
// slower in the slab form) and the most blocks of the slab form
// (fused_sweeps.GSRB_MAX_SLABS); the forms' codes (fused_sweeps.GSRB_FORMS).
constexpr int kThreads = 512;
constexpr int kMaxSlabs = 256;
// patches of one batch at most (fused_sweeps.BATCH_MAX)
constexpr int kMaxBatch = 16;
// (FORM_MARCH, a batch's march, has an entry point of its own:
// mgk_gsrb_batch_march, csrc/gsrb_batch_march.cu)
enum RelaxForm {
  FORM_GRID = 0,
  FORM_SLAB = 1,
  FORM_SERIAL = 2,
  FORM_MARCH = 3
};

// Everything one launch needs, passed by value as a __grid_constant__
// kernel parameter: patch k's operands at index k.
template <typename T>
struct RelaxArgs {
  LevelParams<T> p;
  const T* u[kMaxBatch];     // the caller's state, only read
  const T* rhs[kMaxBatch];
  const T* a[kMaxBatch];
  const T* b[kMaxBatch];     // null: constant bCoef
  T* out[kMaxBatch];
  // grid form: the wrap faces of a level with an odd periodic axis
  // (gsrb_walk.cuh's Faces; null without one)
  T* faces[kMaxBatch];
  int par, npass, per;        // sum(lo) & 1, 2 * nsweeps, periodic_axes
  bool vec;                   // slab form: rows in 16-byte pieces
  int tiles;                  // blocks of one patch
  int npatch;                 // patches
  bool serial;                // every block on every patch in turn
  int xtiles;                 // slab form: tiles along x (tiles / along y)
  // slab form: the first plane of each x tile, then nx; the first row of
  // each y tile, then ny
  int start[2 * kMaxSlabs + 2];
};

// ODD: the level has a periodic axis of odd extent (its passes in place
// read the wrap faces, g.faces).
template <typename T, typename C, bool ODD>
__global__ void __launch_bounds__(kThreads, 1)
relax_grid_kernel(const __grid_constant__ RelaxArgs<T> g) {
  cg::grid_group grid = cg::this_grid();
  // this block's patch (serial: every patch in turn), and its place among
  // the patch's blocks
  const int own = g.serial ? 0 : blockIdx.x / g.tiles;
  const int first = (blockIdx.x - own * g.tiles) * blockDim.x + threadIdx.x;
  const int stride = g.tiles * blockDim.x;
  bool many;
  const Walk w = pair_walk(g.p, first, stride, many);
  for (int patch = own; patch < (g.serial ? g.npatch : own + 1); ++patch) {
    const T* u0 = g.u[patch];
    const T *rhs = g.rhs[patch], *a = g.a[patch], *b = g.b[patch];
    T* out = g.out[patch];
    const auto get = [u0](int q) { return as_compute<C>(u0[q]); };
    const bool update = g.npass > 0;
    if (g.per == 1)
      first_pass<false, 1, C>(out, get, rhs, a, b, g.p, g.par, update, w,
                              many);
    else if (g.per == 0)
      first_pass<false, 0, C>(out, get, rhs, a, b, g.p, g.par, update, w,
                              many);
    else
      first_pass<false, -1, C>(out, get, rhs, a, b, g.p, g.par, update, w,
                               many);
    if constexpr (ODD) {
      // each pass saves the next pass's faces, whose cells it does not
      // write; the first pass those of the second from the caller's u
      const Faces<T> fc = make_faces(g.p, g.faces[patch]);
      if (g.npass > 1)
        save_faces(fc, get, g.p, (g.par + 1) & 1, first, stride);
      for (int pass = 1; pass < g.npass; ++pass) {
        grid.sync();
        pass_faces<false, C>(out, rhs, a, b, g.p, (g.par + pass) & 1, w,
                             many, g.per, fc);
        if (pass + 1 < g.npass)
          save_faces(fc, [out](int q) { return out[q]; }, g.p,
                     (g.par + pass + 1) & 1, first, stride);
      }
    } else {
      for (int pass = 1; pass < g.npass; ++pass) {
        grid.sync();
        pass_in_place<false, C>(out, rhs, a, b, g.p, (g.par + pass) & 1, w,
                                many, g.per);
      }
    }
  }
}

// Copies into shared memory that every thread of the block issues before it
// waits for any (cp.async, past L1: `out` changes between passes), and the
// wait.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The geometry of one block of the slab form: its tile of the level (x
// planes [i0, i0 + bx), rows [j0, j0 + by), all of z) and its window in
// shared memory: the tile with one plane and one row more on each side,
// (bx + 2) x (by + 2) rows of nz cells, window plane stride sx.
struct Tile {
  int i0, bx, j0, by, sx;
  // window index of the tile's cell (li, lj, k), li and lj from -1
  __device__ __forceinline__ int at(int li, int lj, int k, int nz) const {
    return ((li + 1) * (by + 2) + lj + 1) * nz + k;
  }
};

// Copies of whole z rows between the window and a level array: nrows rows,
// row r from level row src_row(r) (or to it) at window row win_row(r); a
// row whose level row is -1 is left out. 16-byte pieces where `vec` (nz a
// multiple of 4, the arrays 16-byte aligned), else one element at a time
// through the L2. Rows in: cp.async, finished by copies_done().
template <bool IN, typename L, typename Rows>
__device__ __forceinline__ void copy_rows(float* win, L* level, int nrows,
                                          int nz, bool vec,
                                          const Rows& rows) {
  const int per = vec ? nz >> 2 : nz;
  for (int m = threadIdx.x; m < nrows * per; m += blockDim.x) {
    const int r = m / per, c = m - r * per;
    int g, w;
    rows(r, g, w);
    if (g < 0) continue;
    float* s = win + w * nz;
    L* d = level + (long long)g * nz;
    if constexpr (IN) {
      if (vec)
        copy16(s + 4 * c, d + 4 * c);
      else
        s[c] = __ldcg(d + c);
    } else {
      if (vec)
        reinterpret_cast<float4*>(d)[c] = reinterpret_cast<float4*>(s)[c];
      else
        d[c] = s[c];
    }
  }
}

// Level index i + d (d = -1 or n) of an axis of n cells: wrapped where the
// axis is periodic, else -1 past the face.
__device__ __forceinline__ int beyond(int i, int n, bool periodic) {
  if (i >= 0 && i < n) return i;
  return periodic ? (i < 0 ? i + n : i - n) : -1;
}

// Cells of one z row that a thread of the slab form updates at a time: the
// row's index, parity and x and y faces are worked out once for all of
// them.
constexpr int kRowCells = 4;

// One colour pass of the slab form on the window W: the cells of the pass's
// colour in the tile, as items (li, lj, seg) of the (bx, by, L) box, L =
// ceil(nz / 2 / kRowCells) segments a row: segment seg takes the z pairs
// seg, seg + L, ... of row (li, lj) (neighbouring threads on neighbouring
// pairs), all its loads ahead of its stores; in the arithmetic of C. ZODD:
// z is periodic of odd extent, and a row's cells 0 and nz - 1 read each
// other from Z (save_zwrap: their values before the pass).
template <int PER, typename C, bool ZODD>
__device__ __forceinline__ void tile_pass(float* W, const float* A,
                                          const float* R, const float* Z,
                                          const Tile& t,
                                          const LevelParams<float>& p,
                                          int par, Walk w, int segs) {
  const int nz = p.nz, hz = (nz + 1) >> 1;
  const bool zper = PER < 0 ? p.periodic[2] != 0 : PER == 1;
  for (; w.a < t.bx; w.next()) {
    const int i = t.i0 + w.a, j = t.j0 + w.b;
    const int row = t.at(w.a, w.b, 0, nz), own = (w.a * t.by + w.b) * nz;
    const int odd = (i + j + par) & 1;
    const RowFold<float> rf = row_fold<float, PER>(p, i, j);
    int idx[kRowCells];
    float v[kRowCells];
#pragma unroll
    for (int s = 0; s < kRowCells; ++s) {
      const int kk = w.c + s * segs;
      int k = 2 * kk + odd;
      const bool live = kk < hz && k < nz;
      k = live ? k : 0;
      const int c = row + k;
      float up[3], um[3];
      // x and y from the window's neighbours (its halo past the tile; past
      // an open face of the level the value is masked by its weight 0)
      up[0] = W[c + t.sx];
      um[0] = W[c - t.sx];
      up[1] = W[c + nz];
      um[1] = W[c - nz];
      if constexpr (ZODD) {
        const int zr = 2 * (w.a * t.by + w.b);
        up[2] = k == nz - 1 ? Z[zr] : W[c + 1];
        um[2] = k == 0 ? Z[zr + 1] : W[c - 1];
      } else {
        up[2] = W[k == nz - 1 ? (zper ? c - (nz - 1) : c) : c + 1];
        um[2] = W[k == 0 ? (zper ? c + (nz - 1) : c) : c - 1];
      }
      v[s] = gsrb_update_row<float, false, PER, C>(W[c], up, um, A[own + k],
                                                   R[own + k], false, 0.0f,
                                                   rf, p, k);
      idx[s] = live ? c : -1;
    }
#pragma unroll
    for (int s = 0; s < kRowCells; ++s)
      if (idx[s] >= 0) W[idx[s]] = v[s];
  }
}

// The tile's z wrap cells (k = 0, then nz - 1, of each row) into Z, at a
// point where no pass writes the window.
__device__ __forceinline__ void save_zwrap(float* Z, const float* W,
                                           const Tile& t, int nz) {
  for (int m = threadIdx.x; m < 2 * t.bx * t.by; m += blockDim.x) {
    const int r = m >> 1, li = r / t.by;
    Z[m] = W[t.at(li, r - li * t.by, (m & 1) ? nz - 1 : 0, nz)];
  }
}

template <int PER, typename C, bool ZODD>
__global__ void __launch_bounds__(kThreads, 1)
relax_slab_kernel(const __grid_constant__ RelaxArgs<float> g) {
  const LevelParams<float>& p = g.p;
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  // this block's patch, and its tile of the patch
  const int patch = blockIdx.x / g.tiles;
  const int tile = blockIdx.x - patch * g.tiles;
  const int tx = g.xtiles, ty = g.tiles / tx;
  const int ix = tile / ty, iy = tile - ix * ty;
  Tile t;
  t.i0 = g.start[ix];
  t.bx = g.start[ix + 1] - t.i0;
  t.j0 = g.start[tx + 1 + iy];
  t.by = g.start[tx + 2 + iy] - t.j0;
  t.sx = (t.by + 2) * nz;
  const bool xper = p.periodic[0], yper = p.periodic[1], vec = g.vec;
  float* W = reinterpret_cast<float*>(relax_smem);
  const int cells = t.bx * t.by * nz;
  float* A = W + (t.bx + 2) * t.sx;
  float* R = A + cells;
  float* Z = R + cells;  // ZODD: 2 cells a tile row
  float* out = g.out[patch];
  // the window from the caller's u (not its corners, which no cell reads),
  // a and rhs of the tile
  const int wrows = (t.bx + 2) * (t.by + 2);
  copy_rows<true>(W, g.u[patch], wrows, nz, vec,
                  [&](int r, int& gr, int& wr) {
                    const int li = r / (t.by + 2) - 1;
                    const int lj = r - (li + 1) * (t.by + 2) - 1;
                    const bool corner = (li < 0 || li == t.bx) &&
                                        (lj < 0 || lj == t.by);
                    const int i = beyond(t.i0 + li, nx, xper);
                    const int j = beyond(t.j0 + lj, ny, yper);
                    gr = corner || i < 0 || j < 0 ? -1 : i * ny + j;
                    wr = r;
                  });
  const auto own_rows = [&](int r, int& gr, int& wr) {
    const int li = r / t.by, lj = r - li * t.by;
    gr = (t.i0 + li) * ny + t.j0 + lj;
    wr = (li + 1) * (t.by + 2) + lj + 1;
  };
  copy_rows<true>(A, g.a[patch], t.bx * t.by, nz, vec,
                  [&](int r, int& gr, int& wr) {
                    own_rows(r, gr, wr);
                    wr = r;
                  });
  copy_rows<true>(R, g.rhs[patch], t.bx * t.by, nz, vec,
                  [&](int r, int& gr, int& wr) {
                    own_rows(r, gr, wr);
                    wr = r;
                  });
  const int segs = ((nz + 1) / 2 + kRowCells - 1) / kRowCells;
  Walk w;
  w.init(threadIdx.x, blockDim.x, t.by, segs);
  copies_done();
  __syncthreads();
  if constexpr (!std::is_same<C, float>::value) {
    // the bf16 tier rounds the caller's state where it lands (the halo that
    // comes in between passes was written by passes: bf16 values already)
    for (int m = threadIdx.x; m < (t.bx + 2) * t.sx; m += blockDim.x)
      W[m] = as_compute<C>(W[m]);
    __syncthreads();
  }
  if constexpr (ZODD) {
    save_zwrap(Z, W, t, nz);
    __syncthreads();
  }
  // rows a neighbour reads: the first and last planes along a cut x, the
  // first and last rows along a cut y
  const int xrows = tx > 1 ? 2 * t.by : 0, yrows = ty > 1 ? 2 * t.bx : 0;
  const auto edge_rows = [&](int r, int& gr, int& wr) {
    int li, lj;
    if (r < xrows) {
      li = r < t.by ? 0 : t.bx - 1;
      lj = r < t.by ? r : r - t.by;
    } else {
      r -= xrows;
      lj = r < t.bx ? 0 : t.by - 1;
      li = r < t.bx ? r : r - t.bx;
    }
    gr = (t.i0 + li) * ny + t.j0 + lj;
    wr = (li + 1) * (t.by + 2) + lj + 1;
  };
  for (int pass = 0; pass < g.npass; ++pass) {
    tile_pass<PER, C, ZODD>(W, A, R, Z, t, p, (g.par + pass) & 1, w, segs);
    __syncthreads();
    if (pass + 1 == g.npass) break;
    if constexpr (ZODD) save_zwrap(Z, W, t, nz);
    if (xrows + yrows > 0) {
      copy_rows<false>(W, out, xrows + yrows, nz, vec, edge_rows);
      cg::this_grid().sync();
    }
    // the halo: along a cut axis the neighbours' planes and rows from out;
    // along a whole periodic axis the tile's own far plane or row
    const int sxr = tx == 1 && xper ? 2 * t.by : 0;
    const int syr = ty == 1 && yper ? 2 * t.bx : 0;
    for (int m = threadIdx.x; m < (sxr + syr) * nz; m += blockDim.x) {
      int r = m / nz;
      const int k = m - r * nz;
      int li, lj, si, sj;
      if (r < sxr) {
        const bool lo = r < t.by;
        lj = sj = lo ? r : r - t.by;
        li = lo ? -1 : t.bx;
        si = lo ? t.bx - 1 : 0;
      } else {
        r -= sxr;
        const bool lo = r < t.bx;
        li = si = lo ? r : r - t.bx;
        lj = lo ? -1 : t.by;
        sj = lo ? t.by - 1 : 0;
      }
      W[t.at(li, lj, k, nz)] = W[t.at(si, sj, k, nz)];
    }
    const int cx = tx > 1 ? 2 * t.by : 0, cy = ty > 1 ? 2 * t.bx : 0;
    if (cx + cy > 0) {
      copy_rows<true>(W, (const float*)out, cx + cy, nz, vec,
                      [&](int r, int& gr, int& wr) {
                        int li, lj, i, j;
                        if (r < cx) {
                          lj = r < t.by ? r : r - t.by;
                          li = r < t.by ? -1 : t.bx;
                          i = beyond(t.i0 + li, nx, xper);
                          j = t.j0 + lj;
                        } else {
                          r -= cx;
                          li = r < t.bx ? r : r - t.bx;
                          lj = r < t.bx ? -1 : t.by;
                          i = t.i0 + li;
                          j = beyond(t.j0 + lj, ny, yper);
                        }
                        gr = i < 0 || j < 0 ? -1 : i * ny + j;
                        wr = (li + 1) * (t.by + 2) + lj + 1;
                      });
      copies_done();
    }
    __syncthreads();
  }
  copy_rows<false>(W, out, t.bx * t.by, nz, vec, own_rows);
}

// The slab kernels: every axis periodic, none, some, then with z periodic
// of odd extent every axis periodic and some; f32 arithmetic, then the bf16
// tier's.
constexpr int kSlabForms = 5;
const void* const kSlabKernels[2][kSlabForms] = {
    {(const void*)relax_slab_kernel<1, float, false>,
     (const void*)relax_slab_kernel<0, float, false>,
     (const void*)relax_slab_kernel<-1, float, false>,
     (const void*)relax_slab_kernel<1, float, true>,
     (const void*)relax_slab_kernel<-1, float, true>},
    {(const void*)relax_slab_kernel<1, __nv_bfloat16, false>,
     (const void*)relax_slab_kernel<0, __nv_bfloat16, false>,
     (const void*)relax_slab_kernel<-1, __nv_bfloat16, false>,
     (const void*)relax_slab_kernel<1, __nv_bfloat16, true>,
     (const void*)relax_slab_kernel<-1, __nv_bfloat16, true>}};

template <typename C>
const void* slab_kernel(int per, bool zodd) {
  return kSlabKernels[std::is_same<C, __nv_bfloat16>::value ? 1 : 0]
                     [zodd ? (per == 1 ? 3 : 4)
                           : per == 1 ? 0 : per == 0 ? 1 : 2];
}

// Blocks of the kernels a level of the type and arithmetic launches that the
// current device runs at once, the slab kernels with `smem` bytes of shared
// memory each (the wrapper's budget), asked once per kernel and device; also
// sets that shared-memory limit on those slab kernels. odd: the level has a
// periodic axis of odd extent (the grid kernel's ODD form and every slab
// form); else the grid kernel's even form and the slab forms without a z
// wrap, so that no odd form decides an even level's blocks.
template <typename T, typename C>
cudaError_t relax_capacity(int smem, bool odd, int* capacity) {
  static int cache_grid[2][kMaxDevices] = {};
  static int cache_slab[kSlabForms][kMaxDevices] = {};
  int cap = 0;
  cudaError_t err = march_capacity(
      odd ? (const void*)relax_grid_kernel<T, C, true>
          : (const void*)relax_grid_kernel<T, C, false>,
      kThreads, 0, cache_grid[odd], &cap);
  const int tier = std::is_same<C, __nv_bfloat16>::value ? 1 : 0;
  const int forms = odd ? kSlabForms : 3;
  for (int f = 0; f < forms && err == cudaSuccess && sizeof(T) == 4; ++f) {
    int c = 0;
    err = march_capacity(kSlabKernels[tier][f], kThreads, smem,
                         cache_slab[f], &c);
    cap = c < cap ? c : cap;
  }
  *capacity = cap;
  return err;
}

// npatch levels of one shape: patch k's operands u[k], rhs[k], a[k], b[k]
// (b null, or b[k] null: constant bCoef) and out[k]; `blocks` blocks a
// patch, npatch * blocks in the launch; the passes in the arithmetic of C.
template <typename T, typename C>
cudaError_t relax_impl(const void* const* u, const void* const* rhs,
                       const void* const* a, const void* const* b,
                       void* const* out, void* faces, int npatch, int nx,
                       int ny, int nz,
                       const int* kinds, double rho, double alpha,
                       double beta, double dx, int base, int nsweeps,
                       int form, int per, int blocks, int xtiles,
                       const int* starts, int smem, cudaStream_t st) {
  const long long rows = (long long)nx * ny;
  if (nsweeps < 0 || 2 * nsweeps >= (1 << 16) || blocks < 1 || per < -1 ||
      per > 1 || rows * nz >= (1LL << 31) || form < FORM_GRID ||
      form > FORM_SERIAL || npatch < 1 || npatch > kMaxBatch)
    return cudaErrorInvalidValue;
  RelaxArgs<T> g = {};
  g.p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  const int fcells = face_cells(g.p);
  const bool zodd = odd_wrap(g.p, 2);
  // the grid form's in-place passes need the faces where there are any;
  // the slab form keeps its z wrap in shared memory (x and y wrap through
  // its halo, copied between passes)
  if (fcells > 0 && form != FORM_SLAB && faces == nullptr)
    return cudaErrorInvalidValue;
  bool has_b = false;
  unsigned long long bits = 0;  // of every pointer of the slab form
  for (int k = 0; k < npatch; ++k) {
    g.u[k] = (const T*)u[k];
    g.rhs[k] = (const T*)rhs[k];
    g.a[k] = (const T*)a[k];
    g.b[k] = b ? (const T*)b[k] : nullptr;
    g.out[k] = (T*)out[k];
    g.faces[k] = fcells > 0 && form != FORM_SLAB
        ? (T*)faces + (long long)k * fcells : nullptr;
    has_b = has_b || g.b[k] != nullptr;
    bits |= (unsigned long long)u[k] | (unsigned long long)rhs[k] |
            (unsigned long long)a[k] | (unsigned long long)out[k];
  }
  g.par = ((base % 2) + 2) % 2;
  g.npass = 2 * nsweeps;
  g.per = per;
  g.tiles = blocks;
  g.npatch = npatch;
  g.serial = form == FORM_SERIAL;
  if (!std::is_same<C, T>::value && has_b) return cudaErrorInvalidValue;
  const void* kern = fcells > 0
      ? (const void*)relax_grid_kernel<T, C, true>
      : (const void*)relax_grid_kernel<T, C, false>;
  if (form == FORM_SLAB) {
    // the slab form: f32, constant b, x and y cut in order into xtiles x
    // (blocks / xtiles) tiles, each tile's window, a and rhs within smem
    const int tx = xtiles, ty = xtiles > 0 ? blocks / xtiles : 0;
    if (sizeof(T) != 4 || has_b || blocks > kMaxSlabs || tx < 1 ||
        tx * ty != blocks || starts[0] != 0 || starts[tx] != nx ||
        starts[tx + 1] != 0 || starts[tx + 1 + ty] != ny)
      return cudaErrorInvalidValue;
    long long bx = 0, by = 0;
    for (int s = 0; s < tx + ty + 2; ++s) {
      const bool last = s == tx || s == tx + ty + 1;
      if (!last && starts[s + 1] <= starts[s]) return cudaErrorInvalidValue;
      if (!last) {
        const long long c = starts[s + 1] - starts[s];
        if (s < tx)
          bx = c > bx ? c : bx;
        else
          by = c > by ? c : by;
      }
      g.start[s] = starts[s];
    }
    if ((((bx + 2) * (by + 2) + 2 * bx * by) * nz + (zodd ? 2 * bx * by : 0))
            * (long long)sizeof(T) > smem)
      return cudaErrorInvalidValue;
    g.xtiles = tx;
    g.vec = nz % 4 == 0 && (bits & 15) == 0;
    kern = slab_kernel<C>(per, zodd);
  } else {
    smem = 0;
  }
  void* params[] = {(void*)&g};
  return cudaLaunchCooperativeKernel(kern,
                                     dim3(g.serial ? blocks : blocks * npatch),
                                     dim3(kThreads), params, (size_t)smem,
                                     st);
}

}  // namespace

// C entry point (csrc/mg_kernels.h's conventions): nsweeps red-black sweeps
// of the level u into out (u, rhs, a, b only read; b may be null: constant
// bCoef = 1). faces: scratch of fused_sweeps.face_cells(shape, kinds)
// elements for the grid form of a level with a periodic axis of odd extent
// (the wrapper allocates it), else null. base = sum(lo). compute: 0 the passes at the operands'
// precision, 1 in bf16 (f32 operands, b null). The launch geometry comes from
// fused_sweeps.gsrb_geometry: form (RelaxForm), per (1 every axis periodic,
// 0 none, -1 some), blocks, and for the slab form xtiles (tiles along x;
// blocks / xtiles along y), starts (the first plane of each x tile, then
// nx; the first row of each y tile, then ny) and smem bytes.
extern "C" int mgk_gsrb_relax(const void* u, const void* rhs, const void* a,
                              const void* b, void* out, void* faces,
                              int is_double,
                              int compute, int nx, int ny, int nz,
                              const int* kinds, double rho,
                              double alpha, double beta, double dx, int base,
                              int nsweeps, int form, int per, int blocks,
                              int xtiles, const int* starts, int smem,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const void* const us[1] = {u};
  const void* const rs[1] = {rhs};
  const void* const as[1] = {a};
  const void* const bs[1] = {b};
  void* const os[1] = {out};
  if (compute < 0 || compute > 1 || (compute == 1 && is_double))
    return (int)cudaErrorInvalidValue;
  if (compute == 1)
    return (int)relax_impl<float, __nv_bfloat16>(
        us, rs, as, bs, os, faces, 1, nx, ny, nz, kinds, rho, alpha, beta, dx,
        base, nsweeps, form, per, blocks, xtiles, starts, smem, st);
  return (int)(is_double
      ? relax_impl<double, double>(us, rs, as, bs, os, faces, 1, nx, ny, nz,
                                   kinds, rho, alpha, beta, dx, base, nsweeps,
                                   form, per, blocks, xtiles, starts, smem,
                                   st)
      : relax_impl<float, float>(us, rs, as, bs, os, faces, 1, nx, ny, nz,
                                 kinds, rho, alpha, beta, dx, base, nsweeps,
                                 form, per, blocks, xtiles, starts, smem,
                                 st));
}

// C entry point of the batch: npatch (at most kMaxBatch) levels of one
// shape, face kinds and parity (base = sum(lo) of any of them), constant
// bCoef; ptrs holds the patches' states u (only read), then rhs, a (only
// read) and the results out, npatch each, then the faces scratch of the
// grid and serial forms (mgk_gsrb_relax's, patch k's k * face cells in;
// null where the level has no periodic axis of odd extent); geo (kept per shape: one array a
// call) npatch, is_double, nx, ny, nz, nsweeps, form, per, blocks, xtiles,
// smem, the six face kinds, then the slab form's starts. `blocks` (and the
// slab form's xtiles, starts, smem) are one patch's launch geometry
// (fused_sweeps.gsrb_geometry at capacity / npatch): npatch * blocks blocks
// in one cooperative launch; in the serial form (form 2) one patch's grid
// form at the whole capacity, `blocks` blocks taking the patches in turn.
// The same arithmetic per cell as mgk_gsrb_relax.
extern "C" int mgk_gsrb_relax_batch(const void* const* ptrs, const int* geo,
                                    double rho, double alpha, double beta,
                                    double dx, int base, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int npatch = geo[0], is_double = geo[1], nx = geo[2], ny = geo[3];
  const int nz = geo[4], nsweeps = geo[5], form = geo[6], per = geo[7];
  const int blocks = geo[8], xtiles = geo[9], smem = geo[10];
  const int *kinds = geo + 11, *starts = geo + 17;
  if (npatch < 1 || npatch > kMaxBatch) return (int)cudaErrorInvalidValue;
  const void* const* u = ptrs;
  const void* const* rhs = ptrs + npatch;
  const void* const* a = ptrs + 2 * npatch;
  void* const* out = const_cast<void* const*>(ptrs + 3 * npatch);
  void* faces = const_cast<void*>(ptrs[4 * npatch]);
  return (int)(is_double
      ? relax_impl<double, double>(u, rhs, a, nullptr, out, faces, npatch, nx,
                                   ny, nz, kinds, rho, alpha, beta, dx, base,
                                   nsweeps, form, per, blocks, xtiles, starts,
                                   smem, st)
      : relax_impl<float, float>(u, rhs, a, nullptr, out, faces, npatch, nx,
                                 ny, nz, kinds, rho, alpha, beta, dx, base,
                                 nsweeps, form, per, blocks, xtiles, starts,
                                 smem, st));
}

// C entry point: *capacity <- blocks of the gsrb_relax kernels of the type
// and arithmetic (compute as mgk_gsrb_relax's) that the current device runs
// at once on a level with (odd 1) or without (0) a periodic axis of odd
// extent, the slab kernels with `smem` bytes of shared memory each.
extern "C" int mgk_gsrb_capacity(int is_double, int compute, int odd,
                                 int smem, int* capacity) {
  if (compute < 0 || compute > 1 || (compute == 1 && is_double) || odd < 0 ||
      odd > 1)
    return (int)cudaErrorInvalidValue;
  if (compute == 1)
    return (int)relax_capacity<float, __nv_bfloat16>(smem, odd, capacity);
  return (int)(is_double
      ? relax_capacity<double, double>(smem, odd, capacity)
      : relax_capacity<float, float>(smem, odd, capacity));
}
