// residual and residual_restrict: res = rhs - L(u) of one whole level with
// homogeneous ghosts (optional variable bCoef), written whole, or restricted
// by full weighting in the same launch (the mean of the 2^3 children, added
// in stencils.restrict_full's order: (di, dj, dk) nested, left to right,
// then times 1/8), so that the full-size residual is never written.
//
// Replaces the TPU kernels mg_ic_code_tpu/ops/fused_sweeps.py:
// resident_residual (its body resident_residual_values) and
// mg_ic_code_tpu/ops/pallas_kernels.py: residual (one pass at the big
// levels); the restricted form also the restriction the JAX package applies
// to their output (solver/composite.py:366-368, solver/multigrid.py:778-781),
// where XLA fuses it.
//
// What bounds it on this card: bytes. One read each of u, rhs and a (and b)
// and one write of res, or of res / 8 restricted, against ~20 operations a
// cell. The design keeps to that:
//  * A block owns a tile of ty whole y rows (all of z) and marches along x
//    through a segment of xseg planes. u of the tile's rows and of the row
//    above and below it, and rhs and a (and b) of the tile's rows, sit in a
//    ring of kRing planes in shared memory; plane i + kRing - 1 is fetched
//    by cp.async (16-byte copies past L1 where every row starts on 16
//    bytes) while plane i is computed, so that three planes are in flight
//    and no thread waits on device memory within a step. (A first form
//    loaded rhs and a into registers one plane ahead: every step then
//    waited about a load's latency, ~1 us on an H100.) A whole-row tile's
//    plane is one contiguous run of the level, read in its plain layout; a
//    tile row beyond a periodic y face is the wrapped one, beyond another
//    face it is not read (its ghost rule takes the interior neighbour). A
//    plane beyond a periodic x face is the wrapped one. One block barrier a
//    plane.
//  * A thread owns VZ consecutive cells (16 bytes where rows allow) of two
//    rows (j, j + 1), j even, so that in the restricted form it holds every
//    child of VZ / 2 coarse cells and sums them in registers across the
//    plane pair. u of its own cells at planes i - 1, i and i + 1 rotates in
//    registers (the x neighbours); the rows above and below, the z
//    neighbours and its rhs and a come from the ring.
//  * Indices within a plane are 32 bit (ny * nz < 2^31), the plane offset
//    64 bit.
//  * The face rules of x and y are evaluated only in the steps of a block
//    whose tile touches a y face or whose plane is an x face ("general"
//    steps); the others ("steady") add the neighbours. A z face is the
//    concern of the two threads at the ends of a row.
//  * The value of a cell is the expression of residual_device.cuh (which
//    the towers keep) in uncontracted intrinsics that fix each rounding as
//    the one thread a cell kernel before the march was compiled to
//    (face_sum, residual_value), so residual gives what that kernel gave
//    and residual_restrict gives restrict_full of residual, bit for bit.
//  * The tile height, the segment length, and so the grid, come from Python
//    (ops/fused_sweeps.residual_geometry), per level shape.
//  * A batch (mgk_residual_batch, the restricted form of the same-shape
//    sibling patches of an AMR depth): P levels of one shape in one launch,
//    blockIdx.y the patch, each with its own pointers and its own output
//    strides (each into its own parent's covered part). The segments are
//    cut so that the P x tiles x segments blocks fill one wave; where
//    segments of one plane pair fill it, each block a ring of RING = 4
//    planes (all the planes of its segment fetched at its start: a block
//    of two pairs waited a second load latency for its sixth plane), so
//    that a small pair's launch is not half idle. A cell's value does not
//    depend on the launch, so a batch is bit for bit P single calls; one
//    call is a batch of one.
#include <cstddef>

#include "residual_device.cuh"

namespace {

// Planes in the shared-memory ring (ops/fused_sweeps.RESIDUAL_RING): plane
// i and i + 1 read in step i, three more in flight; the restricted form is
// built with a ring of 4 too (a batch's segments of one plane pair).
constexpr int kRing = 5;
// Threads a block at most (RESIDUAL_MAX_THREADS), and the copies a thread
// makes of one plane of u: a tile's ty + 2 rows need at most 2 + 4 / ty
// times the threads that own its ty / 2 row pairs (of rhs, a and b, at most
// two each).
constexpr int kMaxThreads = 512;
constexpr int kMaxChunks = 4;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB a block

// patches of one batch at most (fused_sweeps.BATCH_MAX)
constexpr int kMaxBatch = 16;

// The operands of a launch: patch k's at index k (out strides: the
// restricted form's).
template <typename T>
struct Operands {
  const T* u[kMaxBatch];
  const T* rhs[kMaxBatch];
  const T* a[kMaxBatch];
  const T* b[kMaxBatch];  // null: constant bCoef
  T* out[kMaxBatch];
  long long osx[kMaxBatch], osy[kMaxBatch];
};

// The launch ops/fused_sweeps.residual_geometry picks.
struct ResidualGeom {
  int ty;      // rows of a y tile (even)
  int ntiles;  // y tiles; block b has tile b % ntiles, segment b / ntiles
  int xseg;    // planes of an x segment (even in the restricted form)
  int qpr;     // groups of VZ cells a row (nz / VZ)
  int slot;    // elements of one ring slot (residual_slot), 16-byte aligned
};

template <typename T, int N>
struct Vec;
template <>
struct Vec<float, 4> { using type = float4; };
template <>
struct Vec<float, 2> { using type = float2; };
template <>
struct Vec<double, 2> { using type = double2; };

__device__ __forceinline__ void unpack(float (&d)[4], const float4 v) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void unpack(float (&d)[2], const float2 v) {
  d[0] = v.x; d[1] = v.y;
}
__device__ __forceinline__ void unpack(double (&d)[2], const double2 v) {
  d[0] = v.x; d[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float (&d)[4]) {
  return make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ double2 pack(const double (&d)[2]) {
  return make_double2(d[0], d[1]);
}

// VZ cells of a ring slot (a slot row starts on VZ cells: VZ divides nz).
template <typename T, int VZ>
__device__ __forceinline__ void load_shared(T (&d)[VZ], const T* s) {
  if constexpr (VZ == 1) {
    d[0] = s[0];
  } else {
    unpack(d, *reinterpret_cast<const typename Vec<T, VZ>::type*>(s));
  }
}

template <typename T, int VZ, bool VEC>
__device__ __forceinline__ void store_global(T* g, const T (&d)[VZ]) {
  if constexpr (VEC) {
    *reinterpret_cast<typename Vec<T, VZ>::type*>(g) = pack(d);
  } else {
#pragma unroll
    for (int e = 0; e < VZ; ++e) g[e] = d[e];
  }
}

// VZ cells, global -> shared address dst, asynchronously: one 16-byte copy
// past L1 (VEC), or one copy a cell.
template <typename T, int VZ, bool VEC>
__device__ __forceinline__ void copy_cells(unsigned dst, const T* src) {
  if constexpr (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < VZ; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                       dst + (unsigned)(e * sizeof(T))),
                   "l"(src + e), "n"(sizeof(T))
                   : "memory");
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The arithmetic of a cell in round-to-nearest intrinsics, which the
// compiler never contracts: each step is the one the kernel before the
// march was compiled to on sm_90a (its SASS: the ghost c0 * u rounded, then
// fused with c1 times the interior neighbour; lap = fma(-6, u, s0 + (s1 +
// s2)); rhs - fma(alpha * a, u, -(b_inv * lap))), so that the residual
// stays bit for bit what that kernel gave, in every instantiation.
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}
__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float fma_rn(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_rn(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

// The neighbour sum of one axis at one cell: vp + vm, where a non-periodic
// face replaces the neighbour across it by its ghost c0 * uc + c1 * (the
// interior neighbour). At a hi face vp must hold that interior neighbour
// (the one below), at a lo face vm the one above.
template <typename T>
__device__ __forceinline__ T face_sum(T vp, T vm, T uc, bool lo, bool hi,
                                      T c0lo, T c1lo, T c0hi, T c1hi) {
  const T up = hi ? fma_rn(c1hi, vp, mul_rn(c0hi, uc)) : vp;
  const T um = lo ? fma_rn(c1lo, vm, mul_rn(c0lo, uc)) : vm;
  return add_rn(up, um);
}

// The residual of a cell from its three axis sums.
template <typename T>
__device__ __forceinline__ T residual_value(T s0, T s1, T s2, T uc, T rhs,
                                            T a, T b_inv, T alpha) {
  const T lap = fma_rn((T)-6, uc, add_rn(s0, add_rn(s1, s2)));
  return add_rn(rhs, -fma_rn(mul_rn(alpha, a), uc, -mul_rn(b_inv, lap)));
}

// The residual of the thread's two rows (j, j + 1) of VZ cells at plane i:
// u of its cells at planes i - 1, i, i + 1 (pv, cv, nv), of the row above
// and below (up, dn), the z neighbours beyond its cells (zl, zr). GEN: the
// step touches an x or a y face, whose rule is applied per cell; otherwise
// only the thread's own z faces (zlo, zhi) can.
template <bool GEN, typename T, int VZ>
__device__ __forceinline__ void rows_residual(
    T (&res)[2][VZ], const T (&pv)[2][VZ], const T (&cv)[2][VZ],
    const T (&nv)[2][VZ], const T (&up)[VZ], const T (&dn)[VZ],
    const T (&zl)[2], const T (&zr)[2], const T (&rc)[2][VZ],
    const T (&ac)[2][VZ], const T (&bc)[2][VZ], bool has_b,
    const LevelParams<T>& p, int i, int j, bool zlo, bool zhi) {
  const bool xlo = GEN && !p.periodic[0] && i == 0;
  const bool xhi = GEN && !p.periodic[0] && i == p.nx - 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ylo = GEN && !p.periodic[1] && j + r == 0;
    const bool yhi = GEN && !p.periodic[1] && j + r == p.ny - 1;
#pragma unroll
    for (int e = 0; e < VZ; ++e) {
      const T uc = cv[r][e];
      const T xp = nv[r][e], xm = pv[r][e];
      const T s0 = face_sum(xhi ? xm : xp, xlo ? xp : xm, uc, xlo, xhi,
                            p.c0[0][0], p.c1[0][0], p.c0[0][1], p.c1[0][1]);
      const T yp = r == 0 ? cv[1][e] : dn[e];
      const T ym = r == 0 ? up[e] : cv[0][e];
      const T s1 = face_sum(yhi ? ym : yp, ylo ? yp : ym, uc, ylo, yhi,
                            p.c0[1][0], p.c1[1][0], p.c0[1][1], p.c1[1][1]);
      const T zp = e + 1 < VZ ? cv[r][e + 1] : zr[r];
      const T zm = e > 0 ? cv[r][e - 1] : zl[r];
      const bool lo = e == 0 && zlo, hi = e == VZ - 1 && zhi;
      const T s2 = face_sum(hi ? zm : zp, lo ? zp : zm, uc, lo, hi,
                            p.c0[2][0], p.c1[2][0], p.c0[2][1], p.c1[2][1]);
      T b_inv = p.b_inv;
      if (has_b) b_inv = mul_rn(b_inv, bc[r][e]);
      res[r][e] = residual_value(s0, s1, s2, uc, rc[r][e], ac[r][e], b_inv,
                                 p.alpha);
    }
  }
}

template <typename T, int VZ, bool VEC, bool RESTRICT, int RING>
__global__ void __launch_bounds__(kMaxThreads)
    residual_kernel(const __grid_constant__ Operands<T> ops,
                    const LevelParams<T> p, const ResidualGeom g) {
  // this block's patch
  const int patch = blockIdx.y;
  const T* __restrict__ u = ops.u[patch];
  const T* __restrict__ rhs = ops.rhs[patch];
  const T* __restrict__ a = ops.a[patch];
  const T* __restrict__ b = ops.b[patch];
  T* __restrict__ out = ops.out[patch];
  const long long osx = ops.osx[patch], osy = ops.osy[patch];
  extern __shared__ __align__(16) unsigned char residual_smem[];
  T* const ring = reinterpret_cast<T*>(residual_smem);
  const unsigned ring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const bool xper = p.periodic[0], yper = p.periodic[1];
  const bool zper = p.periodic[2];
  const size_t plane = (size_t)ny * nz;
  const int j0 = (blockIdx.x % g.ntiles) * g.ty;
  const int x0 = (blockIdx.x / g.ntiles) * g.xseg;
  const int x1 = min(x0 + g.xseg, nx);
  const int rows = min(g.ty, ny - j0);
  const bool has_b = b != nullptr;
  // a slot: u of level rows j0 - 1 .. j0 + rows (slot rows 0 .. rows + 1),
  // then rhs, a (and b) of the tile's rows, ty rows each
  const int rhs_at = (g.ty + 2) * nz, a_at = rhs_at + g.ty * nz;
  const int b_at = a_at + g.ty * nz;

  // This thread's share of the copy of u's rows: slot row r holds level
  // row j0 - 1 + r (wrapped across a periodic y face; across another face
  // not copied). The tile's rows of rhs, a and b are one run of the level:
  // the thread's chunks of it are tid and tid + blockDim.
  int csrc[kMaxChunks], cdst[kMaxChunks];
#pragma unroll
  for (int n = 0; n < kMaxChunks; ++n) {
    const int c = threadIdx.x + n * blockDim.x;
    const int r = c / g.qpr, q = c - r * g.qpr;
    int gr = j0 - 1 + r;
    if (yper) gr = gr < 0 ? gr + ny : (gr >= ny ? gr - ny : gr);
    const bool copy = r < rows + 2 && gr >= 0 && gr < ny;
    csrc[n] = copy ? gr * nz + q * VZ : -1;
    cdst[n] = r * nz + q * VZ;
  }
  const int run = rows * g.qpr;  // chunks of a tile's run
  // plane x (x0 - 1 <= x <= x1) into ring slot s: u (beyond a non-periodic
  // x face nothing: the face rule reads the interior plane; beyond a
  // periodic one the wrapped plane), and rhs, a, b of the planes the block
  // computes
  auto fetch = [&](int x, int s) {
    const unsigned dst = ring_s + (unsigned)(s * g.slot * (int)sizeof(T));
    if (x >= x0 && x < x1) {
      const size_t o = (size_t)x * plane + (size_t)j0 * nz;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = (threadIdx.x + n * blockDim.x) * VZ;
        if (c < run * VZ) {
          copy_cells<T, VZ, VEC>(
              dst + (unsigned)((rhs_at + c) * (int)sizeof(T)), rhs + o + c);
          copy_cells<T, VZ, VEC>(
              dst + (unsigned)((a_at + c) * (int)sizeof(T)), a + o + c);
          if (has_b)
            copy_cells<T, VZ, VEC>(
                dst + (unsigned)((b_at + c) * (int)sizeof(T)), b + o + c);
        }
      }
    }
    if (x < 0 || x >= nx) {
      if (!xper) return;
      x = x < 0 ? x + nx : x - nx;
    }
    const T* src = u + (size_t)x * plane;
#pragma unroll
    for (int n = 0; n < kMaxChunks; ++n)
      if (csrc[n] >= 0)
        copy_cells<T, VZ, VEC>(dst + (unsigned)(cdst[n] * (int)sizeof(T)),
                               src + csrc[n]);
  };
  // planes x0 - 1 .. x0 + RING - 2 into slots 0 .. RING - 1, one commit
  // group a plane (empty beyond the segment)
#pragma unroll
  for (int n = 0; n < RING; ++n) {
    if (x0 - 1 + n <= x1) fetch(x0 - 1 + n, n);
    copy_commit();
  }

  // the thread's cells: rows j, j + 1 (slot rows rj, rj + 1; tile rows
  // rj - 1, rj), z from k
  const int pair = threadIdx.x / g.qpr;
  const int k = (threadIdx.x - pair * g.qpr) * VZ;
  const int j = j0 + 2 * pair, rj = 2 * pair + 1;
  const bool active = 2 * pair < rows;
  const bool second = 2 * pair + 1 < rows;  // row j + 1 is in the level
  const bool zlo = !zper && k == 0, zhi = !zper && k + VZ == nz;
  // the column left and right of the thread's cells (its own where a face
  // of z is there: not read by the rule)
  const int kl = k == 0 ? (zper ? nz - 1 : k) : k - 1;
  const int kr = k + VZ == nz ? (zper ? 0 : k) : k + VZ;
  const bool ytouch = !yper && (j0 == 0 || j0 + rows == ny);
  const int own = (rj - 1) * nz + k;  // the thread's first cell in a run

  // u of the thread's cells at planes i - 1, i, i + 1
  T pv[2][VZ], cv[2][VZ], nv[2][VZ];
  T acc[VZ / 2 > 0 ? VZ / 2 : 1] = {};
  copy_wait<RING - 3>();  // planes x0 - 1, x0, x0 + 1
  __syncthreads();
  if (active) {
    load_shared<T, VZ>(pv[0], ring + rj * nz + k);
    load_shared<T, VZ>(pv[1], ring + (rj + 1) * nz + k);
    load_shared<T, VZ>(cv[0], ring + g.slot + rj * nz + k);
    load_shared<T, VZ>(cv[1], ring + g.slot + (rj + 1) * nz + k);
  }

  int s = 1;  // ring slot of plane i
  for (int i = x0; i < x1; ++i) {
    copy_wait<RING - 3>();  // plane i + 1
    __syncthreads();         // and everyone's; slot of plane i - 1 free
    const int sm = s == 0 ? RING - 1 : s - 1;
    const int sp = s == RING - 1 ? 0 : s + 1;
    if (i - 1 + RING <= x1) fetch(i - 1 + RING, sm);
    copy_commit();
    if (active) {
      const T* cur = ring + s * g.slot;
      const T* nxt = ring + sp * g.slot;
      load_shared<T, VZ>(nv[0], nxt + rj * nz + k);
      load_shared<T, VZ>(nv[1], nxt + (rj + 1) * nz + k);
      T up[VZ], dn[VZ], rc[2][VZ], ac[2][VZ], bc[2][VZ] = {};
      load_shared<T, VZ>(up, cur + (rj - 1) * nz + k);
      load_shared<T, VZ>(dn, cur + (rj + 2) * nz + k);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        load_shared<T, VZ>(rc[r], cur + rhs_at + own + r * nz);
        load_shared<T, VZ>(ac[r], cur + a_at + own + r * nz);
        if (has_b) load_shared<T, VZ>(bc[r], cur + b_at + own + r * nz);
      }
      const T zl[2] = {cur[rj * nz + kl], cur[(rj + 1) * nz + kl]};
      const T zr[2] = {cur[rj * nz + kr], cur[(rj + 1) * nz + kr]};
      T res[2][VZ];
      if (ytouch || (!xper && (i == 0 || i == nx - 1)))
        rows_residual<true>(res, pv, cv, nv, up, dn, zl, zr, rc, ac, bc,
                            has_b, p, i, j, zlo, zhi);
      else
        rows_residual<false>(res, pv, cv, nv, up, dn, zl, zr, rc, ac, bc,
                             has_b, p, i, j, zlo, zhi);
      if constexpr (RESTRICT) {
        // children (di, dj, dk) in restrict_full's order; x0 is even
        const bool first = (i & 1) == 0;
#pragma unroll
        for (int c = 0; c < VZ / 2; ++c) {
          T sum = first ? res[0][2 * c] : add_rn(acc[c], res[0][2 * c]);
          sum = add_rn(sum, res[0][2 * c + 1]);
          sum = add_rn(sum, res[1][2 * c]);
          sum = add_rn(sum, res[1][2 * c + 1]);
          acc[c] = sum;
        }
        if (!first) {
          T* o = out + (long long)(i >> 1) * osx + (long long)(j >> 1) * osy +
                 (k >> 1);
#pragma unroll
          for (int c = 0; c < VZ / 2; ++c) o[c] = mul_rn(acc[c], (T)0.125);
        }
      } else {
        T* o = out + (size_t)i * plane + (size_t)j * nz + k;
        store_global<T, VZ, VEC>(o, res[0]);
        if (second) store_global<T, VZ, VEC>(o + nz, res[1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < VZ; ++e) {
          pv[r][e] = cv[r][e];
          cv[r][e] = nv[r][e];
        }
      }
    }
    s = sp;
  }
  copy_wait<0>();
}

// The shared memory a block of the kernel may take, raised once per device
// to kMaxSmem (above 48 KB only once the kernel's limit is raised).
template <typename T, int VZ, bool VEC, bool RESTRICT, int RING>
cudaError_t raise_smem() {
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(residual_kernel<T, VZ, VEC, RESTRICT, RING>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

// One instantiation of the kernel, as a type.
template <typename T_, int VZ_, bool VEC_, bool RESTRICT_, int RING_>
struct Form {
  using T = T_;
  static constexpr int VZ = VZ_, RING = RING_;
  static constexpr bool VEC = VEC_, RESTRICT = RESTRICT_;
};

// f(Form<...>{}) for the instantiation (VZ, VEC, restricted, ring) of type
// T: 16 bytes a thread, two cells or one (the whole residual only); a ring
// of kRing planes, or of 4 (the restricted form only).
template <typename T, typename F>
cudaError_t with_form(int vz, int vec, int restricted, int ring, F&& f) {
  constexpr int V = 16 / (int)sizeof(T);  // cells of a 16-byte copy
  if (ring == 4 && restricted) {
    if (vz == V && vec) return f(Form<T, V, true, true, 4>{});
    if (vz == 2 && !vec) return f(Form<T, 2, false, true, 4>{});
    return cudaErrorInvalidValue;
  }
  if (ring != kRing) return cudaErrorInvalidValue;
  if (vz == V && vec)
    return restricted ? f(Form<T, V, true, true, kRing>{})
                      : f(Form<T, V, true, false, kRing>{});
  if (vz == 2 && !vec)
    return restricted ? f(Form<T, 2, false, true, kRing>{})
                      : f(Form<T, 2, false, false, kRing>{});
  if (vz == 1 && !vec && !restricted)
    return f(Form<T, 1, false, false, kRing>{});
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Operands<T>& ops, int npatch,
                   const LevelParams<T>& p, const ResidualGeom& g, int vz,
                   int vec, int restricted, int ring, int blocks,
                   int threads, int smem, cudaStream_t stream) {
  return with_form<T>(vz, vec, restricted, ring, [&](auto form) {
    using F = decltype(form);
    cudaError_t err =
        raise_smem<typename F::T, F::VZ, F::VEC, F::RESTRICT, F::RING>();
    if (err != cudaSuccess) return err;
    residual_kernel<typename F::T, F::VZ, F::VEC, F::RESTRICT, F::RING>
        <<<dim3(blocks, npatch), threads, smem, stream>>>(ops, p, g);
    return cudaGetLastError();
  });
}

// npatch levels of one shape (geo), patch k's operands at index k of each
// table (b null, or b[k] null: constant bCoef; osx, osy null: 0).
template <typename T>
cudaError_t residual_impl(const void* const* u, const void* const* rhs,
                          const void* const* a, const void* const* b,
                          void* const* out, const long long* osx,
                          const long long* osy, int npatch, const int* kinds,
                          double rho, double alpha, double beta, double dx,
                          const int* geo, cudaStream_t st) {
  const int nx = geo[1], ny = geo[2], nz = geo[3];
  const int vz = geo[4], vec = geo[5], restricted = geo[6];
  const ResidualGeom g{geo[7], geo[8], geo[9], geo[11], geo[12]};
  const int blocks = geo[8] * geo[10], threads = geo[13], smem = geo[14];
  if (threads > kMaxThreads || smem > kMaxSmem || npatch < 1 ||
      npatch > kMaxBatch)
    return cudaErrorInvalidValue;
  Operands<T> ops = {};
  for (int k = 0; k < npatch; ++k) {
    ops.u[k] = (const T*)u[k];
    ops.rhs[k] = (const T*)rhs[k];
    ops.a[k] = (const T*)a[k];
    ops.b[k] = b ? (const T*)b[k] : nullptr;
    ops.out[k] = (T*)out[k];
    ops.osx[k] = osx ? osx[k] : 0;
    ops.osy[k] = osy ? osy[k] : 0;
  }
  const auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta,
                                      dx);
  return launch<T>(ops, npatch, p, g, vz, vec, restricted, geo[22], blocks,
                   threads, smem, st);
}

}  // namespace

// C entry point of both forms; b may be null (constant bCoef = 1), out must
// not overlap the inputs. geo (ops/fused_sweeps.residual_geometry): is
// double, nx, ny, nz, VZ, VEC, restrict, ty, y tiles, xseg, x segments,
// groups a row, slot elements, threads, shared-memory bytes, patches, the
// six face kinds (the batch's), the ring's planes. The restricted
// form writes out[ci * osx + cj * osy + ck] (z contiguous).
extern "C" int mgk_residual(const void* u, const void* rhs, const void* a,
                            const void* b, void* out, const int* kinds,
                            double rho, double alpha, double beta, double dx,
                            const int* geo, long long osx, long long osy,
                            void* stream) {
  const void* const us[1] = {u};
  const void* const rs[1] = {rhs};
  const void* const as[1] = {a};
  const void* const bs[1] = {b};
  void* const os[1] = {out};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(geo[0]
      ? residual_impl<double>(us, rs, as, bs, os, &osx, &osy, 1, kinds, rho,
                              alpha, beta, dx, geo, st)
      : residual_impl<float>(us, rs, as, bs, os, &osx, &osy, 1, kinds, rho,
                             alpha, beta, dx, geo, st));
}

// C entry point of the batch: npatch (at most kMaxBatch) levels of one
// shape and face kinds, constant bCoef; ptrs holds the patches' u, then
// rhs, a and out, npatch each, strides their outputs' osx, then osy (the
// restricted form); geo as mgk_residual's, its segments cut for npatch
// patches, then npatch and the six face kinds (kept per shape: one array a
// call), in one launch.
extern "C" int mgk_residual_batch(const void* const* ptrs,
                                  const long long* strides, double rho,
                                  double alpha, double beta, double dx,
                                  const int* geo, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int npatch = geo[15];
  const int* kinds = geo + 16;
  if (npatch < 1 || npatch > kMaxBatch) return (int)cudaErrorInvalidValue;
  const void* const* u = ptrs;
  const void* const* rhs = ptrs + npatch;
  const void* const* a = ptrs + 2 * npatch;
  void* const* out = const_cast<void* const*>(ptrs + 3 * npatch);
  const long long* osx = strides;
  const long long* osy = strides + npatch;
  return (int)(geo[0]
      ? residual_impl<double>(u, rhs, a, nullptr, out, osx, osy, npatch,
                              kinds, rho, alpha, beta, dx, geo, st)
      : residual_impl<float>(u, rhs, a, nullptr, out, osx, osy, npatch,
                             kinds, rho, alpha, beta, dx, geo, st));
}

// Blocks of the instantiation (is_double, VZ, VEC, restricted, ring) with
// `threads` threads and `smem` bytes of shared memory that one
// multiprocessor of the current device runs at once: the wave that
// ops/fused_sweeps.residual_geometry fills.
extern "C" int mgk_residual_capacity(int is_double, int vz, int vec,
                                     int restricted, int ring, int threads,
                                     int smem, int* per_sm) {
  auto ask = [&](auto form) {
    using F = decltype(form);
    cudaError_t err =
        raise_smem<typename F::T, F::VZ, F::VEC, F::RESTRICT, F::RING>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm,
        residual_kernel<typename F::T, F::VZ, F::VEC, F::RESTRICT, F::RING>,
        threads, (size_t)smem);
  };
  return (int)(is_double
                   ? with_form<double>(vz, vec, restricted, ring, ask)
                   : with_form<float>(vz, vec, restricted, ring, ask));
}
