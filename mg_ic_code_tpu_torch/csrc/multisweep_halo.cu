// The multisweep march (csrc/multisweep_march.cuh, which says what it
// computes) on ONE SHARD of a level cut over a device mesh (parallel/
// halo.py): an x-slab whose neighbours' rows sit in (2H, ny, nz) pads beside
// it (ops/fused_sweeps.multisweep_relax(halo=...), the JAX package's
// mg_ic_code_tpu/ops/fused_sweeps.py:378 multisweep_relax in its halo form),
// or an (x, y) pencil prepadded by H on both sides of x and y
// (ops/fused_sweeps.multisweep_relax_tiled_pre, :1540
// multisweep_relax_tiled_pre). A seam between shards is an open segment end
// whose planes come from the pads; only the faces flagged as the domain's
// take the ghost rule; the parity and the y face rule stay in the level's
// frame (x_off and y_off in `base`, y_off and ny_global for the y faces).
//
// What bounds it: as for the whole level (csrc/multisweep.cu), not bytes
// but the time of one step of the march, i.e. of one plane: the
// instructions of a step, the wait for the plane that enters, and the block
// barrier. The body is the whole level's design for the H100, carried over
// and kept in a unit of its own (one template serving both cost the whole
// level 24-38 % once):
//  * A ring of R = NP + D + 1 planes in shared memory holds u (colour-split,
//    WaveLayout: no bank conflicts) and a and rhs of every column of the
//    tile. Plane t + D comes in by cp.async, one commit group per plane,
//    right after the barrier of step t; before a step a thread waits only
//    for its own copies of plane t + 1. No step waits on device memory.
//  * Where a plane comes from is the source policy (ShardSource): planes
//    in [0, nx) from the shard; an x-slab's planes beyond a seam from its
//    pads' rows (q + NP below, q - nx + NP above); a pencil's from the same
//    prepadded array, whose y pad columns belong to the tile. A pad at a
//    domain face is never read: the segment stops at that face.
//  * a and rhs move in 16-byte cp.async.cg chunks of rows where every row
//    of every operand starts on 16 bytes (nz a multiple of the chunk and all
//    six pointers aligned: the pad slices the sharded relax passes start at
//    row h_max - H); otherwise one element a column, in an instantiation of
//    its own chosen at launch.
//  * The tile width and the x segments are the caller's
//    (ops/fused_sweeps.shard_geometry_on, the whole level's rule on the
//    shard's written extent); the forms built are SHARD_FORMS, with the
//    whole level's widths.
//  * Steady steps (compile-time ring slots, no validity tests, no x-face
//    rule) wherever the staircase lies inside the segment and off the
//    domain's x faces; a seam's pads are no reason to leave them, since a
//    plane's source is picked per plane when it is fetched.
//  * The update in residual form, recip() with a Newton step, dead columns
//    updated without a branch and read only with weight 0, both finished
//    columns of a pair in one store: as in the whole level.
//  * The bf16 tier (`compute` 1 of the entries): every float form built
//    again with C = __nv_bfloat16, its passes the whole level's tier update
//    (the header's fold of a plane once, in place, at its first pass, and u
//    rounded once where its copies land, seam and pad planes too; the
//    passes from the same reads), the x faces folded where they are the
//    domain's and the y faces in the level's frame. So the kept cells of a
//    shard are, bit for bit, what the whole-level bf16 march gives them.
#include <cstdint>
#include <type_traits>

#include "multisweep_march.cuh"

namespace {

// The forms built: (type, colour passes NP = 2*nsweeps, tile width W,
// planes fetched ahead D), each with a and rhs in 16-byte chunks (V) and
// without, for both sources; each float form also in the bf16 tier. Each
// must fit the 227 KB of shared memory a block may use: R * (PLANE +
// 2*W*W) * sizeof(T), R = NP + D + 1.
// The widths are MARCH_FORMS' (csrc/multisweep.cu), which
// ops/fused_sweeps.MARCH_TILES lists per (itemsize, nsweeps) for both.
#define SHARD_FORMS(X) \
  X(float, 4, 40, 3)   \
  X(float, 4, 44, 2)   \
  X(float, 8, 36, 2)   \
  X(double, 4, 32, 2)  \
  X(double, 8, 24, 2)

// Where the march reads its planes, a template parameter so that each form
// compiles to its own code:
//   SRC_SLAB:  an x-slab, u at its cell (0, 0, 0); a plane outside [0, nx)
//              (only beyond a seam) in the (2H, ny, nz) pads, H = NP: rows
//              [0, H) below the slab, [H, 2H) above;
//   SRC_PRE:   a pencil prepadded by H on both sides of x and y, u at its
//              cell (0, 0, 0); rows -H .. ny + H - 1 of a plane are the
//              tile's, those beyond a y face of the domain dead; its y face
//              rule fires at global rows 0 and ny_global - 1 (y_off + row).
//              out has its own plane stride.
// The same for rhs and a.
enum ShardSource { SRC_SLAB = 1, SRC_PRE = 2 };

// The source's shape.
struct ShardGeom {
  long long sx, sxo;     // plane strides of the inputs and of out
  int face_lo, face_hi;  // the x faces at planes 0 and nx - 1 are the
                         // domain's (else seams)
  int y_off, ny_global;  // SRC_PRE
};

// What a launch reads: u, rhs, a at cell (0, 0, 0), the SRC_SLAB pads.
template <typename T>
struct ShardSrc {
  const T* u; const T* rhs; const T* a;
  const T* upad; const T* rpad; const T* apad;
  ShardGeom g;
};

// One z-pair of a tile row: where its columns live in a plane and in the
// rings, and the folded weights of the y and z faces they touch. Column c of
// the pair lives in colour half h = c ^ jb of its row (jb: row parity).
template <typename T>
struct ShardPair {
  T* cell;         // u ring slot 0: the pair's place in half 0 of its row
  const T* co;     // a of the pair in slot 0 of the a, rhs ring
  unsigned scell, sco;  // the same as shared-memory addresses
  // V: the chunks of a or rhs this pair fetches: offset in a plane, whether
  // it is rhs's, whether it holds cells, shared address in slot 0
  int chunk_off[2];
  bool chunk_rhs[2], chunk_in[2];
  unsigned chunk_dst[2];
  int coff[2];     // offset of each column inside a plane (row stride nz)
  int par;         // row + first column + base, unwrapped indices
  int jb;          // row parity
  bool live[2], own[2];
  bool own_both;   // both columns written, side by side, the first at an
                   // even offset: one 2-wide store
  T wya, wyb;        // weight of the y+1 / y-1 neighbour (0 across a face,
  T wza[2], wzb[2];  //   1 + c1 at it, 1 inside), same for z per column
  T cs6[2];          // c0 feed-through of the y and z faces, minus 6
  AxisFold<T> fy, fz[2];  // the bf16 tier's folds of the y and z faces
  unsigned my, mz[2];     // and the lanes of their pairs (face_mask)
  T tcs[2];          // the tier's c0 sum of a plane off the x faces
};

template <typename T>
struct ShardThread {
  const T* u; const T* rhs; const T* a; T* out;
  const T* upad; const T* rpad; const T* apad;  // SRC_SLAB
  long long sx, sxo;        // plane strides of the inputs and (SRC_PRE)
                            // of out
  int xs, xe, x0, x1, nx;   // planes worked on [xs, xe), written [x0, x1)
  bool face_lo, face_hi;    // plane 0 / nx-1 lies at an x face of the domain
  bool px, py, pz;          // the level's axes are periodic
  T alpha, six_b_inv, b_inv;
  T c0xlo, c1xlo, c0xhi, c1xhi;  // x-face ghost rule
  ShardPair<T> p;
};

// Row uj of a tile (unwrapped, in the shard's frame): its row gj in a plane
// of the source, and whether it holds cells. An x-slab has the level's whole
// y (a periodic y wraps modulo ny); a pencil's rows -NP .. ny + NP - 1 lie
// in its pads, but for those beyond a y face of the domain.
template <int SRC, int NP, typename T>
__device__ __forceinline__ bool shard_row(int uj, const LevelParams<T>& p,
                                          const ShardGeom& g, int& gj) {
  const bool py = p.periodic[1] != 0;
  gj = uj;
  if constexpr (SRC == SRC_PRE) {
    const int yg = uj + g.y_off;
    return uj >= -NP && uj < p.ny + NP &&
           (py || (yg >= 0 && yg < g.ny_global));
  }
  if (py) {
    gj = uj % p.ny;
    if (gj < 0) gj += p.ny;
    return true;
  }
  return uj >= 0 && uj < p.ny;
}

// Start the copies of plane q (xs <= q < xe) into ring slot s: u of the
// thread's live columns (one element a copy), and their a and rhs: one
// element a copy into the pair's colour halves, or (V) 16-byte chunks of
// rows into the plane's own layout, bypassing L1. An x-slab's plane outside
// [0, nx) is row q + NP (below) or q - nx + NP (above) of its pads.
template <typename T, int NP, int W, bool V, int SRC>
__device__ __forceinline__ void fetch_plane(const ShardThread<T>& w, int q,
                                            int s) {
  using L = WaveLayout<W, W>;
  constexpr int NPAIR = W * W / 2;
  constexpr unsigned B = sizeof(T);
  bool pad = false;
  int row = q;
  if constexpr (SRC == SRC_SLAB) {
    if (q < 0) { pad = true; row = q + NP; }
    if (q >= w.nx) { pad = true; row = q - w.nx + NP; }
  }
  const long long o = (long long)row * w.sx;
  const T* u = (pad ? w.upad : w.u) + o;
  const T* a = (pad ? w.apad : w.a) + o;
  const T* r = (pad ? w.rpad : w.rhs) + o;
  const ShardPair<T>& p = w.p;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!p.live[c]) continue;
    const unsigned h = (unsigned)(c ^ p.jb);
    copy_async(p.scell + (s * L::PLANE + h * L::HP) * B, u + p.coff[c]);
    if (!V) {
      copy_async(p.sco + (4 * s + h) * NPAIR * B, a + p.coff[c]);
      copy_async(p.sco + (4 * s + 2 + h) * NPAIR * B, r + p.coff[c]);
    }
  }
  if (V) {
#pragma unroll
    for (int k = 0; k < (int)(B / 4); ++k)
      if (p.chunk_in[k])
        copy_chunk(p.chunk_dst[k] + s * 2 * W * W * B,
                   (p.chunk_rhs[k] ? r : a) + p.chunk_off[k]);
  }
}

// The bf16 tier's fold of plane q in ring slot s (T float), in place, as the
// whole level's (csrc/multisweep.cu: tier_fold_plane): the x faces where
// the shard's are the domain's, none in a steady step.
template <typename T, int W, bool V, bool STEADY>
__device__ __forceinline__ void tier_fold_plane(const ShardThread<T>& w,
                                                int q, int s) {
  constexpr int NPAIR = W * W / 2;
  const ShardPair<T>& p = w.p;
  const bool xlo = !STEADY && w.face_lo && q == 0;
  const bool xhi = !STEADY && w.face_hi && q == w.nx - 1;
  const AxisFold<T> fx =
      face_fold<T>(xlo, xhi, w.c0xlo, w.c1xlo, w.c0xhi, w.c1xhi);
  T* const co = const_cast<T*>(p.co) + s * 2 * W * W;
  T c_sum[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    c_sum[c] = p.tcs[c];
    if (!STEADY) {
      c_sum[c] = (T)0;
      if (!w.px) c_sum[c] += fx.c;
      if (!w.py) c_sum[c] += p.fy.c;
      if (!w.pz) c_sum[c] += p.fz[c].c;
    }
  }
  if constexpr (V) {  // the pair's columns side by side
    march_tier_fold2(co, co + W * W, c_sum, p.live, w.alpha, w.six_b_inv,
                     w.b_inv);
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!p.live[c]) continue;
      T* const ca = co + (c ^ p.jb) * NPAIR;
      march_tier_fold(ca, ca + W * W, c_sum[c], w.alpha, w.six_b_inv,
                      w.b_inv);
    }
  }
}

// The bf16 tier's pass of the pair's column c in plane q (T float), as the
// whole level's (tier_update there): the x faces where the shard's are the
// domain's, none in a steady step.
template <typename T, bool STEADY>
__device__ __forceinline__ T tier_update(const ShardThread<T>& w, int q,
                                         int c, T P, T kt, T uc, T upv,
                                         T umv, T ypv, T ymv, T zpv,
                                         T zmv) {
  const ShardPair<T>& p = w.p;
  const bool xlo = !STEADY && w.face_lo && q == 0;
  const bool xhi = !STEADY && w.face_hi && q == w.nx - 1;
  const AxisFold<T> fx =
      face_fold<T>(xlo, xhi, w.c0xlo, w.c1xlo, w.c0xhi, w.c1xhi);
  const bool per[3] = {w.px, w.py, w.pz};
  const T up[3] = {upv, ypv, zpv}, um[3] = {umv, ymv, zmv};
  return march_tier_cell<STEADY>(P, kt, uc, up, um, per, fx, p.fy, p.my,
                                 pick(c, p.fz), pick(c, p.mz));
}

// One step of the march: pass ps works on plane t - ps for ps = 0 .. NP-1,
// in each pair's column whose cells have this step's colour; plane t + D is
// fetched; both columns of plane t - NP + 1 are final and written.
//
// STEADY: every plane t + D .. t - NP lies inside (xs, xe), so no pass needs
// a validity test or an x-face rule (a domain face bounds the segment), and
// the ring slot of plane t is the compile-time ST. Otherwise `st_rt` is t's
// slot and every pass is tested. C: the passes' arithmetic (T, or
// __nv_bfloat16 beside float: tier_update).
template <typename T, int NP, int W, int D, bool V, int SRC, typename C,
          bool STEADY, int ST, int PER = -1>
__device__ __forceinline__ void march_step(ShardThread<T>& w, const int t,
                                           const int st_rt) {
  constexpr bool TIER = !std::is_same<C, T>::value;
  using L = WaveLayout<W, W>;
  constexpr int R = NP + D + 1;
  constexpr int HP = L::HP, PZ = L::PZ, PLANE = L::PLANE;
  constexpr int NPAIR = W * W / 2;
  const int st = STEADY ? ST : st_rt;
  auto slot = [&](int d) {  // slot of plane t + d, -R < d < R
    int s = st + d;
    if (s < 0) s += R;
    if (s >= R) s -= R;
    return s;
  };
  auto valid = [&](int q) { return STEADY || (q >= w.xs && q < w.xe); };

  // this thread's copies of plane t + 1 (and so of t .. t - NP) are in; a
  // and rhs of planes t .. t - NP + 1 were waited for by every thread
  // before the barrier of step t - 1
  copy_wait<D - 2>();
  const ShardPair<T>& p = w.p;
  if constexpr (TIER) {
    // the tier rounds the u its own copies brought (plane t + 1, and plane
    // xs at the first step: shard, seam or pad planes alike)
    if (STEADY || t + 1 < w.xe)
      march_tier_round<HP>(p.cell + slot(1) * PLANE);
    if (!STEADY && t == w.xs) march_tier_round<HP>(p.cell + slot(0) * PLANE);
  }
  const int c = (t + p.par) & 1;  // the pair's column this step updates
  const int h = c ^ p.jb;         // its colour half
  T lam[NP], aa[NP], rv[NP], own_u[NP + 2];
  if constexpr (!TIER) {
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const T* cp = p.co + slot(-ps) * 2 * W * W + (V ? c : h * NPAIR);
      aa[ps] = w.alpha * cp[0];
      rv[ps] = cp[W * W];
      lam[ps] = recip(aa[ps] + w.six_b_inv);
    }
  }
  T* const rb = p.cell + h * HP;
#pragma unroll
  for (int i = 0; i < NP + 2; ++i) own_u[i] = rb[slot(1 - i) * PLANE];
  // the tier's steady step with every axis periodic or none reads its own
  // column as bf16: the top half of each value (march_tier_steady)
  constexpr bool HOISTED = TIER && STEADY && PER >= 0;
  [[maybe_unused]] __nv_bfloat16 own_b[NP + 2];
  if constexpr (HOISTED) {
#pragma unroll
    for (int i = 0; i < NP + 2; ++i)
      own_b[i] = reinterpret_cast<const __nv_bfloat16*>(
          rb + slot(1 - i) * PLANE)[1];
  }
  __syncthreads();

  // plane t + D: its slot held plane t + D - R = t - NP - 1, which the
  // steps before this barrier were the last to read
  if (STEADY || t + D < w.xe)
    fetch_plane<T, NP, W, V, SRC>(w, t + D, slot(D));
  copy_commit();
  // the tier folds plane t + 1, whose first pass is the next step's: its a
  // and rhs are in and seen by all since this barrier, and no pass of this
  // step reads them (march_tier_steady's loads overlap the fold)
  if constexpr (TIER)
    if (STEADY || t + 1 < w.xe)
      tier_fold_plane<T, W, V, STEADY>(w, t + 1, slot(1));

  const int qo = t - NP + 1;  // the plane whose last pass this step runs
  const bool write = qo >= w.x0 && qo < w.x1;
  T* const oplane = w.out + qo * (SRC == SRC_PRE ? w.sxo : w.sx);
  const int dh = (1 - 2 * h) * HP;  // from this half to the other
  const T* yp = rb + (dh + PZ);
  const T* ym = rb + (dh - PZ);
  const T* zp = rb + (dh + c);      // even column: same index, odd: +1
  const T* zm = rb + (dh + c - 1);  // even column: index - 1, odd: same
  const T wza = pick(c, p.wza), wzb = pick(c, p.wzb);
  const T cs6 = pick(c, p.cs6);
  T nb[NP];  // the tier reads the in-plane neighbours in its passes
  if constexpr (!TIER) {
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const int o = slot(-ps) * PLANE;
      T s = p.wya * yp[o];
      s = s + p.wyb * ym[o];
      s = s + wza * zp[o];
      s = s + wzb * zm[o];
      nb[ps] = s;
    }
  }
  T up = own_u[0], last = (T)0;
  bool have_up = STEADY;
  // the tier's steady step with every axis periodic or none: its passes'
  // terms first, then the chain (march_tier_steady)
  if constexpr (HOISTED)
    last = march_tier_steady<NP, R, ST, PLANE, 2 * W * W, W * W, PER>(
        rb, yp, ym, zp, zm, p.co + (V ? c : h * NPAIR), own_b, p.fy, p.my,
        pick(c, p.fz), pick(c, p.mz));
#pragma unroll
  for (int ps = 0; ps < (HOISTED ? 0 : NP); ++ps) {
    const int q = t - ps;
    if (!valid(q)) continue;
    const T uc = own_u[ps + 1];
    T un;
    if constexpr (TIER) {
      // beyond an open segment end (a seam or a cut) the cell reads itself;
      // the plane's fold: P over a, (K, T) over rhs
      const int o = slot(-ps) * PLANE;
      const T* cp = p.co + slot(-ps) * 2 * W * W + (V ? c : h * NPAIR);
      const T upv = have_up ? up : (q + 1 < w.xe ? own_u[ps] : uc);
      const T umv = STEADY || q > w.xs ? own_u[ps + 2] : uc;
      un = tier_update<T, STEADY>(w, q, c, cp[0], cp[W * W], uc, upv, umv,
                                  yp[o], ym[o], zp[o], zm[o]);
    } else {
      T xn = (T)0, csx = (T)0;
      if (STEADY) {
        xn = up + own_u[ps + 2];
      } else {
        // beyond an open segment end (a seam or a cut) the cell reads itself
        const T upv = have_up ? up : (q + 1 < w.xe ? own_u[ps] : uc);
        const T umv = q > w.xs ? own_u[ps + 2] : uc;
        const bool lo = w.face_lo && q == 0;
        const bool hi = w.face_hi && q == w.nx - 1;
        const T wa = hi ? (T)0 : (lo ? (T)1 + w.c1xlo : (T)1);
        const T wb = lo ? (T)0 : (hi ? (T)1 + w.c1xhi : (T)1);
        xn = wa * (hi ? (T)0 : upv) + wb * (lo ? (T)0 : umv);
        csx = (lo ? w.c0xlo : (T)0) + (hi ? w.c0xhi : (T)0);
      }
      // u' = u + lam*(beta/dx^2*((c0 - 6) u + sum) + rhs - alpha*a*u)
      const T k6 = STEADY ? cs6 : cs6 + csx;
      const T s1 = k6 * uc + (nb[ps] + xn);
      const T s2 = w.b_inv * s1 + rv[ps];
      un = uc + lam[ps] * (s2 - aa[ps] * uc);
    }
    rb[slot(-ps) * PLANE] = un;
    up = un;
    have_up = true;
    last = un;
  }
  // plane qo: the active column's last pass was the step's last update,
  // the other column has been final since the step before
  if (write) {
    const T other = rb[slot(1 - NP) * PLANE + dh];
    if (p.own_both) {
      store_pair(oplane + p.coff[0], c ? other : last, c ? last : other);
    } else {
      if (pick(c, p.own)) oplane[pick(c, p.coff)] = last;
      if (pick(c ^ 1, p.own)) oplane[pick(c ^ 1, p.coff)] = other;
    }
  }
}

// R steady steps from slot ST on, each with its slot a constant (PER: the
// tier's periodic axes, all 1, none 0, or read -1)
template <typename T, int NP, int W, int D, bool V, int SRC, typename C,
          int ST, int PER = -1>
__device__ __forceinline__ void steady_steps(ShardThread<T>& w, int t) {
  march_step<T, NP, W, D, V, SRC, C, true, ST, PER>(w, t + ST, ST);
  if constexpr (ST + 1 < NP + D + 1)
    steady_steps<T, NP, W, D, V, SRC, C, ST + 1, PER>(w, t);
}

// C: the passes' arithmetic (T, or __nv_bfloat16 beside float: the tier)
template <typename T, int NP, int W, int D, bool V, int SRC, typename C>
__global__ void __launch_bounds__(W * W / 2, 1)
shard_march_kernel(const T* __restrict__ u, const T* __restrict__ rhs,
                   const T* __restrict__ a, const T* __restrict__ upad,
                   const T* __restrict__ rpad, const T* __restrict__ apad,
                   T* __restrict__ out, const ShardGeom g,
                   const LevelParams<T> p, const int base, const int xseg) {
  using L = WaveLayout<W, W>;
  constexpr int R = NP + D + 1;  // planes in the rings
  constexpr bool TIER = !std::is_same<C, T>::value;
  constexpr int HZ = L::HZ;
  constexpr int NPAIR = W * HZ;  // z-pairs of the tile: one per thread
  static_assert(D >= 2, "plane t + 1 must be fetched before step t");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* coef = ring + R * L::PLANE;
  // zero the rings: the padding and the dead columns start at zero, and no
  // slot ever holds anything but finite values
  for (int i = threadIdx.x; i < R * (L::PLANE + 4 * NPAIR); i += NPAIR)
    ring[i] = (T)0;
  __syncthreads();

  ShardThread<T> w;
  w.u = u; w.rhs = rhs; w.a = a; w.out = out;
  w.upad = upad; w.rpad = rpad; w.apad = apad;
  w.sx = g.sx;
  w.sxo = g.sxo;
  w.nx = p.nx;
  w.x0 = (int)blockIdx.z * xseg;
  w.x1 = min(p.nx, w.x0 + xseg);
  w.face_lo = g.face_lo != 0;
  w.face_hi = g.face_hi != 0;
  w.px = p.periodic[0] != 0;
  w.py = p.periodic[1] != 0;
  w.pz = p.periodic[2] != 0;
  // a segment end at an x face of the domain stops there; every other end
  // (a seam between shards, a cut inside the shard) is open
  w.xs = w.face_lo ? max(0, w.x0 - NP) : w.x0 - NP;
  w.xe = w.face_hi ? min(p.nx, w.x1 + NP) : w.x1 + NP;
  w.alpha = p.alpha; w.six_b_inv = p.six_b_inv; w.b_inv = p.b_inv;
  w.c0xlo = p.c0[0][0]; w.c1xlo = p.c1[0][0];
  w.c0xhi = p.c0[0][1]; w.c1xhi = p.c1[0][1];

  const bool py = p.periodic[1] != 0, pz = p.periodic[2] != 0;
  const T one = (T)1;
  ShardPair<T>& q = w.p;
  const int pidx = (int)threadIdx.x;
  const int kk = pidx % HZ, jj = pidx / HZ, lk = 2 * kk;
  // unwrapped indices of the pair's row and first column in the shard
  const int uj = (int)blockIdx.y * (W - 2 * NP) - NP + jj;
  const int uk = (int)blockIdx.x * (W - 2 * NP) - NP + lk;
  q.cell = ring + (jj + 1) * L::PZ + kk + 1;
  // the a, rhs ring: per slot 2*W*W elements, a then rhs; without V the
  // a (rhs) of column c at co[h*NPAIR] (co[W*W + h*NPAIR]), h = c ^ jb; with
  // V each plane in its own layout (row jj, column lk + c at co[c])
  q.co = V ? coef + jj * W + lk : coef + pidx;
  q.scell = static_cast<unsigned>(__cvta_generic_to_shared(q.cell));
  q.sco = static_cast<unsigned>(__cvta_generic_to_shared(q.co));
  q.jb = jj & 1;
  q.par = uj + uk + base;
  int gj = uj;
  const bool live_j = shard_row<SRC, NP>(uj, p, g, gj);
  const bool own_j = jj >= NP && jj < W - NP && uj < p.ny;
  if (V) {
    // chunk i of a slot (CH elements of one row of a or rhs) is fetched
    // by pair i / CPP
    constexpr int CH = 16 / sizeof(T), CPP = sizeof(T) / 4;
#pragma unroll
    for (int k = 0; k < CPP; ++k) {
      const int i = pidx * CPP + k;
      const int arr = i / (W * W / CH), rem = i % (W * W / CH);
      const int row = rem / (W / CH), col = (rem % (W / CH)) * CH;
      const int cuj = (int)blockIdx.y * (W - 2 * NP) - NP + row;
      const int cuk = (int)blockIdx.x * (W - 2 * NP) - NP + col;
      int cj = cuj;
      const bool in_j = shard_row<SRC, NP>(cuj, p, g, cj);
      int ck = cuk % p.nz;
      if (ck < 0) ck += p.nz;
      q.chunk_in[k] = in_j && (pz || (cuk >= 0 && cuk < p.nz));
      q.chunk_off[k] = cj * p.nz + ck;
      q.chunk_rhs[k] = arr != 0;
      q.chunk_dst[k] = static_cast<unsigned>(__cvta_generic_to_shared(
          coef + arr * W * W + row * W + col));
    }
  }
  bool ylo, yhi;
  if constexpr (SRC == SRC_PRE) {
    ylo = !py && uj + g.y_off == 0;
    yhi = !py && uj + g.y_off == g.ny_global - 1;
  } else {
    ylo = !py && gj == 0;
    yhi = !py && gj == p.ny - 1;
  }
  q.wya = yhi ? (T)0 : (ylo ? one + p.c1[1][0] : one);
  q.wyb = ylo ? (T)0 : (yhi ? one + p.c1[1][1] : one);
  const T csy = (ylo ? p.c0[1][0] : (T)0) + (yhi ? p.c0[1][1] : (T)0);
  q.fy = face_fold<T>(ylo, yhi, p.c0[1][0], p.c1[1][0], p.c0[1][1],
                      p.c1[1][1]);
  q.my = face_mask(ylo, yhi);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int ukc = uk + c;
    int gk = ukc;
    bool live_k = ukc >= 0 && ukc < p.nz;
    if (pz) {
      gk = ukc % p.nz;
      if (gk < 0) gk += p.nz;
      live_k = true;
    }
    q.live[c] = live_j && live_k;
    q.own[c] = own_j && q.live[c] && lk + c >= NP && lk + c < W - NP &&
               ukc < p.nz;
    q.coff[c] = gj * p.nz + gk;
    const bool zlo = !pz && gk == 0, zhi = !pz && gk == p.nz - 1;
    q.wza[c] = zhi ? (T)0 : (zlo ? one + p.c1[2][0] : one);
    q.wzb[c] = zlo ? (T)0 : (zhi ? one + p.c1[2][1] : one);
    q.cs6[c] = (csy + ((zlo ? p.c0[2][0] : (T)0) +
                       (zhi ? p.c0[2][1] : (T)0))) - (T)6;
    q.fz[c] = face_fold<T>(zlo, zhi, p.c0[2][0], p.c1[2][0], p.c0[2][1],
                           p.c1[2][1]);
    q.mz[c] = face_mask(zlo, zhi);
    // the fold's c0 sum where x has no face (x's is 0 + 0: adding it
    // changes nothing)
    T cs = (T)0;
    if (!w.py) cs += q.fy.c;
    if (!w.pz) cs += q.fz[c].c;
    q.tcs[c] = cs;
  }
  q.own_both = q.own[0] && q.own[1] && p.nz % 2 == 0 &&
               q.coff[1] == q.coff[0] + 1;

  // steps xs .. xe+NP-2; those in [lo_s, hi_s) are steady: t - NP >= xs and
  // t + D < xe, so that no plane of the staircase lies at a domain face
  // (a face bounds the segment). Plane q sits in slot (q - lo_s) mod R, so
  // that the steady steps run in blocks of R from slot 0.
  const int lo_s = w.xs + NP, hi_s = w.xe - D;
  int st = (w.xs - lo_s) % R;
  if (st < 0) st += R;
  // planes xs .. xs + D - 1 are fetched before the first step, one commit
  // group each (so that every step waits for the same count)
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (w.xs + d < w.xe) {
      int s = st + d;
      if (s >= R) s -= R;
      fetch_plane<T, NP, W, V, SRC>(w, w.xs + d, s);
    }
    copy_commit();
  }
  // a step reads a and rhs of its own plane before its barrier; with V they
  // come from other threads' copies, so plane xs must be in and seen by all
  // before the first step (later planes: the wait and barrier of the step
  // before)
  if (V || TIER) {
    copy_wait<D - 1>();
    __syncthreads();
  }
  // the tier folds plane xs before the first step (each later plane the
  // step before its first pass)
  if constexpr (TIER) tier_fold_plane<T, W, V, false>(w, w.xs, st);
  int t = w.xs;
  const int last = w.xe + NP - 1;
  for (; t < last && t < lo_s; ++t, st = st + 1 == R ? 0 : st + 1)
    march_step<T, NP, W, D, V, SRC, C, false, 0>(w, t, st);
  if constexpr (std::is_same<C, T>::value) {
    for (; t + R <= hi_s; t += R)  // st == 0 here
      steady_steps<T, NP, W, D, V, SRC, C, 0>(w, t);
  } else if (w.px && w.py && w.pz) {  // the tier, every axis periodic
    for (; t + R <= hi_s; t += R)
      steady_steps<T, NP, W, D, V, SRC, C, 0, 1>(w, t);
  } else if (!w.px && !w.py && !w.pz) {  // none periodic
    for (; t + R <= hi_s; t += R)
      steady_steps<T, NP, W, D, V, SRC, C, 0, 0>(w, t);
  }  // the tier with some axes periodic: every step the general one
  for (; t < last; ++t, st = st + 1 == R ? 0 : st + 1)
    march_step<T, NP, W, D, V, SRC, C, false, 0>(w, t, st);
  copy_wait<0>();
}

template <typename T, int NP, int W, int D>
constexpr size_t shard_smem() {
  return (size_t)(NP + D + 1) * (WaveLayout<W, W>::PLANE + 2 * W * W) *
         sizeof(T);
}

// blocks of this form the current device runs at once; sets the kernel's
// shared-memory limit on first use per device
template <typename T, int NP, int W, int D, bool V, int SRC, typename C>
cudaError_t form_capacity(int* capacity) {
  static_assert(shard_smem<T, NP, W, D>() <= 232448,
                "form does not fit the shared memory of a block");
  static int cache[kMaxDevices] = {};
  return march_capacity(
      (const void*)shard_march_kernel<T, NP, W, D, V, SRC, C>, W * W / 2,
      shard_smem<T, NP, W, D>(), cache, capacity);
}

template <typename T, int NP, int W, int D, bool V, int SRC, typename C>
cudaError_t launch_form(const ShardSrc<T>& s, T* out,
                        const LevelParams<T>& p, int base, int xseg,
                        cudaStream_t stream) {
  constexpr int TI = W - 2 * NP;  // written per side
  static_assert(TI > 0 && W % 2 == 0, "tile");
  int capacity = 0;
  cudaError_t err = form_capacity<T, NP, W, D, V, SRC, C>(&capacity);
  if (err != cudaSuccess) return err;
  if (xseg < 1) return cudaErrorInvalidValue;
  const int nty = (p.ny + TI - 1) / TI, ntz = (p.nz + TI - 1) / TI;
  const int nseg = (p.nx + xseg - 1) / xseg;
  if (nty > 65535 || nseg > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)nseg);
  shard_march_kernel<T, NP, W, D, V, SRC, C>
      <<<grid, W * W / 2, shard_smem<T, NP, W, D>(), stream>>>(
          s.u, s.rhs, s.a, s.upad, s.rpad, s.apad, out, s.g, p, base, xseg);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The launch takes the form that moves a and rhs in 16-byte chunks of rows
// (V) where every row of every operand starts on 16 bytes.
template <typename T>
bool chunked_rows(const ShardSrc<T>& s, int nz) {
  return nz % (16 / sizeof(T)) == 0 && aligned16(s.u) && aligned16(s.rhs) &&
         aligned16(s.a) && aligned16(s.upad) && aligned16(s.rpad) &&
         aligned16(s.apad);
}

template <int SRC, typename C, typename T>
cudaError_t launch_shard(const ShardSrc<T>& s, T* out,
                         const LevelParams<T>& p, int base, int nsweeps,
                         int tile, int xseg, cudaStream_t stream) {
  // a periodic axis that wraps inside a tile must have an even extent so
  // that the checkerboard stays consistent across the wrap (an axis that
  // wraps through pads was checked by the caller on the level)
  if ((SRC != SRC_PRE && p.periodic[1] && p.ny % 2) ||
      (p.periodic[2] && p.nz % 2))
    return cudaErrorInvalidValue;
  const int np = 2 * nsweeps;
  const bool vec = chunked_rows(s, p.nz);
#define SHARD_LAUNCH(TT, NPP, WW, DD)                                    \
  if constexpr (std::is_same<T, TT>::value) {                            \
    if (np == NPP && tile == WW)                                         \
      return vec ? launch_form<TT, NPP, WW, DD, true, SRC, C>(           \
                       s, out, p, base, xseg, stream)                    \
                 : launch_form<TT, NPP, WW, DD, false, SRC, C>(          \
                       s, out, p, base, xseg, stream);                   \
  }
  SHARD_FORMS(SHARD_LAUNCH)
#undef SHARD_LAUNCH
  return cudaErrorInvalidValue;
}

// An x-slab with (2H, ny, nz) pads (SRC_SLAB).
template <typename T>
ShardSrc<T> padded_slab(const T* u, const T* rhs, const T* a, const T* upad,
                        const T* rpad, const T* apad, const LevelParams<T>& p,
                        int face_lo, int face_hi) {
  const long long sx = (long long)p.ny * p.nz;
  return ShardSrc<T>{u, rhs, a, upad, rpad, apad,
                     ShardGeom{sx, sx, face_lo, face_hi, 0, p.ny}};
}

// A pencil prepadded by H on both sides of x and y: (nx+2H, ny+2H, nz)
// (SRC_PRE).
template <typename T>
ShardSrc<T> prepadded(const T* u_pre, const T* r_pre, const T* a_pre,
                      const LevelParams<T>& p, int face_lo, int face_hi,
                      int y_off, int ny_global, int H) {
  const long long sx = (long long)(p.ny + 2 * H) * p.nz;
  const long long o = H * sx + (long long)H * p.nz;  // cell (0, 0, 0)
  return ShardSrc<T>{u_pre + o, r_pre + o, a_pre + o, nullptr, nullptr,
                     nullptr, ShardGeom{sx, (long long)p.ny * p.nz, face_lo,
                                        face_hi, y_off, ny_global}};
}

// chunked_rows of the operands an entry is given (pre: mgk_multisweep_pre's
// prepadded arrays, else mgk_multisweep_halo's slab and pads).
template <typename T>
int entry_chunked(int pre, int ny, int nz, int H, const void* u,
                  const void* rhs, const void* a, const void* upad,
                  const void* rpad, const void* apad) {
  LevelParams<T> p{};
  p.ny = ny;
  p.nz = nz;
  return pre ? chunked_rows(prepadded((const T*)u, (const T*)rhs,
                                      (const T*)a, p, 0, 0, 0, ny, H),
                            nz)
             : chunked_rows(padded_slab((const T*)u, (const T*)rhs,
                                        (const T*)a, (const T*)upad,
                                        (const T*)rpad, (const T*)apad, p, 0,
                                        0),
                            nz);
}

// The tier checks of the entries: compute 0 (the operands' precision) or
// 1 (bf16 passes, f32 operands only).
bool bad_compute(int compute, int is_double) {
  return compute < 0 || compute > 1 || (compute == 1 && is_double);
}

}  // namespace

// C entry point: out <- nsweeps (2 or 4) sweeps of the (nx, ny, nz) x-slab u
// of a sharded level, with (2H, ny, nz) pads (H = 2*nsweeps) of u, rhs and a:
// rows [0, H) lie below the slab, [H, 2H) above. face_lo / face_hi: the
// slab's low / high x face is a face of the domain (the ghost rule; its pad
// is not read); else a seam, read from the pad. base = sum(lo) + the slab's
// x origin in the level. Tiles of width `tile` (one of SHARD_FORMS), x
// segments of `xseg` planes. compute: 0 the passes at the operands'
// precision, 1 in bf16 (the bf16 tier; f32 operands). out must not alias an
// input.
extern "C" int mgk_multisweep_halo(const void* u, const void* rhs,
                                   const void* a, const void* upad,
                                   const void* rpad, const void* apad,
                                   void* out, int is_double, int compute,
                                   int nx, int ny, int nz, const int* kinds,
                                   double rho, double alpha, double beta,
                                   double dx, int base, int face_lo,
                                   int face_hi, int nsweeps, int tile,
                                   int xseg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nx < 1 || bad_compute(compute, is_double))
    return (int)cudaErrorInvalidValue;
  if (is_double) {
    using T = double;
    auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_shard<SRC_SLAB, T>(
        padded_slab((const T*)u, (const T*)rhs, (const T*)a, (const T*)upad,
                    (const T*)rpad, (const T*)apad, p, face_lo, face_hi),
        (T*)out, p, base, nsweeps, tile, xseg, st);
  }
  using T = float;
  auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  const auto src = padded_slab((const T*)u, (const T*)rhs, (const T*)a,
                               (const T*)upad, (const T*)rpad,
                               (const T*)apad, p, face_lo, face_hi);
  return compute == 1
             ? (int)launch_shard<SRC_SLAB, __nv_bfloat16>(
                   src, (T*)out, p, base, nsweeps, tile, xseg, st)
             : (int)launch_shard<SRC_SLAB, T>(src, (T*)out, p, base,
                                              nsweeps, tile, xseg, st);
}

// C entry point: out (nx, ny, nz) <- nsweeps (2 or 4) sweeps of one pencil of
// a sharded level from PREPADDED u, rhs, a of shape (nx+2H, ny+2H, nz),
// H = 2*nsweeps. face_lo / face_hi as for mgk_multisweep_halo; y_off is the
// pencil's y origin in the level of y extent ny_global (the y face rule
// fires at global rows 0 and ny_global - 1 only); base = sum(lo) + x origin
// + y_off; compute, tile and xseg as for mgk_multisweep_halo.
extern "C" int mgk_multisweep_pre(const void* u_pre, const void* rhs_pre,
                                  const void* a_pre, void* out, int is_double,
                                  int compute, int nx, int ny, int nz,
                                  const int* kinds, double rho, double alpha,
                                  double beta, double dx, int base,
                                  int face_lo, int face_hi, int y_off,
                                  int ny_global, int nsweeps, int tile,
                                  int xseg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int H = 2 * nsweeps;
  if (nx < 1 || ny < 1 || bad_compute(compute, is_double))
    return (int)cudaErrorInvalidValue;
  if (is_double) {
    using T = double;
    auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_shard<SRC_PRE, T>(
        prepadded((const T*)u_pre, (const T*)rhs_pre, (const T*)a_pre, p,
                  face_lo, face_hi, y_off, ny_global, H),
        (T*)out, p, base, nsweeps, tile, xseg, st);
  }
  using T = float;
  auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  const auto src = prepadded((const T*)u_pre, (const T*)rhs_pre,
                             (const T*)a_pre, p, face_lo, face_hi, y_off,
                             ny_global, H);
  return compute == 1
             ? (int)launch_shard<SRC_PRE, __nv_bfloat16>(
                   src, (T*)out, p, base, nsweeps, tile, xseg, st)
             : (int)launch_shard<SRC_PRE, T>(src, (T*)out, p, base, nsweeps,
                                             tile, xseg, st);
}

// C entry point: *capacity <- blocks of the shard form (type, arithmetic as
// the entries' compute, nsweeps, tile; pre: the prepadded source) that the
// current device runs at once (the x segments are cut for it).
extern "C" int mgk_multisweep_shard_capacity(int is_double, int compute,
                                             int nsweeps, int tile, int pre,
                                             int* capacity) {
  const int np = 2 * nsweeps;
  if (bad_compute(compute, is_double)) return (int)cudaErrorInvalidValue;
#define SHARD_CAPACITY(TT, NPP, WW, DD)                                  \
  if (is_double == (int)std::is_same<TT, double>::value && np == NPP &&  \
      tile == WW) {                                                      \
    if (compute == 1)                                                    \
      return (int)(pre ? form_capacity<TT, NPP, WW, DD, false, SRC_PRE,  \
                                       tier_t<TT>>(capacity)             \
                       : form_capacity<TT, NPP, WW, DD, false, SRC_SLAB, \
                                       tier_t<TT>>(capacity));           \
    return (int)(pre ? form_capacity<TT, NPP, WW, DD, false, SRC_PRE,    \
                                     TT>(capacity)                       \
                     : form_capacity<TT, NPP, WW, DD, false, SRC_SLAB,   \
                                     TT>(capacity));                     \
  }
  SHARD_FORMS(SHARD_CAPACITY)
#undef SHARD_CAPACITY
  return (int)cudaErrorInvalidValue;
}

// C entry point: *chunked <- 1 where mgk_multisweep_pre (pre = 1) or
// mgk_multisweep_halo (pre = 0), given these pointers and this (ny, nz) and
// nsweeps, launches its form with a and rhs in 16-byte chunks, else 0 (the
// pads are not read for pre).
extern "C" int mgk_multisweep_shard_chunked(int is_double, int pre, int ny,
                                            int nz, int nsweeps,
                                            const void* u, const void* rhs,
                                            const void* a, const void* upad,
                                            const void* rpad,
                                            const void* apad, int* chunked) {
  const int H = 2 * nsweeps;
  *chunked = is_double ? entry_chunked<double>(pre, ny, nz, H, u, rhs, a,
                                               upad, rpad, apad)
                       : entry_chunked<float>(pre, ny, nz, H, u, rhs, a,
                                              upad, rpad, apad);
  return (int)cudaSuccess;
}
