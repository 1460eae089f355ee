// multisweep_relax: nsweeps red-black Gauss-Seidel sweeps of one WHOLE level
// in ONE launch, for any face kinds including periodic x: the march of
// csrc/multisweep_march.cuh (which says what it computes and which TPU
// kernels it replaces) with the planes of the level itself, taken modulo nx
// where x is periodic. The entry point of ops/fused_sweeps.multisweep_relax
// and of ops/wavefront.wavefront_relax. The shard forms have a body of their
// own (csrc/multisweep_halo.cu, the header's design); this one is built for
// the H100 as follows.
//
// What bounds it: not bytes (u, rhs and a are read once and u written once
// per call, times the rind factor) but the time of one step of the march,
// i.e. of one plane, which every block takes NP passes at a time with one
// block barrier: the instructions of a step, the wait for the plane that
// enters, and the barrier. The shard body (the header's design) loads the
// next plane's u one step ahead into registers and re-reads rhs and a of
// the older planes through L1 at each of a cell's NP/2 updates, so every
// step waits on memory; and its one 40 x 40 tile computes 1.93 columns per
// written one at 144.
//
// Design:
//  * A ring of R = NP + D + 1 planes in shared memory holds u (colour-split,
//    WaveLayout: no bank conflicts) AND a and rhs of every column of the
//    tile. Plane t + D is brought in with asynchronous copies (cp.async,
//    one commit group per plane) right after the barrier of step t, so D
//    planes are in flight and no thread waits on device memory inside a
//    step: before a step a thread waits only for its own copies of plane
//    t + 1 (cp.async.wait_group D - 2). u of plane t + 1 is read before the
//    barrier only in the thread's own column, which the thread fetched; the
//    neighbours' columns of planes t .. t - NP + 1 after it. a and rhs of
//    planes t .. t - NP + 1 are read before the barrier: every thread waited
//    for them before the barrier of step t - 1. A slot is refilled (plane
//    t + D over plane t + D - R) only after the barrier that follows the
//    last step reading it (t - 1). The copies read the INPUT arrays only,
//    modulo nx, so a segment may wrap onto its own planes.
//  * u is copied one element a column (the colour split is no box and no
//    16-byte run). a and rhs are copied in 16-byte chunks of rows (V: the
//    tile's pair i fetches chunk i of the plane's a and rhs in f32, chunks
//    2i and 2i + 1 in f64; cp.async.cg, past L1, so that the D planes in
//    flight do not evict each other from it),
//    where every row starts on 16 bytes (nz a multiple of the chunk, the
//    arrays aligned); otherwise one element a column into the pair's
//    colour halves, each thread its own (the second path, a kernel of its
//    own, chosen at launch). TMA box copies were not used: the colour-split
//    layout a step needs is not a box, and a periodic y or z wraps a tile
//    into pieces a box cannot land.
//  * The tile is W x W columns, W - 2*NP written per side; a thread owns
//    one z-pair (2kk, 2kk+1) of a tile row (a thread owning two pairs in
//    two rows, half the threads, ran slower on the H100). The caller picks
//    W from the forms built (MARCH_FORMS) and the x segment length from
//    the blocks that fit at once (mgk_multisweep_capacity), both in Python
//    (ops/fused_sweeps.march_geometry), so that 144 = 4 x 36 takes a tile
//    of 44 (1.49 columns computed per written one) and 64, 96, 256, 512 one
//    of 40 (1.56).
//  * Kept from the shard body, because each was measured: the time skew
//    (pass p on plane t - p, one barrier per step), the steady form with
//    compile-time ring slots for the steps whose staircase lies inside the
//    segment and off the x faces (here in unrolled blocks of R steps, slots
//    counted from the first steady step), recip() with a Newton step.
//  * The update in residual form, the four in-plane neighbours summed with
//    their face weights and the two x neighbours added:
//        u' = u + lam (beta/dx^2 ((c0 - 6) u + sum) + rhs - alpha a u),
//    lam = 1 / (alpha a + 6 beta/dx^2) (fewer operations than weighting
//    each neighbour by lam beta/dx^2; ulps away from gsrb_relax, not
//    bitwise).
//  * Dead columns (outside a non-periodic y or z face) are updated like
//    the others, without a branch; they are read only with weight 0.
//  * The bf16 tier (smoother_precision = bfloat16; mgk_multisweep_relax's
//    `compute` 1): every form is built again with C = __nv_bfloat16 beside
//    T = float. Its passes compute gsrb_relax's tier update
//    (gsrb_update_bf16, csrc/gsrb_device.cuh; here tier_fold, then the
//    passes) from the march's own neighbour reads and face folds, so that the bf16
//    march is bf16 gsrb_relax bit for bit: 1/diag by division, the fold in
//    f32 rounded to bf16 once, each bf16 operation rounded once in the
//    plain version's order. The residual form and its recip() above are
//    the f32 / f64 forms' only. The x faces fold as the y and z faces do
//    (the JAX slab and wavefront bodies re-derive an x ghost row in bf16
//    instead: not carried over). As the header says, a plane is folded once,
//    in place in the a, rhs ring (tier_fold_plane), and u is rounded once,
//    where its copies land (march_tier_round), not at every pass: the fold
//    is paid twice a step (the pair's two columns of the plane that enters)
//    instead of NP times, and no pass converts a u value. A steady step with
//    every axis periodic or none (PER, a template argument of the steady
//    steps) runs its passes as the f32 form does: every pass's loads and
//    terms first, then the chain through x (march_tier_steady); other steps
//    run march_tier_cell a pass. The ring keeps f32 words: shared memory and
//    the launch geometry as in f32. What it costs against the f32 form:
//    PERF.md (the fold ~13 % of the tier's time, the rounding ~4 %).
#include <cstdint>
#include <type_traits>

#include "multisweep_march.cuh"

namespace {

// The forms built: (type, colour passes NP = 2*nsweeps, tile width W,
// planes fetched ahead D), each twice: with a and rhs in 16-byte chunks (V)
// and without; each float form also in the bf16 tier (C =
// __nv_bfloat16). Each must fit the 227 KB of shared memory a block may
// use: R * (PLANE + 2*W*W) * sizeof(T) with R = NP + D + 1.
// ops/fused_sweeps.MARCH_TILES lists the same widths per (itemsize,
// nsweeps).
#define MARCH_FORMS(X) \
  X(float, 4, 40, 3)   \
  X(float, 4, 44, 2)   \
  X(float, 8, 36, 2)   \
  X(double, 4, 32, 2)  \
  X(double, 8, 24, 2)

// One z-pair of a tile row: where its columns live in the level and in the
// rings, and the folded weights of the y and z faces they touch. Column c of
// the pair lives in colour half h = c ^ jb of its row (jb: row parity): the
// cells a step updates share one half in every row.
template <typename T>
struct MarchPair {
  T* cell;         // u ring slot 0: the pair's place in half 0 of its row
  const T* co;     // a of the pair in slot 0 of the a, rhs ring (below)
  unsigned scell, sco;  // the same as shared-memory addresses
  // V (16-byte copies): the chunks of a or rhs this pair fetches, source in
  // plane 0 (null: outside the level) and shared address in slot 0
  const T* chunk_src[2];
  unsigned chunk_dst[2];
  int coff[2];     // offset of each column inside a plane of the level
  int par;         // row + first column + sum(lo), unwrapped indices
  int jb;          // row parity
  bool live[2], own[2];
  bool own_both;   // both columns written, side by side in the level, the
                   // first at an even offset (nz even): one 2-wide store
  T wya, wyb;        // weight of the y+1 / y-1 neighbour (0 across a face,
  T wza[2], wzb[2];  //   1 + c1 at it, 1 inside), same for z per column
  T cs6[2];          // c0 feed-through of the y and z faces, minus 6
  AxisFold<T> fy, fz[2];  // the bf16 tier's folds of the y and z faces
  unsigned my, mz[2];     // and the lanes of their pairs (face_mask)
  T tcs[2];          // the tier's c0 sum of a plane off the x faces
};

template <typename T>
struct MarchThread {
  const T* u; const T* rhs; const T* a; T* out;
  long long sx;             // plane stride of the level arrays
  int xs, xe, x0, x1, nx;   // planes worked on [xs, xe), written [x0, x1)
  bool wrapx;               // x is periodic: planes are taken modulo nx
  bool py, pz;              // y, z are periodic
  T alpha, six_b_inv, b_inv;
  T c0xlo, c1xlo, c0xhi, c1xhi;  // x-face ghost rule
  MarchPair<T> p;
};

// Plane q of the march as a plane of the level arrays.
template <typename T>
__device__ __forceinline__ int xplane(const MarchThread<T>& w, int q) {
  if (w.wrapx) {
    q %= w.nx;
    if (q < 0) q += w.nx;
  }
  return q;
}

// Start the copies of level plane xq into ring slot s: u of the thread's
// live columns (one element a copy), and their a and rhs: one element a
// copy into the pair's colour halves, or (V) 16-byte chunks of rows into the
// plane's own layout, bypassing L1.
template <typename T, int W, bool V>
__device__ __forceinline__ void fetch_plane(const MarchThread<T>& w,
                                            int xq, int s) {
  using L = WaveLayout<W, W>;
  constexpr int NPAIR = W * W / 2;
  constexpr unsigned B = sizeof(T);
  const long long o = (long long)xq * w.sx;
  const MarchPair<T>& p = w.p;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!p.live[c]) continue;
    const long long g = o + p.coff[c];
    const unsigned h = (unsigned)(c ^ p.jb);
    copy_async(p.scell + (s * L::PLANE + h * L::HP) * B, w.u + g);
    if (!V) {
      copy_async(p.sco + (4 * s + h) * NPAIR * B, w.a + g);
      copy_async(p.sco + (4 * s + 2 + h) * NPAIR * B, w.rhs + g);
    }
  }
  if (V) {
#pragma unroll
    for (int k = 0; k < (int)(B / 4); ++k)
      if (p.chunk_src[k])
        copy_chunk(p.chunk_dst[k] + s * 2 * W * W * B, p.chunk_src[k] + o);
  }
}

// The bf16 tier's fold of plane q in ring slot s (T float), in place: both
// live columns of the pair (march_tier_fold), c0 summed x, then y, then z
// over the non-periodic axes as row_fold and gsrb_update_row_bf16 sum it,
// x's face from q where the step is not steady.
template <typename T, int W, bool V, bool STEADY>
__device__ __forceinline__ void tier_fold_plane(const MarchThread<T>& w,
                                                int q, int s) {
  constexpr int NPAIR = W * W / 2;
  const MarchPair<T>& p = w.p;
  const bool xlo = !STEADY && !w.wrapx && q == 0;
  const bool xhi = !STEADY && !w.wrapx && q == w.nx - 1;
  const AxisFold<T> fx =
      face_fold<T>(xlo, xhi, w.c0xlo, w.c1xlo, w.c0xhi, w.c1xhi);
  T* const co = const_cast<T*>(p.co) + s * 2 * W * W;
  T c_sum[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    c_sum[c] = p.tcs[c];
    if (!STEADY) {
      c_sum[c] = (T)0;
      if (!w.wrapx) c_sum[c] += fx.c;
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

// The bf16 tier's pass of the pair's column c in plane q (T float) from the
// plane's fold (P, kt) and the values the pass read (up / um along x, then
// y, then z), the x faces from q where the step is not steady.
template <typename T, bool STEADY>
__device__ __forceinline__ T tier_update(const MarchThread<T>& w, int q,
                                         int c, T P, T kt, T uc, T upv,
                                         T umv, T ypv, T ymv, T zpv,
                                         T zmv) {
  const MarchPair<T>& p = w.p;
  const bool xlo = !STEADY && !w.wrapx && q == 0;
  const bool xhi = !STEADY && !w.wrapx && q == w.nx - 1;
  const AxisFold<T> fx =
      face_fold<T>(xlo, xhi, w.c0xlo, w.c1xlo, w.c0xhi, w.c1xhi);
  const bool per[3] = {w.wrapx, w.py, w.pz};
  const T up[3] = {upv, ypv, zpv}, um[3] = {umv, ymv, zmv};
  return march_tier_cell<STEADY>(P, kt, uc, up, um, per, fx, p.fy, p.my,
                                 pick(c, p.fz), pick(c, p.mz));
}

// One step of the march: pass ps works on plane t - ps for ps = 0 .. NP-1,
// in each pair's column whose cells have this step's colour; plane t + D is
// fetched; both columns of plane t - NP + 1 are final and written.
//
// STEADY: every plane t + D .. t - NP lies inside (xs, xe) and, x open,
// away from the x faces of the domain; x periodic, t + D lies in [0, 2 nx).
// So no pass needs a validity test or an x-face rule, the plane fetched
// wraps at most once, and the ring slot of plane t is the compile-time ST. Otherwise `st_rt` is t's slot and every pass is
// tested. A dead column (outside a non-periodic face) is updated like any
// other from the zeros and neighbours it has: its values stay finite, are
// read only with weight 0, and are never written out. C: the passes'
// arithmetic (T, or __nv_bfloat16 beside float: tier_update).
template <typename T, int NP, int W, int D, bool V, typename C, bool STEADY,
          int ST, int PER = -1>
__device__ __forceinline__ void march_step(MarchThread<T>& w,
                                           const int t, const int st_rt) {
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

  // this thread's copies of plane t + 1 (and so of t .. t - NP) are in
  copy_wait<D - 2>();
  // the own column of u needs no barrier (only its owner reads it before
  // one), a and rhs of planes t .. t - NP + 1 were waited for by every
  // thread before the barrier of step t - 1. lam = 1 / (alpha*a +
  // 6*beta/dx^2).
  const MarchPair<T>& p = w.p;
  if constexpr (TIER) {
    // the tier rounds the u its own copies brought (plane t + 1, and plane
    // xs at the first step)
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
    fetch_plane<T, W, V>(
        w, STEADY ? t + D - (t + D >= w.nx ? w.nx : 0) : xplane(w, t + D),
        slot(D));
  copy_commit();
  // the tier folds plane t + 1, whose first pass is the next step's: its a
  // and rhs are in and seen by all since this barrier, and no pass of this
  // step reads them (march_tier_steady's loads overlap the fold)
  if constexpr (TIER)
    if (STEADY || t + 1 < w.xe)
      tier_fold_plane<T, W, V, STEADY>(w, t + 1, slot(1));

  const int qo = t - NP + 1;  // the plane whose last pass this step runs
  const bool write = qo >= w.x0 && qo < w.x1;
  T* const oplane = w.out + qo * w.sx;
  const int dh = (1 - 2 * h) * HP;  // from this half to the other
  const T* yp = rb + (dh + PZ);
  const T* ym = rb + (dh - PZ);
  const T* zp = rb + (dh + c);      // even column: same index, odd: +1
  const T* zm = rb + (dh + c - 1);  // even column: index - 1, odd: same
  const T wza = pick(c, p.wza), wzb = pick(c, p.wzb);
  const T cs6 = pick(c, p.cs6);
  // the in-plane neighbours of every pass, weighted (the tier reads them
  // in its passes)
  T nb[NP];
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
      // beyond an open segment end the cell reads itself; the plane's
      // fold: P over a, (K, T) over rhs
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
        // beyond an open segment end the cell reads itself
        const T upv = have_up ? up : (q + 1 < w.xe ? own_u[ps] : uc);
        const T umv = q > w.xs ? own_u[ps + 2] : uc;
        const bool lo = !w.wrapx && q == 0;
        const bool hi = !w.wrapx && q == w.nx - 1;
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
template <typename T, int NP, int W, int D, bool V, typename C, int ST,
          int PER = -1>
__device__ __forceinline__ void steady_steps(MarchThread<T>& w, int t) {
  march_step<T, NP, W, D, V, C, true, ST, PER>(w, t + ST, ST);
  if constexpr (ST + 1 < NP + D + 1)
    steady_steps<T, NP, W, D, V, C, ST + 1, PER>(w, t);
}

// C: the passes' arithmetic (T, or __nv_bfloat16 beside float: the tier)
template <typename T, int NP, int W, int D, bool V, typename C>
__global__ void __launch_bounds__(W * W / 2, 1)
march_kernel(const T* __restrict__ u, const T* __restrict__ rhs,
             const T* __restrict__ a, T* __restrict__ out,
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

  MarchThread<T> w;
  w.u = u; w.rhs = rhs; w.a = a; w.out = out;
  w.sx = (long long)p.ny * p.nz;
  w.nx = p.nx;
  w.x0 = (int)blockIdx.z * xseg;
  w.x1 = min(p.nx, w.x0 + xseg);
  w.wrapx = p.periodic[0] != 0;
  w.py = p.periodic[1] != 0;
  w.pz = p.periodic[2] != 0;
  // a periodic x has no face: both segment ends are open, wherever they lie
  w.xs = w.wrapx ? w.x0 - NP : max(0, w.x0 - NP);
  w.xe = w.wrapx ? w.x1 + NP : min(p.nx, w.x1 + NP);
  w.alpha = p.alpha; w.six_b_inv = p.six_b_inv; w.b_inv = p.b_inv;
  w.c0xlo = p.c0[0][0]; w.c1xlo = p.c1[0][0];
  w.c0xhi = p.c0[0][1]; w.c1xhi = p.c1[0][1];

  const bool py = p.periodic[1] != 0, pz = p.periodic[2] != 0;
  const T one = (T)1;
  MarchPair<T>& q = w.p;
  const int pidx = (int)threadIdx.x;
  const int kk = pidx % HZ, jj = pidx / HZ, lk = 2 * kk;
  // unwrapped global indices of the pair's row and first column
  const int uj = (int)blockIdx.y * (W - 2 * NP) - NP + jj;
  const int uk = (int)blockIdx.x * (W - 2 * NP) - NP + lk;
  q.cell = ring + (jj + 1) * L::PZ + kk + 1;
  // the a, rhs ring: per slot 2*W*W elements, a then rhs; without V the
  // a (rhs) of column c at co[h*NPAIR] (co[W*W + h*NPAIR]), h = c ^ jb,
  // co = coef + pidx: the cells of a step at consecutive addresses; with
  // V each plane in its own layout (row jj, column lk + c at co[c])
  q.co = V ? coef + jj * W + lk : coef + pidx;
  q.scell = static_cast<unsigned>(__cvta_generic_to_shared(q.cell));
  q.sco = static_cast<unsigned>(__cvta_generic_to_shared(q.co));
  q.jb = jj & 1;
  q.par = uj + uk + base;
  int gj = uj;
  bool live_j = uj >= 0 && uj < p.ny;
  if (py) {
    gj = uj % p.ny;
    if (gj < 0) gj += p.ny;
    live_j = true;
  }
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
      int cj = cuj % p.ny, ck = cuk % p.nz;
      if (cj < 0) cj += p.ny;
      if (ck < 0) ck += p.nz;
      const bool in = (py || (cuj >= 0 && cuj < p.ny)) &&
                      (pz || (cuk >= 0 && cuk < p.nz));
      q.chunk_src[k] = in ? (arr ? rhs : a) + (cj * p.nz + ck) : nullptr;
      q.chunk_dst[k] = static_cast<unsigned>(__cvta_generic_to_shared(
          coef + arr * W * W + row * W + col));
    }
  }
  const bool ylo = !py && gj == 0, yhi = !py && gj == p.ny - 1;
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

  // steps xs .. xe+NP-2; those in [lo_s, hi_s) are steady: t - NP >= xs,
  // t + D < xe, and no plane of the staircase at an x face of the domain
  // (x open) or 0 <= t + D < 2 nx (x periodic: the fetch wraps once at
  // most). Plane q sits in slot (q - lo_s) mod R, so that the steady steps
  // run in blocks of R from slot 0.
  const int lo_s = w.wrapx ? max(w.xs + NP, -D) : max(w.xs, 0) + NP;
  const int hi_s = w.wrapx ? min(w.xe, 2 * p.nx) - D : min(w.xe, p.nx) - D;
  int st = (w.xs - lo_s) % R;
  if (st < 0) st += R;
  // planes xs .. xs + D - 1 are fetched before the first step, one commit
  // group each (so that every step waits for the same count)
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (w.xs + d < w.xe) {
      int s = st + d;
      if (s >= R) s -= R;
      fetch_plane<T, W, V>(w, xplane(w, w.xs + d), s);
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
    march_step<T, NP, W, D, V, C, false, 0>(w, t, st);
  if constexpr (std::is_same<C, T>::value) {
    for (; t + R <= hi_s; t += R)  // st == 0 here
      steady_steps<T, NP, W, D, V, C, 0>(w, t);
  } else if (w.wrapx && w.py && w.pz) {  // the tier, every axis periodic
    for (; t + R <= hi_s; t += R)
      steady_steps<T, NP, W, D, V, C, 0, 1>(w, t);
  } else if (!w.wrapx && !w.py && !w.pz) {  // none periodic
    for (; t + R <= hi_s; t += R)
      steady_steps<T, NP, W, D, V, C, 0, 0>(w, t);
  }  // the tier with some axes periodic: every step the general one
  for (; t < last; ++t, st = st + 1 == R ? 0 : st + 1)
    march_step<T, NP, W, D, V, C, false, 0>(w, t, st);
  copy_wait<0>();
}

template <typename T, int NP, int W, int D, bool V>
constexpr size_t march_smem() {
  return (size_t)(NP + D + 1) * (WaveLayout<W, W>::PLANE + 2 * W * W) *
         sizeof(T);
}

// blocks of this form the current device runs at once; sets the kernel's
// shared-memory limit on first use per device
template <typename T, int NP, int W, int D, bool V, typename C>
cudaError_t form_capacity(int* capacity) {
  static_assert(march_smem<T, NP, W, D, V>() <= 232448,
                "form does not fit the shared memory of a block");
  static int cache[kMaxDevices] = {};
  return march_capacity((const void*)march_kernel<T, NP, W, D, V, C>,
                        W * W / 2, march_smem<T, NP, W, D, V>(),
                        cache, capacity);
}

template <typename T, int NP, int W, int D, bool V, typename C>
cudaError_t launch_form(const T* u, const T* rhs, const T* a, T* out,
                        const LevelParams<T>& p, int base, int xseg,
                        cudaStream_t stream) {
  constexpr int TI = W - 2 * NP;  // written per side
  static_assert(TI > 0 && W % 2 == 0, "tile");
  int capacity = 0;
  cudaError_t err = form_capacity<T, NP, W, D, V, C>(&capacity);
  if (err != cudaSuccess) return err;
  if (xseg < 1) return cudaErrorInvalidValue;
  const int nty = (p.ny + TI - 1) / TI, ntz = (p.nz + TI - 1) / TI;
  const int nseg = (p.nx + xseg - 1) / xseg;
  if (nty > 65535 || nseg > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)nseg);
  march_kernel<T, NP, W, D, V, C>
      <<<grid, W * W / 2, march_smem<T, NP, W, D, V>(), stream>>>(
          u, rhs, a, out, p, base, xseg);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_multisweep(const T* u, const T* rhs, const T* a, T* out,
                              const LevelParams<T>& p, int base, int nsweeps,
                              int tile, int xseg, cudaStream_t stream) {
  // a periodic axis wraps inside a tile or a segment: its extent must be
  // even so that the checkerboard stays consistent across the wrap
  if ((p.periodic[0] && p.nx % 2) || (p.periodic[1] && p.ny % 2) ||
      (p.periodic[2] && p.nz % 2))
    return cudaErrorInvalidValue;
  const int np = 2 * nsweeps;
  // a and rhs in 16-byte chunks of rows where every row starts on one
  const bool vec = p.nz % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
#define MARCH_LAUNCH(TT, NPP, WW, DD)                                     \
  if constexpr (std::is_same<T, TT>::value) {                             \
    if (np == NPP && tile == WW)                                          \
      return vec ? launch_form<TT, NPP, WW, DD, true, C>(                 \
                       u, rhs, a, out, p, base, xseg, stream)             \
                 : launch_form<TT, NPP, WW, DD, false, C>(                \
                       u, rhs, a, out, p, base, xseg, stream);            \
  }
  MARCH_FORMS(MARCH_LAUNCH)
#undef MARCH_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point: out <- nsweeps (2 or 4) sweeps of u with tiles of width
// `tile` (one of MARCH_FORMS) and x segments of `xseg` planes; u is not
// modified and out must not alias it. compute: 0 the passes at the
// operands' precision, 1 in bf16 (f32 operands: the bf16 tier).
extern "C" int mgk_multisweep_relax(const void* u, const void* rhs,
                                    const void* a, void* out, int is_double,
                                    int compute, int nx, int ny, int nz,
                                    const int* kinds, double rho,
                                    double alpha, double beta, double dx,
                                    int base, int nsweeps, int tile,
                                    int xseg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (compute < 0 || compute > 1 || (compute == 1 && is_double))
    return (int)cudaErrorInvalidValue;
  if (is_double) {
    auto p = make_level_params<double>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_multisweep<double, double>(
        (const double*)u, (const double*)rhs, (const double*)a, (double*)out,
        p, base, nsweeps, tile, xseg, st);
  }
  auto p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  if (compute == 1)
    return (int)launch_multisweep<float, __nv_bfloat16>(
        (const float*)u, (const float*)rhs, (const float*)a, (float*)out, p,
        base, nsweeps, tile, xseg, st);
  return (int)launch_multisweep<float, float>(
      (const float*)u, (const float*)rhs, (const float*)a, (float*)out, p,
      base, nsweeps, tile, xseg, st);
}

// C entry point: *capacity <- blocks of the form (type, arithmetic as
// mgk_multisweep_relax's compute, nsweeps, tile) that the current device
// runs at once (the x segments are cut for it).
extern "C" int mgk_multisweep_capacity(int is_double, int compute,
                                       int nsweeps, int tile,
                                       int* capacity) {
  const int np = 2 * nsweeps;
  if (compute < 0 || compute > 1 || (compute == 1 && is_double))
    return (int)cudaErrorInvalidValue;
#define MARCH_CAPACITY(TT, NPP, WW, DD)                               \
  if (is_double == (int)std::is_same<TT, double>::value && np == NPP && \
      tile == WW)                                                     \
    return (int)(compute == 1 && std::is_same<TT, float>::value       \
                     ? form_capacity<TT, NPP, WW, DD, false,          \
                                     tier_t<TT>>(capacity)            \
                     : form_capacity<TT, NPP, WW, DD, false, TT>(     \
                           capacity));
  MARCH_FORMS(MARCH_CAPACITY)
#undef MARCH_CAPACITY
  return (int)cudaErrorInvalidValue;
}
