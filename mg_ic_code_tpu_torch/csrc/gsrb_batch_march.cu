// gsrb_relax_batch in its "march" form: nsweeps (2 or 4) red-black
// Gauss-Seidel sweeps of P same-shape levels (the sibling patches of a batch
// group, ops/fused_sweeps.gsrb_relax_batch) in ONE cooperative launch, each
// patch swept by the march of csrc/multisweep_march.cuh with gsrb_relax's
// own per-cell arithmetic, so that each patch is bit for bit its single
// gsrb_relax call (csrc/gsrb_relax.cu).
//
// It replaces no TPU kernel of its own: the JAX package sweeps a batch group
// as one vmapped XLA body (mg_ic_code_tpu/solver/multigrid.py: relax_xla),
// and the port's batched kernels serve the row of the single one,
// mg_ic_code_tpu/ops/fused_sweeps.py: resident_relax.
//
// Why a march: where the P patches' arrays overflow the 50 MB L2 that one
// patch's fit (two f32 144^3 patches: 96 MB), gsrb_relax's grid form run
// side by side sends every colour pass to device memory, and the "serial"
// form of csrc/gsrb_relax.cu takes the patches one after the other, a grid
// barrier a pass: a group costs what its P single calls cost. The march
// reads each array from device memory once a chunk of two sweeps, whatever
// the L2 holds; and where one patch's march fills half of the card (64
// blocks of one per SM at 144^3), P patches fill it at the same step count.
//
// What bounds it on this card: the time of one step (the instructions of NP
// cell updates and of the fold of the plane that enters, the block
// barrier), times the steps of a block (xseg + 3 NP) and the rounds of
// blocks; the bytes (each array read once a chunk, with the rind, and u
// written once) are well below it.
//
// Design:
//  * The march of csrc/multisweep.cu (whose header comment and
//    multisweep_march.cuh say why): a block owns a W x W y-z tile and an x
//    segment of one patch, a ring of R = NP + D + 1 planes of u (colour
//    split, WaveLayout), a and rhs filled by cp.async, pass p on plane
//    t - p, one barrier a step, a rind of NP cells recomputed on every open
//    side. NP = 4: two sweeps a chunk.
//  * The work items (patch, x segment, y tile, z tile: z fastest) are taken
//    in rounds by min(items, capacity) blocks that the card runs at once; 4
//    sweeps are two chunks in the one launch: u -> tmp, a grid barrier, tmp
//    -> out (2 sweeps: u -> out). Chunks never read what they write, and
//    the second reads tmp only after the barrier (its one-element copies go
//    through L1, which held no line of tmp: the first chunk only wrote it).
//  * Each cell's update is gsrb_update_row's (csrc/gsrb_device.cuh), every
//    operation written as an intrinsic in the order and with the
//    contractions that its compiled form has on sm_90a (the SASS of
//    the one-pass kernel of the time, gsrb_pass_kernel<float>, which the
//    grid and slab forms agree with bit for bit): a = alpha a_cell rounded, diag = a + 6 beta/dx^2 rounded (not
//    fused), lambda = 1 / diag, P = lambda beta/dx^2, per axis acc =
//    fma(up, P wa, acc), fma(um, P wb, acc), k_uc = fma(P, c_sum - 6,
//    fma(-a, lambda, 1)), and the new value
//    fma(rhs, lambda, u k_uc) + acc. Written as plain C, the same
//    expressions split across the fold below contracted otherwise (3e-7 off
//    the single calls, 14 % of the cells differing, on an H100).
//  * A plane is folded once, in the step before its first pass (plane xs
//    before the first step), by the pair's owner for its two columns: k_uc
//    over a in the ring and lambda in a third array beside a and rhs, so
//    that a pass divides no more (one division a cell a pass, twice the
//    folds a step, took 2.85 us a step at 144^3 on an H100). The three
//    arrays take R (PLANE + 3 W^2) floats of shared memory: 232,176 bytes at
//    W = 44 (D = 2), within a block's 227 KB.
//  * A W = 44 block's 968 threads have 64 registers each, so what every
//    block reads alike (the level's constants, the plane stride) is read
//    from the __grid_constant__ argument where it is used: copied into
//    each thread's registers it spilled 80 bytes and the 144^3 pair read
//    0.211 ms against 0.185 (scripts/batch_probe.py --march, an H100).
//  * No axis periodic: the entry refuses one. The groups that overflow the
//    L2 are AMR patches, whose faces are coarse-fine and physical.
//  * A column outside the level (past a y or z face) is never
//    fetched nor folded: its zeros read as lambda = k_uc = rhs = 0, and its
//    updates stay +0 (P is 0): so are the tile's padding cells, so a y or z
//    neighbour across a face reads 0 as it is, the operand gsrb_update_row
//    masks it to; past an x face the march reads the cell itself, masked.
//  * One tile width, W = 44 (36 columns written a side: 144 = 4 x 36), the
//    one a group that overflows the L2 takes (fused_sweeps.
//    batch_march_supported), with a and rhs fetched in 16-byte chunks (V)
//    or one element a copy. f32 with constant b only; f64 keeps
//    gsrb_relax's forms (a W = 32 f64 tile's three arrays do not fit a
//    block's shared memory).
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "multisweep_march.cuh"

namespace cg = cooperative_groups;

namespace {

// patches of one launch at most (fused_sweeps.BATCH_MAX)
constexpr int kMaxBatch = 16;
// colour passes a chunk (two sweeps)
constexpr int kNP = 4;
// the tile width and the planes fetched ahead (fused_sweeps.BATCH_MARCH_TILE)
constexpr int kW = 44;
constexpr int kD = 2;
// planes of the rings
constexpr int kR = kNP + kD + 1;
using Layout = WaveLayout<kW, kW>;
// threads of a block: one z-pair of the tile each
constexpr int kThreads = kW * kW / 2;
// floats of a coefficient slot: a (k_uc once folded), rhs, lambda
constexpr int kCS = 3 * kW * kW;

// Everything one launch needs, passed by value as a __grid_constant__
// kernel parameter: patch k's operands at index k (the header says why the
// level's constants are read from it where they are used).
struct BatchArgs {
  LevelParams<float> p;
  long long sx;  // plane stride of the level arrays
  const float* u[kMaxBatch];  // the caller's state, only read
  const float* rhs[kMaxBatch];
  const float* a[kMaxBatch];
  float* tmp[kMaxBatch];  // the state between the chunks (two chunks)
  float* out[kMaxBatch];
  int npatch, nchunk;  // patches; chunks of two sweeps
  int base;            // sum(lo) of any patch (one parity)
  int xseg, nseg;      // planes of an x segment (all but the last); segments
  int nty, ntz;        // y and z tiles of a patch
};

// One z-pair of a tile row (the whole level's MarchPair of csrc/
// multisweep.cu, for this update): where its columns live in the level and
// in the rings, the fold of its row's y faces and its columns' z indices.
// Column c of the pair lives in colour half h = c ^ jb of its row.
struct Pair {
  float* cell;  // u ring slot 0: the pair's place in half 0 of its row
  float* co;    // a of the pair in slot 0 of the a, rhs ring (rhs W^2 on)
  unsigned scell, sco;  // the same as shared-memory addresses
  // V: the 16 bytes of a or rhs this pair fetches, source in plane 0 (null:
  // outside the level) and shared address in slot 0
  const float* chunk_src;
  unsigned chunk_dst;
  int coff[2];  // offset of each column inside a plane of the level
  int par;      // row + first column + sum(lo)
  int jb;       // row parity
  bool live[2], own[2];
  bool own_both;  // both columns written, side by side: one 2-wide store
  bool face;      // a pair of the thread's warp touches a y or z face
  AxisFold<float> fy, fz[2];  // the folds of the y and z faces
  float cs[2];  // the c0 sum of a plane off the x faces (row_fold's order)
};

struct Thread {
  const float* u;  // this chunk's source of u (the caller's, or tmp)
  const float* rhs;
  const float* a;
  float* out;  // this chunk's result (tmp, or the caller's out)
  int xs, xe, x0, x1;  // planes worked on [xs, xe), written [x0, x1)
  Pair p;
};

// The x faces' fold of plane q (none where the step is steady: its planes
// are off them)
template <bool STEADY>
__device__ __forceinline__ AxisFold<float> x_fold(const LevelParams<float>& p,
                                                  int q) {
  return face_fold<float>(!STEADY && q == 0, !STEADY && q == p.nx - 1,
                          p.c0[0][0], p.c1[0][0], p.c0[0][1], p.c1[0][1]);
}

// The c0 sum of a cell's faces, row_fold's and gsrb_update_row's: 0, then
// x's, y's and z's term, each add rounded.
__device__ __forceinline__ float face_sum(float cx, float cy, float cz) {
  return __fadd_rn(__fadd_rn(__fadd_rn(0.0f, cx), cy), cz);
}

// The fold of one cell from a = av and its faces' c0 sum: lambda and k_uc,
// gsrb_update_row's operations as compiled (the header says which).
__device__ __forceinline__ void cell_fold(float av, float c_sum, float alpha,
                                          float six_b_inv, float b_inv,
                                          float& lam, float& k_uc) {
  const float aa = __fmul_rn(alpha, av);
  lam = __fdiv_rn(1.0f, __fadd_rn(aa, six_b_inv));
  const float P = __fmul_rn(lam, b_inv);
  k_uc = __fmaf_rn(P, __fadd_rn(c_sum, -6.0f), __fmaf_rn(-aa, lam, 1.0f));
}

// One axis of the update: acc + (P wa) up + (P wb) um with a neighbour
// across a face read as 0 (fold_axis, as compiled). FACE false: the cell
// is at no face of the axis (wa = wb = 1: P wa is P, exactly). MASK false:
// a neighbour across a face is 0 already (y and z: a column outside the
// level, or the tile's zero padding), so it is read as it is: the same
// operands.
template <bool FACE, bool MASK>
__device__ __forceinline__ float axis_term(float up, float um,
                                           const AxisFold<float>& f, float P,
                                           float acc) {
  if (!FACE) return __fmaf_rn(um, P, __fmaf_rn(up, P, acc));
  acc = __fmaf_rn(MASK && f.hi ? 0.0f : up, __fmul_rn(P, f.wa), acc);
  return __fmaf_rn(MASK && f.lo ? 0.0f : um, __fmul_rn(P, f.wb), acc);
}

// The new value of a cell from its value uc, its neighbours (x, y, z), its
// plane's fold (lambda, k_uc), rhs = rv and the folds of its faces (XFACE
// false: no x face, fx unread; YZFACE false: no y or z face, fy, fz unread).
template <bool XFACE, bool YZFACE>
__device__ __forceinline__ float cell_pass(
    float uc, const float (&up)[3], const float (&um)[3], float lam,
    float k_uc, float rv, const AxisFold<float>& fx,
    const AxisFold<float>& fy, const AxisFold<float>& fz, float b_inv) {
  const float P = __fmul_rn(lam, b_inv);
  float acc = axis_term<XFACE, true>(up[0], um[0], fx, P, 0.0f);
  acc = axis_term<YZFACE, false>(up[1], um[1], fy, P, acc);
  acc = axis_term<YZFACE, false>(up[2], um[2], fz, P, acc);
  return __fadd_rn(__fmaf_rn(rv, lam, __fmul_rn(uc, k_uc)), acc);
}

// Start the copies of level plane xq into ring slot s: u of the thread's
// live columns (one element a copy), and a and rhs: one element a copy into
// the pair's colour halves, or (V) the pair's 16-byte chunk of a row.
template <bool V>
__device__ __forceinline__ void fetch_plane(const BatchArgs& g,
                                            const Thread& w, int xq, int s) {
  constexpr int NPAIR = kW * kW / 2;
  const long long o = (long long)xq * g.sx;
  const Pair& p = w.p;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!p.live[c]) continue;
    const long long g = o + p.coff[c];
    const unsigned h = (unsigned)(c ^ p.jb);
    copy_async(p.scell + (s * Layout::PLANE + h * Layout::HP) * 4u, w.u + g);
    if (!V) {
      copy_async(p.sco + (s * kCS + h * NPAIR) * 4u, w.a + g);
      copy_async(p.sco + (s * kCS + kW * kW + h * NPAIR) * 4u, w.rhs + g);
    }
  }
  if (V && p.chunk_src)
    copy_chunk(p.chunk_dst + s * kCS * 4u, p.chunk_src + o);
}

// The fold of plane q in ring slot s, in place: each live column's k_uc over
// its a, its lambda in the third array; the x face from q where the step is
// not steady (a steady step's planes are off the x faces).
template <bool V, bool STEADY>
__device__ __forceinline__ void fold_plane(const BatchArgs& g,
                                           const Thread& w, int q, int s) {
  constexpr int NPAIR = kW * kW / 2;
  const Pair& p = w.p;
  const AxisFold<float> fx = x_fold<STEADY>(g.p, q);
  float* const co = p.co + s * kCS;
  // both columns' folds, then the stores of the live ones (a column
  // outside the level reads a = 0: its fold is finite, and unstored)
  float lam[2], k[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float cs = STEADY ? p.cs[c] : face_sum(fx.c, p.fy.c, p.fz[c].c);
    cell_fold(co[V ? c : (c ^ p.jb) * NPAIR], cs, g.p.alpha, g.p.six_b_inv,
              g.p.b_inv, lam[c], k[c]);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (!p.live[c]) continue;
    float* const ca = co + (V ? c : (c ^ p.jb) * NPAIR);
    ca[0] = k[c];
    ca[2 * kW * kW] = lam[c];
  }
}

// One step of the march: pass ps works on plane t - ps for ps = 0 .. NP-1,
// in each pair's column whose cells have this step's colour; plane t + D is
// fetched and plane t + 1 folded; both columns of plane t - NP + 1 are
// final and written. STEADY (the whole level's march_step says when):
// every plane in the segment, off the x faces, the slot of plane t the
// compile-time ST; otherwise `st_rt` is its slot and every pass is tested.
template <bool V, bool STEADY, int ST>
__device__ __forceinline__ void march_step(const BatchArgs& g, Thread& w,
                                           const int t, const int st_rt) {
  constexpr int NP = kNP, R = kR, D = kD;
  constexpr int HP = Layout::HP, PZ = Layout::PZ, PLANE = Layout::PLANE;
  constexpr int NPAIR = kW * kW / 2;
  const int st = STEADY ? ST : st_rt;
  auto slot = [&](int d) {  // slot of plane t + d, -R < d < R
    int s = st + d;
    if (s < 0) s += R;
    if (s >= R) s -= R;
    return s;
  };
  auto valid = [&](int q) { return STEADY || (q >= w.xs && q < w.xe); };

  // this thread's copies of plane t + 1 (and so of t .. t - NP) are in;
  // planes t .. t - NP + 1 were folded before the barrier of step t - 1 by
  // this thread (only the pair's owner reads its columns)
  copy_wait<D - 2>();
  const Pair& p = w.p;
  const int c = (t + p.par) & 1;  // the pair's column this step updates
  const int h = c ^ p.jb;         // its colour half
  float* const rb = p.cell + h * HP;
  float own_u[NP + 2];
#pragma unroll
  for (int i = 0; i < NP + 2; ++i) own_u[i] = rb[slot(1 - i) * PLANE];
  __syncthreads();

  // plane t + D: its slot held plane t + D - R = t - NP - 1, which the
  // steps before this barrier were the last to read
  if (STEADY || t + D < w.xe) fetch_plane<V>(g, w, t + D, slot(D));
  copy_commit();
  // plane t + 1, whose first pass is the next step's: its a and rhs are in
  // and seen by all since this barrier, and no pass of this step reads it
  if (STEADY || t + 1 < w.xe) fold_plane<V, STEADY>(g, w, t + 1, slot(1));

  const int qo = t - NP + 1;  // the plane whose last pass this step runs
  const bool write = qo >= w.x0 && qo < w.x1;
  float* const oplane = w.out + qo * g.sx;
  const int dh = (1 - 2 * h) * HP;  // from this half to the other
  const float* yp = rb + (dh + PZ);
  const float* ym = rb + (dh - PZ);
  const float* zp = rb + (dh + c);      // even column: same index, odd: +1
  const float* zm = rb + (dh + c - 1);  // even column: index - 1, odd: same
  const AxisFold<float> fz = c ? p.fz[1] : p.fz[0];
  const float* const cb = p.co + (V ? c : h * NPAIR);
  float up = own_u[0], last = 0.0f;
  bool have_up = STEADY;
  // the passes, with the y and z face rule (YZ) or without (a warp of
  // pairs at no y or z face: their weights are P's, exactly)
  const auto passes = [&](auto yz) {
    constexpr bool YZ = decltype(yz)::value;
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const int q = t - ps;
      if (!valid(q)) continue;
      const int o = slot(-ps) * PLANE;
      const float* const cp = cb + slot(-ps) * kCS;
      const float uc = own_u[ps + 1];
      // beyond an open segment end the cell reads itself
      const float upv = have_up ? up : (q + 1 < w.xe ? own_u[ps] : uc);
      const float umv = STEADY || q > w.xs ? own_u[ps + 2] : uc;
      const AxisFold<float> fx = x_fold<STEADY>(g.p, q);
      const float upn[3] = {upv, yp[o], zp[o]};
      const float umn[3] = {umv, ym[o], zm[o]};
      // the plane's fold: k_uc over a, rhs, lambda
      const float un = cell_pass<!STEADY, YZ>(uc, upn, umn, cp[2 * kW * kW],
                                              cp[0], cp[kW * kW], fx, p.fy,
                                              fz, g.p.b_inv);
      rb[o] = un;
      up = un;
      have_up = true;
      last = un;
    }
  };
  if (p.face)
    passes(std::true_type{});
  else
    passes(std::false_type{});
  // plane qo: the active column's last pass was the step's last update,
  // the other column has been final since the step before
  if (write) {
    const float other = rb[slot(1 - NP) * PLANE + dh];
    if (p.own_both) {
      store_pair(oplane + p.coff[0], c ? other : last, c ? last : other);
    } else {
      if (c ? p.own[1] : p.own[0]) oplane[c ? p.coff[1] : p.coff[0]] = last;
      if (c ? p.own[0] : p.own[1]) oplane[c ? p.coff[0] : p.coff[1]] = other;
    }
  }
}

// R steady steps from slot ST on, each with its slot a constant
template <bool V, int ST>
__device__ __forceinline__ void steady_steps(const BatchArgs& g, Thread& w,
                                             int t) {
  march_step<V, true, ST>(g, w, t + ST, ST);
  if constexpr (ST + 1 < kR) steady_steps<V, ST + 1>(g, w, t);
}

// One work item: x segment `seg` of the (ty, tz) tile of a patch, from
// src to dst, the patch's rhs and a.
template <bool V>
__device__ __forceinline__ void march_item(float* ring, const BatchArgs& g,
                                           const float* src, const float* rhs,
                                           const float* a, float* dst,
                                           int seg, int ty, int tz) {
  constexpr int NP = kNP, R = kR, D = kD, W = kW;
  constexpr int HZ = Layout::HZ;
  constexpr int TI = W - 2 * NP;  // columns written per side
  static_assert(D >= 2, "plane t + 1 must be fetched before step t");
  const LevelParams<float>& p = g.p;
  float* const coef = ring + R * Layout::PLANE;
  // zero the rings: the padding and the columns outside the level start at
  // zero, and no slot ever holds anything but finite values (the item
  // before is done with them: the barrier)
  __syncthreads();
  for (int i = threadIdx.x; i < R * (Layout::PLANE + kCS); i += kThreads)
    ring[i] = 0.0f;
  __syncthreads();

  Thread w;
  w.u = src; w.rhs = rhs; w.a = a; w.out = dst;
  w.x0 = seg * g.xseg;
  w.x1 = min(p.nx, w.x0 + g.xseg);
  w.xs = max(0, w.x0 - NP);
  w.xe = min(p.nx, w.x1 + NP);

  Pair& q = w.p;
  const int pidx = (int)threadIdx.x;
  const int kk = pidx % HZ, jj = pidx / HZ, lk = 2 * kk;
  // global indices of the pair's row and first column (negative before
  // the level)
  const int gj = ty * TI - NP + jj;
  const int gk = tz * TI - NP + lk;
  q.cell = ring + (jj + 1) * Layout::PZ + kk + 1;
  // the coefficient ring: per slot 3 W^2 floats, a (k_uc once folded), rhs,
  // lambda; without V column c at co[h * NPAIR] (h = c ^ jb, co = coef +
  // pidx), with V each plane in its own layout (row jj, column lk + c at
  // co[c])
  q.co = V ? coef + jj * W + lk : coef + pidx;
  q.scell = shared_address(q.cell);
  q.sco = shared_address(q.co);
  q.jb = jj & 1;
  q.par = gj + gk + g.base;
  const bool live_j = gj >= 0 && gj < p.ny;
  const bool own_j = jj >= NP && jj < W - NP && gj < p.ny;
  q.chunk_src = nullptr;
  q.chunk_dst = 0;
  if (V) {
    // chunk pidx of a slot (4 floats of one row of a or rhs)
    const int arr = pidx / (W * W / 4), rem = pidx % (W * W / 4);
    const int row = rem / (W / 4), col = (rem % (W / 4)) * 4;
    const int cj = ty * TI - NP + row, ck = tz * TI - NP + col;
    const bool in = cj >= 0 && cj < p.ny && ck >= 0 && ck < p.nz;
    q.chunk_src = in ? (arr ? rhs : a) + (cj * p.nz + ck) : nullptr;
    q.chunk_dst = shared_address(coef + arr * W * W + row * W + col);
  }
  q.fy = face_fold<float>(gj == 0, gj == p.ny - 1, p.c0[1][0], p.c1[1][0],
                          p.c0[1][1], p.c1[1][1]);
  // the faces' c0 sum off the x faces: x's term is 0 + 0 there
  const AxisFold<float> fx0 = x_fold<true>(p, 0);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int gkc = gk + c;
    q.live[c] = live_j && gkc >= 0 && gkc < p.nz;
    q.own[c] = own_j && q.live[c] && lk + c >= NP && lk + c < W - NP;
    q.coff[c] = gj * p.nz + gkc;
    q.fz[c] = face_fold<float>(gkc == 0, gkc == p.nz - 1, p.c0[2][0],
                               p.c1[2][0], p.c0[2][1], p.c1[2][1]);
    q.cs[c] = face_sum(fx0.c, q.fy.c, q.fz[c].c);
  }
  q.own_both = q.own[0] && q.own[1] && p.nz % 2 == 0;
  // one path for the whole warp (a warp of face and other pairs would run
  // both)
  q.face = __ballot_sync(__activemask(),
                         q.fy.lo || q.fy.hi || q.fz[0].lo || q.fz[0].hi ||
                             q.fz[1].lo || q.fz[1].hi) != 0;

  // steps xs .. xe+NP-2; those in [lo_s, hi_s) are steady (the whole
  // level's march_kernel says why); plane q sits in slot (q - lo_s) mod R
  const int lo_s = w.xs + NP;
  const int hi_s = w.xe - D;
  int st = (w.xs - lo_s) % R;
  if (st < 0) st += R;
  // planes xs .. xs + D - 1 before the first step, one commit group each
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (w.xs + d < w.xe) {
      int s = st + d;
      if (s >= R) s -= R;
      fetch_plane<V>(g, w, w.xs + d, s);
    }
    copy_commit();
  }
  // plane xs in and seen by all (with V other threads copied its a and
  // rhs), then folded; each later plane in the step before its first pass
  copy_wait<D - 1>();
  __syncthreads();
  fold_plane<V, false>(g, w, w.xs, st);
  int t = w.xs;
  const int last = w.xe + NP - 1;
  for (; t < last && t < lo_s; ++t, st = st + 1 == R ? 0 : st + 1)
    march_step<V, false, 0>(g, w, t, st);
  for (; t + R <= hi_s; t += R)  // st == 0 here
    steady_steps<V, 0>(g, w, t);
  for (; t < last; ++t, st = st + 1 == R ? 0 : st + 1)
    march_step<V, false, 0>(g, w, t, st);
  copy_wait<0>();
}

template <bool V>
__global__ void __launch_bounds__(kThreads, 1)
batch_march_kernel(const __grid_constant__ BatchArgs g) {
  extern __shared__ __align__(16) unsigned char batch_smem[];
  float* const ring = reinterpret_cast<float*>(batch_smem);
  const int tiles = g.nty * g.ntz;
  const int per_patch = g.nseg * tiles;
  const int items = g.npatch * per_patch;
  for (int chunk = 0; chunk < g.nchunk; ++chunk) {
    // the chunk before wrote tmp everywhere
    if (chunk > 0) cg::this_grid().sync();
    const bool first = chunk == 0, last = chunk + 1 == g.nchunk;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int patch = item / per_patch;
      int r = item - patch * per_patch;
      const int seg = r / tiles;
      r -= seg * tiles;
      const int ty = r / g.ntz, tz = r - ty * g.ntz;
      march_item<V>(ring, g, first ? g.u[patch] : g.tmp[patch],
                    g.rhs[patch], g.a[patch],
                    last ? g.out[patch] : g.tmp[patch], seg, ty, tz);
    }
  }
}

// bytes of shared memory a block takes: R planes of u and of the three
// coefficient arrays (fused_sweeps.BATCH_MARCH_SMEM)
constexpr size_t kSmem = (size_t)kR * (Layout::PLANE + kCS) * sizeof(float);
static_assert(kSmem <= 232448, "the form must fit a block's shared memory");
static_assert(kW - 2 * kNP > 0 && kW % 4 == 0, "tile");

// blocks of this form the current device runs at once; sets the kernel's
// shared-memory limit on first use per device
template <bool V>
cudaError_t form_capacity(int* capacity) {
  static int cache[kMaxDevices] = {};
  return march_capacity((const void*)batch_march_kernel<V>, kThreads, kSmem,
                        cache, capacity);
}

template <bool V>
cudaError_t launch_form(BatchArgs& g, int blocks, cudaStream_t stream) {
  int capacity = 0;
  cudaError_t err = form_capacity<V>(&capacity);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > capacity) return cudaErrorInvalidValue;
  void* params[] = {(void*)&g};
  return cudaLaunchCooperativeKernel((const void*)batch_march_kernel<V>,
                                     dim3(blocks), dim3(kThreads), params,
                                     kSmem, stream);
}

}  // namespace

// C entry point (csrc/mg_kernels.h's conventions): nsweeps (2 or 4)
// red-black sweeps of npatch (at most kMaxBatch) f32 levels of one shape,
// face kinds and parity (base = sum(lo) of any of them), constant bCoef,
// no axis periodic. ptrs: the patches' u (only read), rhs, a, out, then tmp
// (each npatch long; tmp the state between the chunks, read only with 4
// sweeps); geo (fused_sweeps.batch_march_geometry's launch, kept per shape:
// one array a call): npatch, nx, ny, nz, nsweeps, the tile width (kW), the
// x segment length, the blocks (at most the form's capacity,
// mgk_gsrb_batch_march_capacity), then the six face kinds. The same
// arithmetic per cell as mgk_gsrb_relax.
extern "C" int mgk_gsrb_batch_march(const void* const* ptrs, const int* geo,
                                    double rho, double alpha, double beta,
                                    double dx, int base, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int npatch = geo[0], nx = geo[1], ny = geo[2], nz = geo[3];
  const int nsweeps = geo[4], tile = geo[5], xseg = geo[6], blocks = geo[7];
  const int* kinds = geo + 8;
  if (npatch < 1 || npatch > kMaxBatch || (nsweeps != 2 && nsweeps != 4) ||
      tile != kW || xseg < 1 || nx < 2 || ny < 2 || nz < 2 ||
      (long long)nx * ny * nz >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  BatchArgs g = {};
  g.p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  g.sx = (long long)ny * nz;
  if (g.p.periodic[0] || g.p.periodic[1] || g.p.periodic[2])
    return (int)cudaErrorInvalidValue;
  g.npatch = npatch;
  g.nchunk = nsweeps / 2;
  unsigned long long bits = 0;  // of a and rhs: 16-byte chunks or not
  for (int k = 0; k < npatch; ++k) {
    g.u[k] = (const float*)ptrs[k];
    g.rhs[k] = (const float*)ptrs[npatch + k];
    g.a[k] = (const float*)ptrs[2 * npatch + k];
    g.out[k] = (float*)ptrs[3 * npatch + k];
    g.tmp[k] = (float*)ptrs[4 * npatch + k];
    if (g.nchunk > 1 && g.tmp[k] == nullptr)
      return (int)cudaErrorInvalidValue;
    bits |= (unsigned long long)ptrs[npatch + k] |
            (unsigned long long)ptrs[2 * npatch + k];
  }
  g.base = base;
  g.xseg = xseg;
  g.nseg = (nx + xseg - 1) / xseg;
  const int ti = kW - 2 * kNP;
  g.nty = (ny + ti - 1) / ti;
  g.ntz = (nz + ti - 1) / ti;
  const bool vec = nz % 4 == 0 && (bits & 15) == 0;
  return (int)(vec ? launch_form<true>(g, blocks, st)
                   : launch_form<false>(g, blocks, st));
}

// C entry point: *capacity <- blocks of the march that the current device
// runs at once (the least of its two forms: a and rhs in 16-byte chunks or
// not), which a cooperative launch must not exceed; tile must be kW.
extern "C" int mgk_gsrb_batch_march_capacity(int tile, int* capacity) {
  if (tile != kW) return (int)cudaErrorInvalidValue;
  int vec = 0, one = 0;
  cudaError_t err = form_capacity<true>(&vec);
  if (err == cudaSuccess) err = form_capacity<false>(&one);
  *capacity = vec < one ? vec : one;
  return (int)err;
}
