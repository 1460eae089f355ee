// multisweep_relax: nsweeps red-black Gauss-Seidel sweeps of one level in ONE
// launch, carried along x in shared memory with the halo recomputed, for ANY
// face kinds including periodic x.
//
// One kernel replaces five TPU kernels that compute one function (what
// gsrb_relax computes, csrc/gsrb_relax.cu: the same folded per-cell update,
// parity (i+j+k+sum(lo)+pass) & 1, the homogeneous ghost rule re-derived
// from the current interior before every colour pass, for constant bCoef)
// and differ in how a TPU core schedules and tiles it:
//   mg_ic_code_tpu/ops/wavefront.py:wavefront_relax, :wavefront_relax_flat
//       (time-skewed in x from the x faces, x not periodic; 3-D and flat
//       layout) -- ops/wavefront.wavefront_relax calls this kernel with x
//       open,
//   mg_ic_code_tpu/ops/fused_sweeps.py:multisweep_relax_pipelined (x slabs
//       of full rows with 2*nsweeps-row halo blocks, index maps that wrap
//       for periodic x), :multisweep_relax_flat_pipelined (the same in the
//       (nx, ny*nz) layout), :multisweep_relax_tiled ((x, y) tiles with a
//       2*nsweeps halo both ways, wrap or ghost pads)
//       -- ops/fused_sweeps.multisweep_relax, any face kinds.
// The halo recompute of the last three is what the time-skewed march does at
// every open segment end and tile side anyway, so one march serves both: a
// periodic x only makes both ends of every x segment open.
//
// What bounds it on this card: gsrb_relax is bound by bytes, because each of
// its 2*nsweeps colour passes is a launch that streams the level through
// device memory again. This march carries all NP = 2*nsweeps passes along x
// in on-chip memory, so u, rhs and a are read once and u is written once
// per call (times the rind factor below); what is left is the arithmetic
// and one block barrier per plane.
//
// Design (not the TPU schedules, which hold whole (W, ny, nz) windows or
// slabs in on-chip memory and walk x on one core):
//  * A block owns a TY x TZ tile of the y-z plane and a segment of x, and
//    marches along x. A rind of NP cells on every tile side and NP planes at
//    each open segment end is recomputed redundantly, so blocks never wait
//    on each other: a wrong value at an open edge moves inward one cell per
//    pass and never reaches the cells the block writes. Domain faces need no
//    rind: their ghost rule comes from the cell's index (fold_terms).
//  * x may be periodic, decided at run time (wrapx). A periodic x has no
//    face to start from, so EVERY segment end is open: the first segment
//    starts NP planes before plane 0 and the last ends NP planes after
//    plane nx-1, and the planes a block reads are taken modulo nx from the
//    input array (never from the output, so one segment may wrap onto its
//    own planes). The parity of a plane keeps the unwrapped index, which
//    agrees across the wrap only for an even nx. With x open the flag is
//    read in the general steps only; a separate set of instantiations with
//    that code compiled out was timed beside this one at 512x96x96 and
//    960x144x144 (NVIDIA H100 80GB HBM3, 700 W) and was within 3 % either
//    way, so there is one set.
//  * A ring of NP + 2 planes of u in shared memory holds the staircase: at
//    step t, pass p works on plane t - p, for p = 0 .. NP-1.
//  * With that skew a cell (t - p, j, k) of pass p has the colour of the
//    pass exactly when (t + j + k + sum(lo)) is even: in one step the same
//    y-z columns are updated in every plane of the staircase, and every
//    in-plane neighbour that is read lies in a column nobody writes in this
//    step. The x neighbours lie in the thread's own column. So a thread
//    that owns a column runs its NP updates of a step one after the other,
//    p ascending (pass p on plane q, then pass p+1 on plane q-1: the order
//    Gauss-Seidel needs; the TPU wavefront kernel keeps the pre-update plane
//    in d_ref for it), and the block needs ONE barrier per step.
//  * A thread owns the z-pair (2kk, 2kk+1) of one tile row: one of the two
//    columns is active in each step. It loads its pair of u of plane t + 2
//    while step t computes, and writes plane t - NP + 1 when its last pass
//    is done. rhs and a of a cell are read at each of its NP/2 updates, all
//    within NP steps of the front: the first read comes from device memory,
//    the others from L1/L2 (a block touches NP planes of its tile at a
//    time). Within a step the coefficient loads are started before the
//    barrier, then the own column and the y and z neighbours of all NP
//    passes are read from shared memory at once, and the NP dependent
//    updates run from registers (y and z terms are summed before the x
//    terms are added, and a periodic axis uses weights of 1 instead of
//    P*(up + um): ulps away from gsrb_relax, not bitwise).
//  * A first version kept lambda, 1 - lambda*alpha*a and lambda*rhs of the
//    planes in flight in per-thread shift registers across steps; it gave
//    wrong last passes in some instantiations, the cause was not found, and
//    it was dropped. (Check every instantiation, f32 and f64, NP = 4 and 8,
//    periodic x and not, on the card after any change to a step.)
//  * The march is bound by instruction throughput, not by bytes (the first
//    form ran 190 machine operations per update). So it has a steady
//    form (wave_step<STEADY>) for the steps whose whole staircase lies
//    inside the segment, off the x faces and off the periodic wrap: no
//    validity tests, no x-face rule, no modulo, and the ring slot of every
//    plane a compile-time constant (one instantiation per slot of plane t),
//    so that every shared-memory address is the thread's base plus an
//    immediate. The first and last steps of a segment take the general
//    form. Between barriers the phases of a step do not overlap (one block
//    per multiprocessor), so each was cut: a and rhs of the newest plane
//    are asked for a step ahead; a plane is stored by colour (WaveLayout)
//    so that the cells of a step are consecutive in shared memory, free of
//    bank conflicts; 1/d is the hardware's reciprocal plus a Newton step.
//
// Tile and chunk: 40 x 40 columns (800 threads, 52 KB of f32 ring at
// nsweeps = 2). The solver sends 4 sweeps as two launches of nsweeps = 2
// (NP = 4): 32 x 32 cells written of 40 x 40 computed, a rind factor of
// (1 + 4*nsweeps/32)^2 = 1.56 on traffic and arithmetic per launch; one
// launch of nsweeps = 4 (NP = 8) writes 24 x 24 of 40 x 40 (2.78) and was
// slower, so the solver does not send it; it is built so that the 2-or-4
// choice can be measured again. x is cut into segments no shorter than
// 8*NP planes, as many as fill the card's rounds of resident blocks best.
// (A 32 x 32 tile was timed beside it and was no faster at 512x96x96 and
// above.) Shared memory is read with plain loads; no TMA, no clusters.
#include "mg_kernels.h"

namespace {

// 1/d. For float: the hardware's approximate reciprocal and one Newton
// step (within an ulp of the rounded quotient, and no slow path to branch
// to); d = alpha*a + 6*beta/dx^2 is far from the denormal range.
__device__ __forceinline__ float recip(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(r, fmaf(-d, r, 1.0f), r);
}
__device__ __forceinline__ double recip(double d) { return 1.0 / d; }

// Shared-memory layout of one plane of a TY x TZ tile. The cells of a row
// are stored by colour: the HZ cells with (row + column) even in one half
// of the row, the others in the other half, each half padded by one cell on
// both sides, the plane by one row above and below; the padding stays
// zero and stands in for neighbours outside the tile. All cells a step
// updates then lie in the same half at consecutive addresses (no bank
// conflict), and a neighbour is the base address plus a constant. PZ, the
// row stride, is HZ modulo 32 so that the rows of a warp fall on
// different banks.
template <int TY, int TZ>
struct WaveLayout {
  static constexpr int HZ = TZ / 2;   // z-pairs per row
  static constexpr int HP = HZ + 2;   // one padded half
  static constexpr int PZ = 2 * HP + ((HZ - 2 * HP) % 32 + 32) % 32;
  static constexpr int PLANE = (TY + 2) * PZ;
};

// What one thread carries along x: its pair of columns (z = 2kk, 2kk+1 of
// one tile row), where they live in the arrays and in the ring, and the
// folded weights of the y and z faces they touch.
template <typename T>
struct WaveThread {
  const T* u; const T* rhs; const T* a; T* out;
  T* cell;           // ring slot 0, the pair's place in the first half
  long long sx;      // plane stride of the level arrays
  int coff[2];       // offset of each column inside a plane
  int xs, xe, x0, x1, nx;  // planes worked on [xs, xe), written [x0, x1)
  int par;           // row + first column + sum(lo), unwrapped indices
  bool wrapx;        // x is periodic: planes are taken modulo nx
  int jpar;          // parity of the row inside the tile
  bool live[2], own[2];
  T alpha, six_b_inv, b_inv;
  T c0xlo, c1xlo, c0xhi, c1xhi;  // x-face ghost rule
  T wya, wyb;        // weight of the y+1 / y-1 neighbour (0 across a face,
  T wza[2], wzb[2];  //   1 + c1 at it, 1 inside), same for z per column
  T csy, csz[2];     // c0 feed-through of the y / z faces
  T raw_u[2];        // u of the pair in the next plane to enter the ring
  T next_a, next_r;  // a, rhs of the next step's first cell
};

// Plane q of the march as a plane of the level arrays: q itself, or q modulo
// nx where x is periodic.
template <typename T>
__device__ __forceinline__ int xplane(const WaveThread<T>& w, int q) {
  if (w.wrapx) {
    q %= w.nx;
    if (q < 0) q += w.nx;
  }
  return q;
}

// One step of the march: plane t+1 enters the ring, plane t+2 is loaded,
// and pass ps works on plane t - ps for ps = 0 .. NP-1, in the pair's
// column whose cells have this step's colour.
//
// STEADY: every plane t+2 .. t-NP lies inside (xs, xe), inside [0, nx) and
// away from the x faces of the domain, so no pass needs a validity test, an
// x-face rule or a wrapped index, and the ring slot of plane t is the
// compile-time ST: every shared-memory address is the thread's base plus a
// constant. Otherwise `st` is t's slot at run time and every pass is tested.
template <typename T, int NP, int TY, int TZ, bool STEADY, int ST>
__device__ __forceinline__ void wave_step(WaveThread<T>& w, const int t,
                                          const int st_rt) {
  using L = WaveLayout<TY, TZ>;
  constexpr int R = NP + 2;
  constexpr int HP = L::HP, PZ = L::PZ, PLANE = L::PLANE;
  const int st = STEADY ? ST : st_rt;
  // plane q in the level arrays (a steady step never wraps)
  auto xq = [&](int q) { return STEADY ? q : xplane(w, q); };
  // slot of plane t + d
  auto slot = [&](int d) {
    int s = st + d;
    if (s < 0) s += R;
    if (s >= R) s -= R;
    return s;
  };
  // column 0 of the pair lives in half (row parity), column 1 in the other
  const int half0 = w.jpar ? HP : 0, half1 = HP - half0;

  if (STEADY || t + 1 < w.xe) {
    T* pl = w.cell + slot(1) * PLANE;
    pl[half0] = w.raw_u[0];
    pl[half1] = w.raw_u[1];
  }
  if (STEADY || t + 2 < w.xe) {
    const T* next = w.u + xq(t + 2) * w.sx;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      w.raw_u[c] = w.live[c] ? __ldg(next + w.coff[c]) : (T)0;
  }

  // the column of the pair whose cells have this step's colour
  const int c = (t + w.par) & 1;
  const bool act = c ? w.live[1] : w.live[0];
  const int col = c ? w.coff[1] : w.coff[0];
  // a, rhs of this step's cells: plane t came with the step before, the
  // older planes are in cache (loads in flight over the barrier), and the
  // next step's first cell is asked for now
  T av[NP], rv[NP];
  av[0] = w.next_a;
  rv[0] = w.next_r;
  const T* ap = w.a + t * w.sx;
  const T* rp = w.rhs + t * w.sx;
  const int sxi = (int)w.sx;
#pragma unroll
  for (int ps = 1; ps < NP; ++ps) {
    av[ps] = (T)0; rv[ps] = (T)0;
    if (STEADY) {
      if (act) {
        av[ps] = __ldg(ap + (col - ps * sxi));
        rv[ps] = __ldg(rp + (col - ps * sxi));
      }
    } else if (act && t - ps >= w.xs && t - ps < w.xe) {
      const long long o = xq(t - ps) * w.sx + col;
      av[ps] = __ldg(w.a + o);
      rv[ps] = __ldg(w.rhs + o);
    }
  }
  {
    const int ncol = c ? w.coff[0] : w.coff[1];
    w.next_a = (T)0; w.next_r = (T)0;
    if (STEADY) {
      if (c ? w.live[0] : w.live[1]) {
        w.next_a = __ldg(ap + (ncol + sxi));
        w.next_r = __ldg(rp + (ncol + sxi));
      }
    } else if ((c ? w.live[0] : w.live[1]) && t + 1 < w.xe) {
      const long long o = xq(t + 1) * w.sx + ncol;
      w.next_a = __ldg(w.a + o);
      w.next_r = __ldg(w.rhs + o);
    }
  }
  // P = lambda*beta/dx^2, 1 - lambda*alpha*a, lambda*rhs
  T Pc[NP], kc[NP], tr[NP];
#pragma unroll
  for (int ps = 0; ps < NP; ++ps) {
    const T aa = w.alpha * av[ps];
    const T lam = recip(aa + w.six_b_inv);
    Pc[ps] = lam * w.b_inv;
    kc[ps] = (T)1 - lam * aa;
    tr[ps] = lam * rv[ps];
  }
  __syncthreads();

  // the half the step's cells live in, and the way to the other half
  const int half = c ? half1 : half0;
  const int dh = HP - 2 * half;
  if (act) {
    // Everything a step reads was written before the barrier, apart from
    // the thread's own results: the own column of planes t+1 .. t-NP and
    // the y and z neighbours of every pass are loaded up front, and the NP
    // updates then run from registers.
    const T* rb = w.cell + half;
    const T* yp = rb + (dh + PZ);
    const T* ym = rb + (dh - PZ);
    const T* zp = rb + (dh + c);      // even column: same index, odd: +1
    const T* zm = rb + (dh + c - 1);  // even column: index - 1, odd: same
    const T wza = c ? w.wza[1] : w.wza[0], wzb = c ? w.wzb[1] : w.wzb[0];
    const T cz = c ? w.csz[1] : w.csz[0];
    T own_u[NP + 2];
#pragma unroll
    for (int i = 0; i < NP + 2; ++i) own_u[i] = rb[slot(1 - i) * PLANE];
    T yz[NP];
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const int o = slot(-ps) * PLANE;
      T nb = (Pc[ps] * w.wya) * yp[o];
      nb = nb + (Pc[ps] * w.wyb) * ym[o];
      nb = nb + (Pc[ps] * wza) * zp[o];
      nb = nb + (Pc[ps] * wzb) * zm[o];
      yz[ps] = nb;
    }
    T* wb = w.cell + half;
    T up = own_u[0];
    bool have_up = STEADY;
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const int q = t - ps;
      if (!STEADY && (q < w.xs || q >= w.xe)) continue;
      const T uc = own_u[ps + 1];
      T nb = (T)0, cs = (T)0;
      if (STEADY) {
        nb = Pc[ps] * up;
        nb = nb + Pc[ps] * own_u[ps + 2];
      } else {
        // beyond an open segment end the cell reads itself
        const T upv = have_up ? up : (q + 1 < w.xe ? own_u[ps] : uc);
        const T umv = q > w.xs ? own_u[ps + 2] : uc;
        const bool xface = !w.wrapx;
        fold_terms<T>(upv, umv, xface && q == 0, xface && q == w.nx - 1,
                      w.c0xlo, w.c1xlo, w.c0xhi, w.c1xhi, Pc[ps], nb, cs);
      }
      cs = (cs + w.csy) + cz;
      const T k_uc = kc[ps] + Pc[ps] * (cs - (T)6);
      const T un = (k_uc * uc + tr[ps]) + (nb + yz[ps]);
      wb[slot(-ps) * PLANE] = un;
      up = un;
      have_up = true;
      // the last pass of plane q: final
      if (ps == NP - 1 && q >= w.x0 && q < w.x1 && (c ? w.own[1] : w.own[0]))
        w.out[q * w.sx + col] = un;
    }
  }

  // plane t - NP + 1 has had its last pass: the pair's other column has
  // been final since the step before
  const int qo = t - NP + 1;
  if (qo >= w.x0 && qo < w.x1 && (c ? w.own[0] : w.own[1]))
    w.out[qo * w.sx + (c ? w.coff[0] : w.coff[1])] =
        w.cell[slot(1 - NP) * PLANE + half + dh];
}

// st == ST picks the instantiation whose ring slots are constants
template <typename T, int NP, int TY, int TZ, int ST>
__device__ __forceinline__ void steady_step(WaveThread<T>& w, int t, int st) {
  if constexpr (ST < NP + 2) {
    if (st == ST) wave_step<T, NP, TY, TZ, true, ST>(w, t, st);
    else steady_step<T, NP, TY, TZ, ST + 1>(w, t, st);
  }
}

template <typename T, int NP, int TY, int TZ>
__global__ void __launch_bounds__((TY * TZ) / 2)
march_kernel(const T* __restrict__ u, const T* __restrict__ rhs,
                 const T* __restrict__ a, T* __restrict__ out,
                 const LevelParams<T> p, const int base, const int xseg) {
  using L = WaveLayout<TY, TZ>;
  constexpr int R = NP + 2;       // planes in the ring
  constexpr int HZ = L::HZ;
  extern __shared__ __align__(16) unsigned char wave_smem[];
  T* ring = reinterpret_cast<T*>(wave_smem);
  // zero the ring: the padding stays zero, and no slot ever holds anything
  // but finite values
  for (int i = threadIdx.x; i < R * L::PLANE; i += blockDim.x) ring[i] = (T)0;
  __syncthreads();

  const int kk = threadIdx.x % HZ;
  const int jj = threadIdx.x / HZ;
  const int lk = 2 * kk;
  // unwrapped global indices of the thread's row and first column
  const int uj = (int)blockIdx.y * (TY - 2 * NP) - NP + jj;
  const int uk = (int)blockIdx.x * (TZ - 2 * NP) - NP + lk;

  WaveThread<T> w;
  w.u = u; w.rhs = rhs; w.a = a; w.out = out;
  w.cell = ring + (jj + 1) * L::PZ + kk + 1;
  w.jpar = jj & 1;
  w.sx = (long long)p.ny * p.nz;
  w.nx = p.nx;
  w.x0 = (int)blockIdx.z * xseg;
  w.x1 = min(p.nx, w.x0 + xseg);
  w.wrapx = p.periodic[0] != 0;
  // a periodic x has no face: both segment ends are open, wherever they lie
  w.xs = w.wrapx ? w.x0 - NP : max(0, w.x0 - NP);
  w.xe = w.wrapx ? w.x1 + NP : min(p.nx, w.x1 + NP);
  w.par = uj + uk + base;
  w.alpha = p.alpha; w.six_b_inv = p.six_b_inv; w.b_inv = p.b_inv;
  w.c0xlo = p.c0[0][0]; w.c1xlo = p.c1[0][0];
  w.c0xhi = p.c0[0][1]; w.c1xhi = p.c1[0][1];

  const bool py = p.periodic[1] != 0, pz = p.periodic[2] != 0;
  const T one = (T)1;
  int gj = uj;
  bool live_j = uj >= 0 && uj < p.ny;
  if (py) {
    gj = uj % p.ny;
    if (gj < 0) gj += p.ny;
    live_j = true;
  }
  const bool own_j = jj >= NP && jj < TY - NP && uj < p.ny;
  const bool ylo = !py && gj == 0, yhi = !py && gj == p.ny - 1;
  w.wya = yhi ? (T)0 : (ylo ? one + p.c1[1][0] : one);
  w.wyb = ylo ? (T)0 : (yhi ? one + p.c1[1][1] : one);
  w.csy = (ylo ? p.c0[1][0] : (T)0) + (yhi ? p.c0[1][1] : (T)0);
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
    w.live[c] = live_j && live_k;
    w.own[c] = own_j && w.live[c] && lk + c >= NP && lk + c < TZ - NP &&
               ukc < p.nz;
    w.coff[c] = gj * p.nz + gk;
    const bool zlo = !pz && gk == 0, zhi = !pz && gk == p.nz - 1;
    w.wza[c] = zhi ? (T)0 : (zlo ? one + p.c1[2][0] : one);
    w.wzb[c] = zlo ? (T)0 : (zhi ? one + p.c1[2][1] : one);
    w.csz[c] = (zlo ? p.c0[2][0] : (T)0) + (zhi ? p.c0[2][1] : (T)0);
  }

  // plane xs enters the ring, plane xs + 1 is loaded, and a, rhs of the
  // first step's first cell
  int st = w.xs % R;
  if (st < 0) st += R;
  {
    T* pl = w.cell + st * L::PLANE;
    const int half0 = w.jpar ? L::HP : 0;
    const long long o = xplane(w, w.xs) * w.sx;
    const long long o1 = xplane(w, w.xs + 1) * w.sx;
    pl[half0] = w.live[0] ? u[o + w.coff[0]] : (T)0;
    pl[L::HP - half0] = w.live[1] ? u[o + w.coff[1]] : (T)0;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      w.raw_u[c] = (w.live[c] && w.xs + 1 < w.xe)
                       ? u[o1 + w.coff[c]] : (T)0;
    const int c = (w.xs + w.par) & 1;
    const bool act = c ? w.live[1] : w.live[0];
    w.next_a = act ? a[o + (c ? w.coff[1] : w.coff[0])] : (T)0;
    w.next_r = act ? rhs[o + (c ? w.coff[1] : w.coff[0])] : (T)0;
  }

  // steps xs .. xe+NP-2; those in [lo_s, hi_s) are steady: t - NP >= xs,
  // t + 2 < xe, no plane of the staircase at an x face of the domain, and
  // (periodic x) every plane t - NP .. t + 2 inside [0, nx)
  const int lo_s = max(w.xs, 0) + NP, hi_s = min(w.xe, p.nx) - 2;
  int t = w.xs;
  const int last = w.xe + NP - 1;
  for (; t < last && t < lo_s; ++t, st = st + 1 == R ? 0 : st + 1)
    wave_step<T, NP, TY, TZ, false, 0>(w, t, st);
  for (; t < hi_s; ++t, st = st + 1 == R ? 0 : st + 1)
    steady_step<T, NP, TY, TZ, 0>(w, t, st);
  for (; t < last; ++t, st = st + 1 == R ? 0 : st + 1)
    wave_step<T, NP, TY, TZ, false, 0>(w, t, st);
}

cudaError_t multiprocessors(int* count) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
}

template <typename T, int NP, int TY, int TZ>
cudaError_t launch_tile(const T* u, const T* rhs, const T* a, T* out,
                        const LevelParams<T>& p, int base,
                        cudaStream_t stream) {
  constexpr int TIY = TY - 2 * NP, TIZ = TZ - 2 * NP;
  static_assert(TIY > 0 && TIZ > 0 && TZ % 2 == 0, "tile too small");
  const int nty = (p.ny + TIY - 1) / TIY, ntz = (p.nz + TIZ - 1) / TIZ;
  const size_t smem = (size_t)(NP + 2) * WaveLayout<TY, TZ>::PLANE * sizeof(T);
  const int threads = (TY * TZ) / 2;
  auto kern = march_kernel<T, NP, TY, TZ>;
  // blocks the card runs at once (asked once per instantiation)
  static int capacity = 0;
  if (capacity == 0) {
    cudaError_t err = cudaFuncSetAttribute(
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
    capacity = sms * per_sm;
  }
  // x segments: the count that needs the fewest steps in all, a block
  // taking xseg + 3*NP steps (rind planes at both ends and the drain) and
  // the grid running in rounds of `capacity` blocks; no segment shorter
  // than 8*NP planes, so that its rind stays under 25 %
  const int most = p.nx / (8 * NP) > 1 ? p.nx / (8 * NP) : 1;
  int nseg = 1, xseg = p.nx;
  long long best = -1;
  for (int n = 1; n <= most; ++n) {
    const int len = (p.nx + n - 1) / n;
    const int segs = (p.nx + len - 1) / len;
    const long long rounds =
        ((long long)nty * ntz * segs + capacity - 1) / capacity;
    const long long cost = rounds * (len + 3 * NP);
    if (best < 0 || cost < best) { best = cost; nseg = segs; xseg = len; }
  }
  dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)nseg);
  kern<<<grid, threads, smem, stream>>>(u, rhs, a, out, p, base, xseg);
  return cudaGetLastError();
}


template <typename T>
cudaError_t launch_multisweep(const T* u, const T* rhs, const T* a, T* out,
                              const LevelParams<T>& p, int base, int nsweeps,
                              cudaStream_t stream) {
  // a periodic axis wraps inside a tile or a segment: its extent must be
  // even so that the checkerboard stays consistent across the wrap
  if ((p.periodic[0] && p.nx % 2) || (p.periodic[1] && p.ny % 2) ||
      (p.periodic[2] && p.nz % 2))
    return cudaErrorInvalidValue;
  if (nsweeps == 2)
    return launch_tile<T, 4, 40, 40>(u, rhs, a, out, p, base, stream);
  if (nsweeps == 4)
    return launch_tile<T, 8, 40, 40>(u, rhs, a, out, p, base, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point: out <- nsweeps (2 or 4) sweeps of u; u is not modified and
// out must not alias it.
extern "C" int mgk_multisweep_relax(const void* u, const void* rhs,
                                    const void* a, void* out, int is_double,
                                    int nx, int ny, int nz, const int* kinds,
                                    double rho, double alpha, double beta,
                                    double dx, int base, int nsweeps,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    auto p = make_level_params<double>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_multisweep<double>((const double*)u, (const double*)rhs,
                                          (const double*)a, (double*)out, p,
                                          base, nsweeps, st);
  }
  auto p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_multisweep<float>((const float*)u, (const float*)rhs,
                                       (const float*)a, (float*)out, p, base,
                                       nsweeps, st);
}
