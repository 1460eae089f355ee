// The march of the multisweep kernels: nsweeps red-black Gauss-Seidel sweeps
// of one level (or one shard of a level) in ONE launch, carried along x in
// shared memory with the halo recomputed, for ANY face kinds including
// periodic x. This header holds what its two bodies share (the plane
// layout, the copies and stores, which csrc/gsrb_batch_march.cu takes too);
// each unit holds its own body, both built for the H100 as the
// whole level's header comment says (a ring of u, rhs and a filled by
// asynchronous copies, the tile width and the x segments chosen in Python):
//   csrc/multisweep.cu      a whole level (mgk_multisweep_relax),
//   csrc/multisweep_halo.cu one shard of a level cut over a device mesh: an
//                           x-slab with its neighbours' rows in pads
//                           (mgk_multisweep_halo) or a prepadded (x, y)
//                           pencil (mgk_multisweep_pre).
// The two bodies are the same march and differ only where a plane outside
// [0, nx) is read and which x faces take the ghost rule. They are kept apart
// because one template serving both made the whole-level march slower on
// an NVIDIA H100 80GB HBM3 at 700 W (24-38 %, and still 4-5 % once the
// shard-only state had left its thread; PERF.md). recip() and
// march_capacity, which the towers use too, are in mg_kernels.h; the x
// segments of both bodies are cut by one rule, in Python
// (ops/fused_sweeps.march_segments).
//
// "The header's design" that csrc/multisweep.cu's notes measure the whole
// level's body against is the shard body's first one, since replaced: a
// ring of NP + 2 planes of u only, the next plane's u loaded one step ahead
// into registers, rhs and a of a cell re-read through L1/L2 at each of its
// NP/2 updates (so every step waited on memory), one fixed 40 x 40 tile,
// and the x segments cut in C.
//
// The march replaces TPU kernels that compute one function (what
// gsrb_relax computes, csrc/gsrb_relax.cu: the same folded per-cell update,
// parity (i+j+k+sum(lo)+pass) & 1, the homogeneous ghost rule re-derived
// from the current interior before every colour pass, for constant bCoef)
// and differ in how a TPU core schedules and tiles it:
//   mg_ic_code_tpu/ops/wavefront.py:wavefront_relax, :wavefront_relax_flat
//       (time-skewed in x from the x faces, x not periodic; 3-D and flat
//       layout) -- ops/wavefront.wavefront_relax calls the whole-level
//       kernel with x open,
//   mg_ic_code_tpu/ops/fused_sweeps.py:multisweep_relax_pipelined (x slabs
//       of full rows with 2*nsweeps-row halo blocks, index maps that wrap
//       for periodic x), :multisweep_relax_flat_pipelined (the same in the
//       (nx, ny*nz) layout), :multisweep_relax_tiled ((x, y) tiles with a
//       2*nsweeps halo both ways, wrap or ghost pads), :multisweep_relax and
//       its flat twin :multisweep_relax_flat without a halo
//       -- ops/fused_sweeps.multisweep_relax, any face kinds,
//   mg_ic_code_tpu/ops/fused_sweeps.py:multisweep_relax in its halo=(upad,
//       rpad, apad, meta) form, on one x-slab of a sharded level
//       -- ops/fused_sweeps.multisweep_relax(halo=...),
//   mg_ic_code_tpu/ops/fused_sweeps.py:multisweep_relax_tiled_pre (the same
//       on one prepadded (x, y) pencil) --
//       ops/fused_sweeps.multisweep_relax_tiled_pre.
// The halo recompute of the TPU kernels is what the time-skewed march does
// at every open segment end and tile side anyway, so one march serves all: a
// periodic x only makes both ends of every x segment open, and a seam
// between shards is an open end whose planes come from the pads.
//
// What both bodies share (not the TPU schedules, which hold whole (W, ny,
// nz) windows or slabs in on-chip memory and walk x on one core):
//  * A block owns a W x W tile of the y-z plane and a segment of x, and
//    marches along x. A rind of NP = 2*nsweeps cells on every tile side and
//    NP planes at each open segment end is recomputed redundantly, so blocks
//    never wait on each other: a wrong value at an open edge moves inward
//    one cell per pass and never reaches the cells the block writes. Domain
//    faces need no rind: their ghost rule comes from the cell's index.
//  * The time skew: at step t, pass p works on plane t - p, p = 0 .. NP-1.
//    A cell (t - p, j, k) of pass p then has the colour of the pass exactly
//    when (t + j + k + sum(lo)) is even: in one step the same y-z columns
//    are updated in every plane of the staircase, every in-plane neighbour
//    read lies in a column nobody writes in this step, and the x neighbours
//    lie in the thread's own column. So a thread that owns a column runs its
//    NP updates of a step one after the other, p ascending (the order
//    Gauss-Seidel needs), and the block needs ONE barrier per step.
//  * A thread owns the z-pair (2kk, 2kk+1) of one tile row: one of the two
//    columns is active in each step.
//  * A periodic x has no face to start from, so EVERY segment end is open;
//    the parity of a plane keeps the unwrapped index, which agrees across
//    the wrap only for an even nx.
//  * A first version kept lambda, 1 - lambda*alpha*a and lambda*rhs
//    of the planes in flight in per-thread shift registers across steps; it
//    gave wrong last passes in some instantiations, the cause was not
//    found, and it was dropped. (Check every instantiation, f32 and f64,
//    NP = 4 and 8, periodic x and not, whole level and both shard forms, on
//    the card after any change to a step.)
//  * The bf16 tier (smoother_precision = bfloat16, the TPU kernels'
//    compute_dtype): both bodies build every f32 form again with the
//    passes' arithmetic C = __nv_bfloat16 (tier_t), the update of
//    gsrb_relax's tier (gsrb_update_bf16, csrc/gsrb_device.cuh) in two
//    parts, fold (tier_fold) and pass, from the march's own reads:
//      - a plane is folded once, before its first pass (pass 0 of step q):
//        in step q - 1, after its barrier, which made the other threads'
//        16-byte copies of its a and rhs visible (plane xs before the first
//        step), the pair's owner folds both its columns (tier_fold) and
//        writes the terms IN PLACE, P (f32) over a and the bf16 pair (K, T)
//        over rhs, which the passes of steps q .. q + NP - 1 read. No pass
//        of step q - 1 reads plane q's slot, and it is refilled only after
//        the barrier that follows its last read, as before. A dead column
//        (outside a face, never fetched) keeps its zeros, which read as
//        P = K = T = 0. Only the x fold of a plane depends on its index,
//        known when it is folded;
//      - u is rounded to bf16 once, where it enters: after its copies land
//        (copy_wait), before the step's barrier, the owner of a column
//        rounds it in place (march_tier_round), and the passes write bf16
//        values: the ring holds bf16 values only, so a pass takes a value
//        as bf16 by its top half (bf16_of, bf162_of), no conversion.
//    The fold does not depend on u and rounding is idempotent, so this is
//    bit for bit the update folded and rounded at every pass. A joined
//    shard run is the whole-level march, and the whole-level march
//    gsrb_relax, bit for bit in the tier.
#pragma once

#include "gsrb_device.cuh"
#include "mg_kernels.h"

namespace {

// What every march unit copies and stores with (the whole level's, the
// shards' and gsrb_relax_batch's, csrc/gsrb_batch_march.cu).
// Asynchronous copy of one element, global -> shared-memory address dst
// (cp.async, sm_80+).
template <typename T>
__device__ __forceinline__ void copy_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
// Asynchronous copy of 16 bytes, global -> shared, bypassing L1.
__device__ __forceinline__ void copy_chunk(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// p[0] = x, p[1] = y in one store (p aligned to twice the element)
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(double* p, double x, double y) {
  *reinterpret_cast<double2*>(p) = make_double2(x, y);
}

// v[c] for a c known only at run time, without indexing a register array
template <typename X>
__device__ __forceinline__ X pick(int c, const X (&v)[2]) {
  return c ? v[1] : v[0];
}

// The passes' arithmetic in the bf16 tier beside storage T: bf16 for f32
// levels; T itself otherwise (the entries refuse the tier for f64 before a
// form is reached).
template <typename T>
struct TierOf {
  using type = T;
};
template <>
struct TierOf<float> {
  using type = __nv_bfloat16;
};
template <typename T>
using tier_t = typename TierOf<T>::type;

// The fold of one cell in the tier (T float, C bf16), apart from its passes:
// the fold of gsrb_update_bf16 (csrc/gsrb_device.cuh), its operations in its
// order, which the marches run once a plane (the kernels phase holds every
// march form bit for bit to bf16 gsrb_relax). From a = av, rhs = rv and
// c_sum (the c0 feed-through of the faces the cell touches, summed x, then
// y, then z over the non-periodic axes), in f32 with each operation rounded
// once: P = lambda * beta/dx^2 (kept in f32: an open axis weighs its pair by
// P * wa and P * wb, each rounded to bf16 once), K = k_uc and T = lambda *
// rhs, which the passes take rounded to bf16 once. 1/diag is the division,
// as in every kernel of the tier.
struct TierFold {
  float P, K, T;
};

__device__ __forceinline__ TierFold tier_fold(float av, float rv, float c_sum,
                                              float alpha, float six_b_inv,
                                              float b_inv) {
  const float diag = __fadd_rn(__fmul_rn(alpha, av), six_b_inv);
  const float lam = __fdiv_rn(1.0f, diag);
  const float P = __fmul_rn(lam, b_inv);
  const float k_uc =
      __fadd_rn(__fsub_rn(1.0f, __fmul_rn(lam, __fmul_rn(alpha, av))),
                __fmul_rn(P, __fsub_rn(c_sum, 6.0f)));
  return TierFold{P, k_uc, __fmul_rn(lam, rv)};
}

// The weights (PA, PB) = (P * wa, P * wb) of an open axis of fold f, each
// rounded to bf16 once (one conversion for the pair).
__device__ __forceinline__ __nv_bfloat162 tier_weights(
    float P, const AxisFold<float>& f) {
  return __floats2bfloat162_rn(__fmul_rn(P, f.wa), __fmul_rn(P, f.wb));
}

// The march's pass of one cell in its general step (tier_pass): from the
// fold's kt, the cell's value uc and per axis its weights w and neighbours
// v = (up, um), bf16 pairs, the operations of gsrb_update_bf16's pass
// (csrc/gsrb_device.cuh) in its order: acc = K * uc + T and per axis acc +
// P * (up + um) across a periodic one (w.x = P rounded), else (acc + PA *
// up) + PB * um, a neighbour across a face read as 0. An open y or z axis's
// two products are one __hmul2_rn (lane for lane the same rounding as two
// __hmul_rn); x's stay apart, since up is the pass before's result.
__device__ __forceinline__ __nv_bfloat16 tier_pass(
    __nv_bfloat162 kt, __nv_bfloat16 uc, const __nv_bfloat162 (&w)[3],
    const __nv_bfloat162 (&v)[3], const bool (&per)[3]) {
  __nv_bfloat16 acc =
      __hadd_rn(__hmul_rn(__low2bfloat16(kt), uc), __high2bfloat16(kt));
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const __nv_bfloat16 up = __low2bfloat16(v[ax]);
    const __nv_bfloat16 um = __high2bfloat16(v[ax]);
    if (per[ax]) {
      acc = __hadd_rn(acc,
                      __hmul_rn(__low2bfloat16(w[ax]), __hadd_rn(up, um)));
    } else if (ax == 0) {
      acc = __hadd_rn(acc, __hmul_rn(__low2bfloat16(w[ax]), up));
      acc = __hadd_rn(acc, __hmul_rn(__high2bfloat16(w[ax]), um));
    } else {
      const __nv_bfloat162 pr = __hmul2_rn(w[ax], v[ax]);
      acc = __hadd_rn(acc, __low2bfloat16(pr));
      acc = __hadd_rn(acc, __high2bfloat16(pr));
    }
  }
  return acc;
}

// A value of the tier's ring (a bf16 value held in f32) as bf16: its top
// half, exactly; two of them as one pair (lo, hi) by one byte permute.
__device__ __forceinline__ __nv_bfloat16 bf16_of(float x) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(__float_as_uint(x) >> 16));
}
__device__ __forceinline__ __nv_bfloat162 bf162_bits(unsigned b) {
  return *reinterpret_cast<const __nv_bfloat162*>(&b);
}
__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf162_of(float lo, float hi) {
  return bf162_bits(
      __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632));
}

// The lanes of an open axis's (up, um) pair that hold cells: up reads 0 at
// the high face, um at the low face (gsrb_update_bf16's masks, in bits).
__device__ __forceinline__ unsigned face_mask(bool lo, bool hi) {
  return (hi ? 0u : 0x0000ffffu) | (lo ? 0u : 0xffff0000u);
}

// The tier rounds the two columns of a pair in the u plane at `cell` (both
// colour halves, HP apart) to bf16 in place.
template <int HP>
__device__ __forceinline__ void march_tier_round(float* cell) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(cell[0], cell[HP]);
  cell[0] = __low2float(r);
  cell[HP] = __high2float(r);
}

// The tier's fold of one column in place: a at *av becomes P, rhs at *rv the
// pair (K, T) in its bits (tier_fold; c_sum summed as it says).
__device__ __forceinline__ void march_tier_fold(float* av, float* rv,
                                                float c_sum, float alpha,
                                                float six_b_inv,
                                                float b_inv) {
  const TierFold f = tier_fold(*av, *rv, c_sum, alpha, six_b_inv, b_inv);
  *av = f.P;
  *rv = __uint_as_float(bits_of(__floats2bfloat162_rn(f.K, f.T)));
}

// The same for a pair's two columns side by side (the 16-byte chunk layout):
// one 8-byte load and store of a and of rhs each. A column outside the
// level (live false: never fetched, its zeros read as P = K = T = 0) keeps
// its zeros.
__device__ __forceinline__ void march_tier_fold2(float* av, float* rv,
                                                 const float (&c_sum)[2],
                                                 const bool (&live)[2],
                                                 float alpha, float six_b_inv,
                                                 float b_inv) {
  const float2 a = *reinterpret_cast<const float2*>(av);
  const float2 r = *reinterpret_cast<const float2*>(rv);
  const TierFold f0 = tier_fold(a.x, r.x, c_sum[0], alpha, six_b_inv, b_inv);
  const TierFold f1 = tier_fold(a.y, r.y, c_sum[1], alpha, six_b_inv, b_inv);
  *reinterpret_cast<float2*>(av) =
      make_float2(live[0] ? f0.P : 0.0f, live[1] ? f1.P : 0.0f);
  const unsigned kt0 = bits_of(__floats2bfloat162_rn(f0.K, f0.T));
  const unsigned kt1 = bits_of(__floats2bfloat162_rn(f1.K, f1.T));
  *reinterpret_cast<float2*>(rv) =
      make_float2(live[0] ? __uint_as_float(kt0) : 0.0f,
                  live[1] ? __uint_as_float(kt1) : 0.0f);
}

// The tier's pass of one cell from what its plane's fold left in the ring (P
// and kt's bits in f32), the cell's value uc, its neighbours (up, um: x, y,
// z) as the pass read them (bf16 values), whether each axis is periodic,
// the folds of its faces (fx, fy, fz) and the lanes of the y and z pairs
// that hold cells (my, mz: face_mask). STEADY_X: no x face (x's weights are
// P's). The result is a bf16 value in f32. The general step's pass (a
// steady step whose axes are all periodic or all open runs
// march_tier_steady).
template <bool STEADY_X>
__device__ __forceinline__ float march_tier_cell(
    float P, float kt, float uc, const float (&up)[3], const float (&um)[3],
    const bool (&per)[3], const AxisFold<float>& fx,
    const AxisFold<float>& fy, unsigned my, const AxisFold<float>& fz,
    unsigned mz) {
  const __nv_bfloat162 pp = __float2bfloat162_rn(P);
  const __nv_bfloat162 w[3] = {
      STEADY_X ? pp : tier_weights(P, fx),
      per[1] ? pp : tier_weights(P, fy),
      per[2] ? pp : tier_weights(P, fz)};
  const auto pair = [](float p, float m, unsigned mask) {
    return bf162_bits(bits_of(bf162_of(p, m)) & mask);
  };
  // x: up is the pass before's result, kept apart (no permute on its path)
  const __nv_bfloat162 v[3] = {
      __halves2bfloat162(bf16_of(fx.hi ? 0.0f : up[0]),
                         bf16_of(fx.lo ? 0.0f : um[0])),
      pair(up[1], um[1], my), pair(up[2], um[2], mz)};
  return __bfloat162float(
      tier_pass(bf162_bits(__float_as_uint(kt)), bf16_of(uc), w, v, per));
}

// The tier's NP passes of one steady step (no x face, every plane valid,
// PER 1: every axis periodic, 0: none; the general step runs
// march_tier_cell), as the f32 form runs its own: first, for four passes at
// a time, what does not depend on the pass before (the fold's terms of plane
// t - ps from the a, rhs ring at cp, K * uc + T, the y and z terms from the
// in-plane neighbours at yp, ym, zp, zm, which no pass of this step writes,
// and x's um term), then the chain from up, the result of the pass before:
// the operations of march_tier_cell, in its order. rb: the active column's u
// in ring slot 0, own its values in planes t + 1 .. t - NP (bf16). Slots and
// offsets are compile-time (ST: plane t's slot of R). Returns the last
// pass's result (a bf16 value in f32).
template <int NP, int R, int ST, int PLANE, int CSLOT, int CA, int PER>
__device__ __forceinline__ float march_tier_steady(
    float* rb, const float* yp, const float* ym, const float* zp,
    const float* zm, const float* cp, const __nv_bfloat16 (&own)[NP + 2],
    const AxisFold<float>& fy, unsigned my, const AxisFold<float>& fz,
    unsigned mz) {
  constexpr auto slot = [](int ps) { return ((ST - ps) % R + R) % R; };
  constexpr int G = NP < 4 ? NP : 4;  // passes a group
  __nv_bfloat16 up = own[0];
#pragma unroll
  for (int g = 0; g < NP; g += G) {
    __nv_bfloat162 a0p[G];  // (K * uc + T, P)
    __nv_bfloat16 cx[G];    // PB * um (open x), um (periodic x)
    __nv_bfloat162 ty[G], tz[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int ps = g + i, o = slot(ps) * PLANE;
      const float P = cp[slot(ps) * CSLOT];
      const __nv_bfloat162 kt =
          bf162_bits(__float_as_uint(cp[slot(ps) * CSLOT + CA]));
      const __nv_bfloat162 pp = __float2bfloat162_rn(P);
      const __nv_bfloat16 acc0 =
          __hadd_rn(__hmul_rn(__low2bfloat16(kt), own[ps + 1]),
                    __high2bfloat16(kt));
      a0p[i] = __halves2bfloat162(acc0, __low2bfloat16(pp));
      if constexpr (PER == 1) {
        cx[i] = own[ps + 2];
        // (yp + ym, zp + zm), then P times each
        const __nv_bfloat162 s = __hadd2_rn(bf162_of(yp[o], zp[o]),
                                            bf162_of(ym[o], zm[o]));
        ty[i] = __hmul2_rn(pp, s);
      } else {
        cx[i] = __hmul_rn(__low2bfloat16(pp), own[ps + 2]);
        ty[i] = __hmul2_rn(
            tier_weights(P, fy),
            bf162_bits(bits_of(bf162_of(yp[o], ym[o])) & my));
        tz[i] = __hmul2_rn(
            tier_weights(P, fz),
            bf162_bits(bits_of(bf162_of(zp[o], zm[o])) & mz));
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const __nv_bfloat16 P = __high2bfloat16(a0p[i]);
      __nv_bfloat16 acc;
      if constexpr (PER == 1) {
        acc = __hadd_rn(__low2bfloat16(a0p[i]),
                        __hmul_rn(P, __hadd_rn(up, cx[i])));
        acc = __hadd_rn(acc, __low2bfloat16(ty[i]));
        acc = __hadd_rn(acc, __high2bfloat16(ty[i]));
      } else {
        acc = __hadd_rn(__low2bfloat16(a0p[i]), __hmul_rn(P, up));
        acc = __hadd_rn(acc, cx[i]);
        acc = __hadd_rn(acc, __low2bfloat16(ty[i]));
        acc = __hadd_rn(acc, __high2bfloat16(ty[i]));
        acc = __hadd_rn(acc, __low2bfloat16(tz[i]));
        acc = __hadd_rn(acc, __high2bfloat16(tz[i]));
      }
      rb[slot(g + i) * PLANE] = __bfloat162float(acc);
      up = acc;
    }
  }
  return __bfloat162float(up);
}

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

}  // namespace
