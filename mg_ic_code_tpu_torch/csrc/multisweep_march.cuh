// The march of the multisweep kernels: nsweeps red-black Gauss-Seidel sweeps
// of one level (or one shard of a level) in ONE launch, carried along x in
// shared memory with the halo recomputed, for ANY face kinds including
// periodic x. This header holds what its two bodies share; each unit holds
// its own body:
//   csrc/multisweep.cu      a whole level (mgk_multisweep_relax),
//   csrc/multisweep_halo.cu one shard of a level cut over a device mesh: an
//                           x-slab with its neighbours' rows in pads
//                           (mgk_multisweep_halo) or a prepadded (x, y)
//                           pencil (mgk_multisweep_pre).
// The two bodies are the same march and differ only where a plane outside
// [0, nx) is read and which x faces take the ghost rule. They are kept apart
// because one template serving both made the whole-level march slower on
// an NVIDIA H100 80GB HBM3 at 700 W (24-38 %, and still 4-5 % once the
// shard-only state had left its thread; PERF.md). The whole-level body has
// since been redesigned for the card (its own header comment says how: a
// ring of u, rhs and a filled by asynchronous copies, a tile width chosen
// per level); the design notes below are those of the shard body, which
// the whole-level one shares the time skew and the plane layout with
// (recip() and march_capacity, which the towers use too, are in
// mg_kernels.h).
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
//    periodic x and not, whole level and both shard forms, on the card after
//    any change to a step.)
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
#pragma once

#include "mg_kernels.h"

namespace {

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

// x segments of a launch over `tiles` y-z tiles: the count that needs the
// fewest steps in all, a block taking xseg + 3*NP steps (rind planes at both
// ends and the drain) and the grid running in rounds of `capacity` blocks;
// no segment shorter than 8*NP planes, so that its rind stays under 25 %.
void march_segments(int nx, long long tiles, int capacity, int NP, int* nseg,
                    int* xseg) {
  const int most = nx / (8 * NP) > 1 ? nx / (8 * NP) : 1;
  *nseg = 1;
  *xseg = nx;
  long long best = -1;
  for (int n = 1; n <= most; ++n) {
    const int len = (nx + n - 1) / n;
    const int segs = (nx + len - 1) / len;
    const long long rounds = (tiles * segs + capacity - 1) / capacity;
    const long long cost = rounds * (len + 3 * NP);
    if (best < 0 || cost < best) { best = cost; *nseg = segs; *xseg = len; }
  }
}

}  // namespace
