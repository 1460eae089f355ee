// The march of the multisweep kernels: nsweeps red-black Gauss-Seidel sweeps
// of one level (or one shard of a level) in ONE launch, carried along x in
// shared memory with the halo recomputed, for ANY face kinds including
// periodic x. This header holds what its two bodies share (the plane
// layout); each unit holds its own body, both built for the H100 as the
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
//    passes' arithmetic C = __nv_bfloat16 (tier_t), each pass the update of
//    gsrb_relax's tier (gsrb_update_bf16, csrc/gsrb_device.cuh) from the
//    march's own reads, every u value read rounded to bf16 (as_compute),
//    the ring, a and rhs f32. A joined shard run is then the whole-level
//    march, and the whole-level march gsrb_relax, bit for bit in the tier.
#pragma once

#include "gsrb_device.cuh"
#include "mg_kernels.h"

namespace {

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
