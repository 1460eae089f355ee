#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --phases env,build,kernels

Phases, each printing one JSON line; any failure exits non-zero:

  env      card name and power limit (nvidia-smi), torch / CUDA versions,
           whether h5py imports
  build    compiles csrc/*.cu with nvcc for sm_90a; seconds, registers,
           and registers and spill stores of every march instantiation
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           f32 and f64, at the level shapes each path gives it (the
           canonical 7 levels and the six patch shapes of its patches
           forest, two of them also at an odd lo; the periodic box's
           256^3, its all-periodic
           tower chain from 128^3 and its 4^3 bottom; the sharded paths'
           16^3 tower chains, 8^3 and 4^3 depths) and at awkward ones
           (odd parity offset, mixed faces, periodic axes, one wrapped x
           segment, a 20M-cell level, 512^3), with its time, the plain
           version's time and its bound; the halo kernels on one shard of
           a level cut over a mesh (the periodic box's 64x256x256 x-slabs
           and 128x128x256 pencils, the 7-level hierarchy's local slabs,
           odd offsets), each against its plain version and, every shard
           joined, against the whole-level kernel, and through mg.relax
           both per call (whole levels split and joined) and resident
           (shards kept, aCoef cut and padded with the coefficients), the
           two timed side by side at the timed cases. Times: CUDA events
           around a batch of calls back to back, over the batch. For each
           timed whole-level march case also its launch (tile width, x
           segments, steps of the longest block, rounds), the time of one
           step and the fraction of the byte bound (scripts/march_ab.py
           times the march, the towers and gsrb_relax of two trees against
           each other); the same for each timed shard case, with the form
           that ran and its registers and spill stores, also on a line of
           its own before the kernels line (shard_launch). gsrb_relax runs in every form that takes a level
           (fused_sweeps.gsrb_geometry: grid, slab), each call one launch
           that leaves its input as it was; the residual whole and
           restricted (residual_restrict, also into a strided slice of a
           parent), one launch a call, the restricted one bitwise
           restrict_full of the whole one, at every level case and at one
           case of each form of csrc/residual.cu (RESIDUAL_CASES); for each timed case also the
           form and blocks the geometry picks, the device time and the
           wrapper's host time per call, and each form's time. Each tower
           call must be one kernel launch that leaves its inputs as they
           were; for each timed tower case also its
           launch (grid blocks, the first depth of the one-block tail, its
           shared memory, grid barriers per call), one grid barrier's time
           (a probe of 64 barriers against none), the wrapper's host time
           per call, and the device's own time per call (the batch enqueued
           behind a wait, where the host time would otherwise show). The
           bf16 tier (smoother_precision = bfloat16): gsrb_relax in every
           form at every f32 level case the tier's path can send it (all
           but the march rungs' 512x96x96, 960x144x144 and 256^3) and every
           GSRB_CASES case with constant b, both towers at every
           TOWER_CASES chain, the whole-level march (wavefront_relax,
           multisweep_relax) at every WAVE_CASES and MULTI_CASES case but
           512^3 (nsweeps 2 and 4, a and rhs in 16-byte chunks and one
           element a copy) and both shard marches at every SHARD_CASES
           case, each against its plain bf16 version (BF16_TOL; tower_down
           depth by depth from the inputs the kernel gave each depth,
           tower_up as a chain), bit for bit against its twin (the plain
           version with the kernels' colour select; the towers as against
           the plain version), the whole-level march also bit for bit bf16
           gsrb_relax and every shard case's joined shards bit for bit the
           whole-level bf16 march, and against its f32 form (BF16_CONTRACT,
           WAVE_CONTRACT for the wavefront), counted under *_bf16; the
           timed ones beside the f32 form's times
  solve    the canonical binary-black-hole configuration with max_level = 3
           through load_params -> generate_hierarchy -> poisson_solve on
           the card; the launch counters show the path went through the
           five kernels small levels take (gsrb_relax, the residual whole
           and restricted, the towers), each call one launch, the
           residual's two forms as often as the preconditioner's structure
           says (RESIDUAL_CALLS, also in periodic; scale7 and records
           derive theirs from the hierarchy: residual_calls_of), and through
           no plain version;
           the same solve with the staged smoother (no kernels) must agree
  lock3    max_level = 2 against the recorded first-step norm and plateau
  scale7   max_level = 6 (7 levels, 28.5M refined cells), 3 Picard steps,
           against the recorded f64 history; the levels too big for the L2 cache
           must have gone through the wavefront kernel, and every relax and
           residual kernel called as often as the hierarchy implies, the
           same calls in each iteration of equal Krylov count (check_route,
           as in records). Then, in a separate pass that the
           timed run does not see, the phase split of one steady
           iteration (prepare / coefs / apply / precond / norm / solve /
           finish), each phase timed to completion on the card
  records  max_level = 6 held to the three recorded histories of docs/
           (RECORDS): the plain run carried to 6 entries with the f32
           preconditioner (steps 1-3 as scale7, entries 4-6 a plateau
           flat to 1 % in [1.25e-7, 1.92e-7], bracketing the recorded
           f32 plateau 1.586e-7, the f64 one 1.822e-7 and this path's
           1.3146e-7: PLATEAU7 says why) and with the f64
           one (no kernel; entries 1-2 to 1e-7 of the f64 record, 3-6 to
           1e-3, Krylov 2 each, +-1 from entry 4), its s/iteration and
           peak memory beside the f32 run's; average_down = 1 on the
           bounding box (canonical_7level_avgdown_result.json: step 1 to
           1e-5 of 0.27342222391586096, steps 2-4 to 2 %, entry 7 <= 5e-10,
           converged below 1e-10 by entry 8, Krylov within one of
           2,2,2,3,3,3,3,2) and on the patches forest
           (canonical_7level_patches_avgdown_result.json: its 13 boxes,
           step 1 to 1e-5 of 0.2701168366859994, the same limits, Krylov
           within one of 2,3,2,2,3,3,3,2), the forest once more with the
           staged smoother (step 1 to 1e-5). Each run with kernels is held
           to the route its hierarchy implies (check_route)
  forest_batching
           the records' patches configuration with forest_batching = force:
           its three same-shape pairs (depths 4-6) each swept by the
           batched kernels, one launch a pair (gsrb_relax_batch: the
           144^3 pair, which overflows the L2, by its batch march,
           gsrb_relax_batch_march; residual_restrict_batch); held to the
           patches record as records holds it, to the single and batched
           calls by shape and kernel its batch groups imply (1008 gsrb_relax,
           336 gsrb_relax_batch, 168 gsrb_relax_batch_march, 504
           residual_restrict and 252 residual_restrict_batch calls in 42
           applications, against 2016 and 1008 sequential), no plain
           version, and bit for bit to the
           records phase's sequential run where that ran (history, Krylov,
           K), with s/iteration beside it
  bf16_tier
           smoother_precision = bfloat16 end to end, each run beside the
           f32 run of the same configuration: the 4-level solve with the
           records' patches settings (average_down = 1): converged below
           the tolerance within 20 Picard iterations, every entry finite
           (no error caught), the tier's launches as the hierarchy implies,
           no f32 gsrb_relax or tower launch, no plain version; the
           records' limits (step 1 to 1e-5 and steps 2-4 to 2 % of the f32
           run's, Krylov within one, entry 7 <= 5e-10, below 1e-10 by entry
           8) reported with their readings and whether each is met;
           s/iteration and peak memory beside the f32 run's. Then scale7
           (max_level = 6, 2 Picard iterations: the wave rung) and the
           periodic box (3: the multisweep rung): the *_bf16 march and
           tower launches as often per preconditioner application as the
           f32 run's f32 ones, no f32 relax launch, no plain version, and
           the history, K and Krylov counts bit for bit those of the same
           solve with every tier wrapper replaced by its twin on the card,
           converged or not (convergence is reported, not asserted). Then
           the box on 4 x-slabs and on (2, 2) pencils of cuda:0 named four
           times in the tier, against their f32 runs (the shard marches'
           *_bf16 launches)
  periodic the periodic scalar-field box (params/periodic.txt: is_periodic
           = 1, the constant-K branch, the triple-sine field) at its full
           256^3, 3 Picard steps: K finite and negative, a contracting
           history, the 256^3 depth smoothed by the multisweep kernel and no
           plain version anywhere, agreement with the staged smoother, and
           the Hamiltonian constraint (physics/diagnostics) against the
           same box at 128^3 (a sanity check: punctures on cell corners
           spoil the order). Then the same box without punctures, where
           that constraint must fall by four from 128^3 to 256^3, and the
           same base with one refined level that touches a periodic face
           of the domain
  cli      the command-line run at max_level = 6, two Picard iterations,
           with its per-iteration plotfiles and the GRChombo checkpoint,
           and once more on the periodic box.
           With h5py: main.run in a temporary directory, files read back.
           Without h5py: the same calls main.run makes, with the writers'
           tile streaming run against no file (every device operation and
           device-to-host copy happens; tile sizes, offsets and a checksum
           per component are checked). The line says which form ran.
  sharded  the sharded solve with a mesh that names cuda:0 four times (the
           seams, exchanges and global offsets of four cards on one): the
           periodic box on 4 x-slabs and on (2, 2) pencils and the 7-level
           hierarchy on 4 x-slabs, each beside the same run without a mesh
           (Krylov counts, K, step 1, the 7-level lock; the halo kernels
           launched in every iteration, no plain version; every level the
           mesh cuts kept on its shards from placement to the result: the
           splits, joins, level windows, coefficient splits, joins and pad
           builds of each iteration exactly what one coefficient build, its
           preconditioner applications, the composite operator, the prepare
           and the finish imply, shard_coef_builds_of, shard_traffic_of,
           picard_windows_of; the bytes moved between mesh positions per
           Picard iteration beside the preconditioner-only placement's),
           one preconditioner
           application with the mesh and without (what it splits, joins,
           exchanges and moves, and its wall time), the CLI's calls on the
           periodic box with the mesh (the sharding line, K against the run
           without one), and entry.dryrun_multichip(4) on cuda:0 named four
           times
  processes
           the sharded solve over two processes on one card: this script
           started twice as workers (--worker) by torchrun, whose
           environment they read as the command line's entry does;
           torch.distributed with gloo (the tensors that cross between the
           processes are staged through host memory: a card cannot be
           shared under NCCL), two
           positions of cuda:0 per process, a mesh of four; the periodic
           box on 4 x-slabs, the 7 levels (2 Picard iterations) and the
           box's x-slabs in the bf16 tier, each held bit for bit (history,
           Krylov counts, K) to the sharded (bf16_tier) phase's run of one
           process over cuda:0 named four times, HALO
           per iteration summed over the processes to what the hierarchy
           implies (check_halo_counts), the halo kernel's calls summed
           over the processes and every other kernel's on each process
           (those run on the depths the mesh does not cut, which every
           process computes whole) to the one process's; the bytes and
           messages between the processes, s/iteration and each process's
           peak memory. First NCCL is asked for with both processes on
           cuda:0: it must raise the port's error (SharedCardError). A
           worker that fails, times out or exits non-zero fails the script
  lowdim   ops/lowdim's 3-D V-cycle solve (32^3, f64, no kernel) on the
           card against the same solve on the CPU, to 1e-12

Asked for by name only (the default run needs one card):

  cards    the sharded solve over every visible card (at least two), with
           the mesh main.run builds by itself on such a host, beside one
           card named as often and the run without a mesh: the periodic box
           and the 7-level hierarchy, held as in the sharded phase, with
           each card's peak memory (every card past cuda:0 must hold at
           least a fifth of the unsharded run's peak), then the CLI's calls
           with no mesh given (the sharding line).
           python3 chip_smoke.py --phases env,build,cards
  processes_cards
           the processes phase's runs over one process per visible card (at
           least two; NCCL; each worker's mesh the one the command line
           builds, main.choose_mesh's), held bit for bit to one process
           driving the same cards (main.choose_mesh's mesh of one process
           that sees them all), with s/iteration beside that run's and the
           unsharded run's and each process's peak memory on its card.
           python3 chip_smoke.py --phases env,build,processes_cards

Then one line {"kernels": [...]} (per kernel: launches on its main path =
wrapper calls that reached the card in the scale7 run, in the periodic
run for the multisweep kernel, in the sharded periodic runs for the halo
kernels (x-slabs / pencils; the `processes` path: the periodic x-slabs over
two processes, launches summed over them), in the bf16_tier phase's runs
for the tier's kernels (the 4-level solve for gsrb_relax_bf16 and the
towers', scale7, the box, its x-slabs and pencils for the marches'; the
`bf16_processes` path: the box's x-slabs in the tier over two processes),
device_launches = the kernel
launches those
calls enqueued, error against the plain version, time, plain time and bound
at that path's shape; the same for the 4-level solve; and under "paths" the
same numbers for EVERY path the kernel is on, each at that path's own
shape, and for the patches path its wrapper calls by level shape), the
nvidia-smi line, and the final {"ok": true, "device": {...}}
line.

The recorded values are the Picard histories of the same configuration in
double precision on a CPU (7 levels: 0.27342222391586096 ->
1.0170868859107062e-4 -> 2.888833383836128e-7; 3 levels, first step:
0.2643130351285558), and for the records phase the files of docs/ it
names.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import mg_ic_code_tpu_torch as mgt  # noqa: E402
from mg_ic_code_tpu_torch.grid.boxes import Box  # noqa: E402
from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy  # noqa: E402
from mg_ic_code_tpu_torch.ops import coarse_tower as ct  # noqa: E402
from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts  # noqa: E402
from mg_ic_code_tpu_torch.ops import cf_interp as cfi  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs  # noqa: E402
from mg_ic_code_tpu_torch.ops import stencils as st  # noqa: E402
from mg_ic_code_tpu_torch.ops import wavefront as wf  # noqa: E402
from mg_ic_code_tpu_torch import main as cli_main  # noqa: E402
from mg_ic_code_tpu_torch.io import chombo_hdf5 as chio  # noqa: E402
from mg_ic_code_tpu_torch.io.logging import set_verbosity  # noqa: E402
from mg_ic_code_tpu_torch.parallel import distributed as dist  # noqa: E402
from mg_ic_code_tpu_torch.parallel import halo  # noqa: E402
from mg_ic_code_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mg_ic_code_tpu_torch.parallel import shards  # noqa: E402
from mg_ic_code_tpu_torch.physics import diagnostics as dg  # noqa: E402
from mg_ic_code_tpu_torch.physics import level_data as ld  # noqa: E402
from mg_ic_code_tpu_torch.solver import composite as comp  # noqa: E402
from mg_ic_code_tpu_torch.solver import multigrid as mg  # noqa: E402
from mg_ic_code_tpu_torch.solver import nonlinear as nl  # noqa: E402
from mg_ic_code_tpu_torch.solver import reductions as red  # noqa: E402
from mg_ic_code_tpu_torch.solver.nonlinear import poisson_solve  # noqa: E402
from mg_ic_code_tpu_torch.utils import profiling  # noqa: E402

CANONICAL = os.path.join(os.path.dirname(mgt.__file__), "params",
                         "canonical.txt")
PERIODIC = os.path.join(os.path.dirname(mgt.__file__), "params",
                        "periodic.txt")

# recorded double-precision histories of the canonical configuration
LOCK3_FIRST = 0.2643130351285558
SCALE7 = (0.27342222391586096, 1.0170868859107062e-4)
SCALE7_SHAPES = [(64, 64, 64), (96, 80, 80), (128, 80, 80), (176, 64, 64),
                 (272, 80, 80), (512, 96, 96), (960, 144, 144)]

# NVIDIA H100 SXM data sheet: device memory rate and f32 rate outside the
# tensor cores (the bound of a kernel is the larger of bytes / HBM_BYTES_S
# and operations / F32_FLOPS)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
D, N, P, C = "dirichlet", "neumann", "periodic", "cf"
ALL_D = ((D, D), (D, D), (D, D))
ALL_C = ((C, C), (C, C), (C, C))
ALL_P = ((P, P), (P, P), (P, P))

SOURCES = {
    "gsrb_relax": ("mg_ic_code_tpu_torch/csrc/gsrb_relax.cu",
                   "mg_ic_code_tpu/ops/fused_sweeps.py:1032"),
    "residual": ("mg_ic_code_tpu_torch/csrc/residual.cu",
                 "mg_ic_code_tpu/ops/fused_sweeps.py:1055"),
    # the same march with the restriction that follows the residual in the
    # V-cycles (JAX: restrict_full of these kernels' output, fused by XLA)
    "residual_restrict": ("mg_ic_code_tpu_torch/csrc/residual.cu",
                          "mg_ic_code_tpu/ops/fused_sweeps.py:1055"),
    "tower_down": ("mg_ic_code_tpu_torch/csrc/tower.cu",
                   "mg_ic_code_tpu/ops/coarse_tower.py:206"),
    "tower_up": ("mg_ic_code_tpu_torch/csrc/tower.cu",
                 "mg_ic_code_tpu/ops/coarse_tower.py:234"),
    # one kernel behind two wrappers (x open / any face kinds)
    "wavefront_relax": ("mg_ic_code_tpu_torch/csrc/multisweep.cu",
                        "mg_ic_code_tpu/ops/wavefront.py:329"),
    "multisweep_relax": ("mg_ic_code_tpu_torch/csrc/multisweep.cu",
                         "mg_ic_code_tpu/ops/fused_sweeps.py:486"),
    # the same march on one shard of a sharded level (x-slab + pads,
    # prepadded pencil)
    "multisweep_relax_halo": ("mg_ic_code_tpu_torch/csrc/multisweep_halo.cu",
                              "mg_ic_code_tpu/ops/fused_sweeps.py:378"),
    "multisweep_relax_tiled_pre": (
        "mg_ic_code_tpu_torch/csrc/multisweep_halo.cu",
        "mg_ic_code_tpu/ops/fused_sweeps.py:1540"),
    # the batched forms of gsrb_relax and residual_restrict (a batch group's
    # same-shape patches in one launch): the JAX package sweeps a group as
    # one vmapped XLA body (solver/composite.py:340-399), no Pallas kernel,
    # so they serve the rows of the single forms
    "gsrb_relax_batch": ("mg_ic_code_tpu_torch/csrc/gsrb_relax.cu",
                         "mg_ic_code_tpu/ops/fused_sweeps.py:1032"),
    # gsrb_relax_batch's march form, where a group overflows the L2
    "gsrb_relax_batch_march": (
        "mg_ic_code_tpu_torch/csrc/gsrb_batch_march.cu",
        "mg_ic_code_tpu/ops/fused_sweeps.py:1032"),
    "residual_restrict_batch": ("mg_ic_code_tpu_torch/csrc/residual.cu",
                                "mg_ic_code_tpu/ops/fused_sweeps.py:1055"),
    # the bf16 tier of gsrb_relax and the towers (smoother_precision =
    # bfloat16: the TPU kernels' compute_dtype)
    "gsrb_relax_bf16": ("mg_ic_code_tpu_torch/csrc/gsrb_relax.cu",
                        "mg_ic_code_tpu/ops/fused_sweeps.py:1032"),
    "tower_down_bf16": ("mg_ic_code_tpu_torch/csrc/tower.cu",
                        "mg_ic_code_tpu/ops/coarse_tower.py:206"),
    "tower_up_bf16": ("mg_ic_code_tpu_torch/csrc/tower.cu",
                      "mg_ic_code_tpu/ops/coarse_tower.py:234"),
    # the bf16 tier of the marches, whole-level and both shard forms
    "wavefront_relax_bf16": ("mg_ic_code_tpu_torch/csrc/multisweep.cu",
                             "mg_ic_code_tpu/ops/wavefront.py:329"),
    "multisweep_relax_bf16": ("mg_ic_code_tpu_torch/csrc/multisweep.cu",
                              "mg_ic_code_tpu/ops/fused_sweeps.py:486"),
    "multisweep_relax_halo_bf16": (
        "mg_ic_code_tpu_torch/csrc/multisweep_halo.cu",
        "mg_ic_code_tpu/ops/fused_sweeps.py:378"),
    "multisweep_relax_tiled_pre_bf16": (
        "mg_ic_code_tpu_torch/csrc/multisweep_halo.cu",
        "mg_ic_code_tpu/ops/fused_sweeps.py:1540"),
    # the one-sweep and one-pass entry points (no rung of the solver calls
    # them: the sweep_entry_points run drives them as a caller would)
    "gsrb_full_sweep": ("mg_ic_code_tpu_torch/csrc/gsrb_sweep.cu",
                        "mg_ic_code_tpu/ops/pallas_kernels.py:266"),
    "gsrb_half_sweep": ("mg_ic_code_tpu_torch/csrc/gsrb_sweep.cu",
                        "mg_ic_code_tpu/ops/pallas_kernels.py:368"),
}
# the forms of a kernel with more than one C entry point: form -> (source,
# entry point)
ENTRY_POINTS = {
    "gsrb_relax_batch": {
        form: ("mg_ic_code_tpu_torch/csrc/gsrb_relax.cu",
               "mgk_gsrb_relax_batch") for form in ("grid", "slab", "serial")},
    "gsrb_full_sweep": {
        "march": ("mg_ic_code_tpu_torch/csrc/gsrb_sweep.cu",
                  "mgk_gsrb_sweep"),
        "grid": ("mg_ic_code_tpu_torch/csrc/gsrb_relax.cu",
                 "mgk_gsrb_relax")},
    "gsrb_half_sweep": {
        "stream": ("mg_ic_code_tpu_torch/csrc/gsrb_sweep.cu",
                   "mgk_gsrb_sweep")},
}
# rows of the TPU kernel table (PERF.md) that one Hopper kernel serves
TPU_KERNELS = {
    "gsrb_relax": ["mg_ic_code_tpu/ops/fused_sweeps.py:1032"],
    "residual": ["mg_ic_code_tpu/ops/fused_sweeps.py:1055",
                 "mg_ic_code_tpu/ops/pallas_kernels.py:389"],
    "residual_restrict": ["mg_ic_code_tpu/ops/fused_sweeps.py:1055",
                          "mg_ic_code_tpu/ops/pallas_kernels.py:389"],
    "tower_down": ["mg_ic_code_tpu/ops/coarse_tower.py:206"],
    "tower_up": ["mg_ic_code_tpu/ops/coarse_tower.py:234"],
    "wavefront_relax": ["mg_ic_code_tpu/ops/wavefront.py:329",
                        "mg_ic_code_tpu/ops/wavefront.py:385"],
    # :378 and :714 called without a halo (the single-device slab and flat
    # rungs) compute what the whole-level kernel computes
    "multisweep_relax": ["mg_ic_code_tpu/ops/fused_sweeps.py:486",
                         "mg_ic_code_tpu/ops/fused_sweeps.py:816",
                         "mg_ic_code_tpu/ops/fused_sweeps.py:1384",
                         "mg_ic_code_tpu/ops/fused_sweeps.py:378",
                         "mg_ic_code_tpu/ops/fused_sweeps.py:714"],
    # :378's halo= form, and :1397 (the halo= form of the tiled kernel,
    # which the JAX package runs on 512^3-class slabs)
    "multisweep_relax_halo": ["mg_ic_code_tpu/ops/fused_sweeps.py:378",
                              "mg_ic_code_tpu/ops/fused_sweeps.py:1397"],
    "multisweep_relax_tiled_pre": ["mg_ic_code_tpu/ops/fused_sweeps.py:1540"],
    "gsrb_relax_batch": ["mg_ic_code_tpu/ops/fused_sweeps.py:1032"],
    "gsrb_relax_batch_march": ["mg_ic_code_tpu/ops/fused_sweeps.py:1032"],
    "residual_restrict_batch": ["mg_ic_code_tpu/ops/fused_sweeps.py:1055",
                                "mg_ic_code_tpu/ops/pallas_kernels.py:389"],
    "gsrb_relax_bf16": ["mg_ic_code_tpu/ops/fused_sweeps.py:1032"],
    "tower_down_bf16": ["mg_ic_code_tpu/ops/coarse_tower.py:206"],
    "tower_up_bf16": ["mg_ic_code_tpu/ops/coarse_tower.py:234"],
    "gsrb_full_sweep": ["mg_ic_code_tpu/ops/pallas_kernels.py:266"],
    "gsrb_half_sweep": ["mg_ic_code_tpu/ops/pallas_kernels.py:368"],
}
# the tier of a march serves the rows of its f32 form
for _name in ("wavefront_relax", "multisweep_relax", "multisweep_relax_halo",
              "multisweep_relax_tiled_pre"):
    TPU_KERNELS[_name + "_bf16"] = TPU_KERNELS[_name]


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 12, warmup: int = 3) -> float:
    """Median over `reps` of one call's device time: CUDA events around a
    batch of calls back to back (as many as fill ~2 ms, at most 20), over
    the batch, so that the host's time between calls hides behind the
    device's. (scripts/march_ab.py puts this function into every tree it
    times.)"""
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    batch = max(1, min(20, int(2.0 / max(t0.elapsed_time(t1), 1e-3))))
    times = []
    for _ in range(reps):
        t0.record()
        for _ in range(batch):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / batch)
    times.sort()
    return times[len(times) // 2]


def wall_ms(fn, reps: int = 9, warmup: int = 2) -> float:
    """Median over `reps` of one call's wall time with every visible card
    synchronised before and after it: for work that leaves its results on
    several cards, which one card's CUDA events do not wait for."""
    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 12, batch: int = 20) -> float:
    """time_ms's measure with the device held busy (torch.cuda._sleep) while
    the host enqueues the batch, so that the time per call is the device's
    own even where the wrapper's host time is longer."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)  # ~5 ms: longer than the enqueueing
        t0.record()
        for _ in range(batch):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / batch)
    times.sort()
    return times[len(times) // 2]


def host_us(fn, batch: int = 8, reps: int = 9) -> float:
    """Median over `reps` of the host's time per call, in microseconds,
    across `batch` calls back to back from an idle device: too few launches
    to fill the launch queue, so the host never waits on the device and
    what is timed is the wrapper's own work (checks, allocation, ctypes,
    the launch)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        times.append((time.perf_counter() - t0) / batch * 1e6)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def host_us_pair(fn_a, fn_b, rounds: int = 7) -> tuple[float, float]:
    """host_us of two wrappers taken in turns (a, b, a, b, ...), the median
    of each over `rounds`: the host's speed drifts during a run, so two
    wrappers are compared only side by side."""
    a, b = [], []
    for _ in range(rounds):
        a.append(host_us(fn_a, reps=3))
        b.append(host_us(fn_b, reps=3))
    a.sort()
    b.sort()
    return a[rounds // 2], b[rounds // 2]


# ------------------------------------------------------------------- env


def phase_env() -> dict:
    card = card_line()
    try:
        import h5py  # noqa: F401

        h5 = True
    except ImportError:
        h5 = False
    from mg_ic_code_tpu_torch.grid import br_native

    out = {
        "phase": "env", "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "h5py": h5, "native_clustering": br_native.native_available(),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
    }
    check(not out["tf32_matmul"] and not out["tf32_cudnn"], "TF32 is on")
    emit(out)
    return out


# ----------------------------------------------------------------- build


def ptxas_resources() -> tuple[dict, dict]:
    """(registers, spill store bytes) of every entry function of the built
    library, by mangled name, from ptxas -v's lines in the build log."""
    regs, spills = {}, {}
    path = cuda_ext.BUILD_INFO.get("log")
    if path and os.path.exists(path):
        log = open(path).read()
        # ptxas -v: "Compiling entry function '<mangled>' ..." then
        # "Used N registers"
        for name, used in re.findall(
            r"Compiling entry function '([^']+)'.*?Used (\d+) registers",
            log, flags=re.S,
        ):
            regs[name] = max(int(used), regs.get(name, 0))
        spills = {name: int(st) for name, st in re.findall(
            r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores", log)}
    return regs, spills


# shard_march_kernel<T, NP, W, D, V, SRC, C> of csrc/multisweep_halo.cu,
# mangled
SHARD_KERNEL = re.compile(
    r"shard_march_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)ELb([01])ELi([12])E"
    r"(f|d|13__nv_bfloat16)E")


def shard_forms(regs: dict, spills: dict) -> dict:
    """Registers and spill stores of every shard march instantiation, by
    form: "<f32|f64> NP<n> W<w> V<0|1> <slab|pre>" (V: a and rhs in 16-byte
    chunks), " bf16" after it for the bf16 tier's, with its D (planes
    fetched ahead)."""
    out = {}
    for name, n in regs.items():
        m = SHARD_KERNEL.search(name)
        if m:
            t, np_, w, d, v, src, c = m.groups()
            key = (f"{'f32' if t == 'f' else 'f64'} NP{np_} W{w} V{v} "
                   f"{'slab' if src == '1' else 'pre'}"
                   f"{' bf16' if c.endswith('bfloat16') else ''}")
            out[key] = {"D": int(d), "registers": n,
                        "spill_stores": spills.get(name, 0)}
    return out


# march_kernel<T, NP, W, D, V, C> of csrc/multisweep.cu, mangled
MARCH_KERNEL = re.compile(
    r"march_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)ELb([01])E"
    r"(f|d|13__nv_bfloat16)E")


def tier_forms(regs: dict, spills: dict) -> dict:
    """Registers and spill stores of every bf16 tier instantiation of both
    march units, by form: "<whole|slab|pre> NP<n> W<w> V<0|1>" (V: a and
    rhs in 16-byte chunks), with its D."""
    out = {}
    for name, n in regs.items():
        m = SHARD_KERNEL.search(name)
        if m:
            t, np_, w, d, v, src, c = m.groups()
            where = "slab" if src == "1" else "pre"
        elif (m := MARCH_KERNEL.search(name)) and "shard_" not in name:
            t, np_, w, d, v, c = m.groups()
            where = "whole"
        else:
            continue
        if c.endswith("bfloat16"):
            out[f"{where} NP{np_} W{w} V{v}"] = {
                "D": int(d), "registers": n,
                "spill_stores": spills.get(name, 0)}
    return out


# batch_march_kernel<V> of csrc/gsrb_batch_march.cu, mangled
BATCH_MARCH_KERNEL = re.compile(r"batch_march_kernelILb([01])E")


def batch_march_forms(regs: dict, spills: dict) -> dict:
    """Registers and spill stores of both batch march instantiations
    (gsrb_relax_batch's march form, tile width fs.BATCH_MARCH_TILE), by
    form "W<w> V<0|1>" (V: a and rhs in 16-byte chunks)."""
    out = {}
    for name, n in regs.items():
        m = BATCH_MARCH_KERNEL.search(name)
        if m:
            out[f"W{fs.BATCH_MARCH_TILE} V{m.group(1)}"] = {
                "registers": n, "spill_stores": spills.get(name, 0)}
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    cuda_ext.lib()
    info = dict(cuda_ext.BUILD_INFO)
    regs, spills = ptxas_resources()
    # every march instantiation: the whole-level forms of csrc/multisweep.cu
    # (march_kernel<T, NP, W, D, V>) and the shard forms of
    # csrc/multisweep_halo.cu, by mangled name
    march = {name: {"registers": n, "spill_stores": spills.get(name)}
             for name, n in regs.items() if "march_kernel" in name}
    # the one-launch towers of csrc/tower.cu (down, up, f32 and f64)
    tower = {name: {"registers": n, "spill_stores": spills.get(name)}
             for name, n in regs.items() if "tower_" in name}
    # every instantiation of the residual march (csrc/residual.cu)
    residual = {name: {"registers": n, "spill_stores": spills.get(name)}
                for name, n in regs.items() if "residual_kernel" in name}
    tier = tier_forms(regs, spills)
    seconds = round(time.perf_counter() - t0, 3)
    out = {
        "phase": "build", "seconds": seconds,
        # the build from the sources alone (null when the library was found
        # built: its log is the one that build wrote)
        "cold_build_s": None if info["cached"] else seconds,
        "cached": info["cached"], "library": os.path.relpath(
            info["library"], ROOT),
        "flags": list(cuda_ext.NVCC_FLAGS),
        "max_registers": max(regs.values()) if regs else None,
        "entry_functions": len(regs),
        # bytes of register spill stores per kernel that spills (mangled
        # names); the f32 NP = 4 marches the solver runs spill none
        "spill_stores": {k: v for k, v in spills.items() if v},
        "march_forms": march,
        # the shard forms of csrc/multisweep_halo.cu by form
        "shard_forms": shard_forms(regs, spills),
        # the bf16 tier's forms of both march units, and their spill stores
        # in all
        "tier_forms": tier,
        "tier_spill_stores": sum(f["spill_stores"] for f in tier.values()),
        # gsrb_relax_batch's march form (csrc/gsrb_batch_march.cu)
        "batch_march_forms": batch_march_forms(regs, spills),
        "tower_kernels": tower,
        "residual_kernels": residual,
    }
    emit(out)
    return out


# --------------------------------------------------------------- kernels


def level_fields(shape, dtype, seed: int, with_b: bool = False):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mk = lambda: torch.randn(shape, dtype=dtype, device="cuda", generator=g)
    f = {"u": mk(), "rhs": mk(),
         "a": 0.5 + 1.5 * torch.rand(shape, dtype=dtype, device="cuda",
                                     generator=g)}
    f["b"] = (0.5 + 1.5 * torch.rand(shape, dtype=dtype, device="cuda",
                                     generator=g)) if with_b else None
    return f


def rel_err(out, ref):
    """(max abs error, that error over max|ref|)."""
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def chain_spec(shape, lo, kinds, dx0: float, nsmooth: int = 4):
    """A LevelMGSpec whose depth chain coarsens `shape` while it stays
    2-coarsenable with every side >= 4 (what make_level_spec builds from a
    hierarchy)."""
    boxes = [Box.from_shape(tuple(shape), tuple(lo))]
    while boxes[-1].coarsenable(2) and min(
            boxes[-1].coarsen(2).shape) >= 4:
        boxes.append(boxes[-1].coarsen(2))
    n = len(boxes)
    return mg.LevelMGSpec(
        kinds=kinds, boxes=tuple(boxes),
        dx=tuple(dx0 * 2**d for d in range(n)),
        rho=tuple(2.0 ** (1 - d) for d in range(n)),
        alpha=1.0, beta=-1.0, nsmooth=nsmooth, smoother="pallas",
    )


def level_bytes(ncells: int, itemsize: int, arrays: int) -> float:
    return float(arrays * ncells * itemsize)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# level cases: (id, shape, kinds, lo, rho, with_b, timed)
LEVEL_CASES = [
    ("path_l0_64", (64, 64, 64), ALL_D, (0, 0, 0), 2.0, False, True),
    ("path_l1_96x80x80", (96, 80, 80), ALL_C, (48, 40, 40), 2.0, False, True),
    ("path_l2_128x80x80", (128, 80, 80), ALL_C, (160, 120, 120), 2.0, False,
     True),
    ("path_l3_176x64x64", (176, 64, 64), ALL_C, (416, 288, 288), 2.0, False,
     True),
    ("odd_lo_96x80x80", (96, 80, 80), ALL_C, (49, 40, 40), 2.0, False,
     False),
    ("mixed_faces", (40, 56, 48), ((D, C), (N, D), (C, N)), (3, 0, 8), 2.0,
     True, False),
    ("periodic_axis", (32, 48, 40), ((P, P), (D, C), (C, N)), (0, 7, 0), 0.5,
     False, False),
    ("path_l4_272x80x80", (272, 80, 80), ALL_C, (0, 0, 0), 2.0, False,
     True),
    ("path_l5_512x96x96", (512, 96, 96), ALL_C, (0, 0, 0), 2.0, False, True),
    ("big_960x144x144", (960, 144, 144), ALL_C, (0, 0, 0), 2.0, False, True),
    # the periodic box: its 256^3 top depth (residual between the two
    # V-cycles of a preconditioner application) and its 4^3 bottom depth
    ("periodic_path_256", (256, 256, 256), ALL_P, (0, 0, 0), 2.0, False,
     True),
    ("periodic_path_bottom_4", (4, 4, 4), ALL_P, (0, 0, 0), 2.0 ** -5, False,
     True),
    # the sharded paths: the periodic box on (2, 2) pencils smooths its
    # unsharded 8^3 depth with gsrb_relax (16^3 is the last depth cut); the
    # 7-level hierarchy's 4^3 bottom (its base chain's tower starts at 16^3)
    ("sharded_pencil_8_P", (8, 8, 8), ALL_P, (0, 0, 0), 2.0, False, True),
    ("path_bottom_4", (4, 4, 4), ALL_D, (0, 0, 0), 2.0, False, True),
    # the six patch shapes of the canonical patches hierarchy (records
    # phase), each at the lo of its first patch there: depth 4 72x80x80 and
    # 48^3, depth 5 104x96x96 and 64^3, depth 6 144^3 and 112^3. Every lo
    # there is a multiple of 8 (block_factor), so two of the shapes also
    # run at an odd one
    ("patch_d4_72x80x80", (72, 80, 80), ALL_C, (376, 472, 472), 2.0, False,
     True),
    ("patch_d4_48", (48, 48, 48), ALL_C, (488, 488, 488), 2.0, False, True),
    ("patch_d5_104x96x96", (104, 96, 96), ALL_C, (768, 976, 976), 2.0,
     False, True),
    ("patch_d5_64", (64, 64, 64), ALL_C, (992, 992, 992), 2.0, False, True),
    ("patch_d6_144", (144, 144, 144), ALL_C, (1568, 1976, 1976), 2.0, False,
     True),
    ("patch_d6_112", (112, 112, 112), ALL_C, (1992, 1992, 1992), 2.0, False,
     True),
    ("patch_72x80x80_odd_lo", (72, 80, 80), ALL_C, (377, 472, 472), 2.0,
     False, False),
    ("patch_144_odd_lo", (144, 144, 144), ALL_C, (1568, 1977, 1976), 2.0,
     False, False),
    # periodic axes of odd extent, where cells 0 and n - 1 are neighbours of
    # one colour: the 240^3 box's 15^3 bottom (gsrb_relax in its BiCGStab's
    # preconditioner; when sharded, its uncut depths) beside its even
    # neighbour 16^3, the odd bottoms of 144^3, 160^3 and 100^3 boxes, an
    # odd periodic y, and an odd periodic x over a grid form of many blocks
    ("odd_periodic_15_P", (15, 15, 15), ALL_P, (0, 0, 0), 2.0 ** -3, False,
     True),
    ("even_periodic_16_P", (16, 16, 16), ALL_P, (0, 0, 0), 2.0 ** -3, False,
     True),
    ("odd_periodic_9_P", (9, 9, 9), ALL_P, (0, 0, 0), 2.0, False, False),
    ("odd_periodic_5_P", (5, 5, 5), ALL_P, (0, 0, 0), 2.0, False, False),
    ("odd_periodic_25_P", (25, 25, 25), ALL_P, (0, 0, 0), 2.0, False, False),
    ("odd_periodic_y_20x17x24", (20, 17, 24), ((D, C), (P, P), (C, N)),
     (0, 1, 0), 2.0, False, False),
    ("odd_periodic_x_45x64x64", (45, 64, 64), ((P, P), (D, C), (C, N)),
     (1, 0, 0), 2.0, False, True),
    # the 240^3 box's own levels: its top depth (the residual's two forms
    # between its V-cycles; gsrb_relax held there too) and 30^3, which its
    # 4 x-slabs smooth with gsrb_relax and restrict to the 15^3 bottom
    ("odd_path_240_P", (240, 240, 240), ALL_P, (0, 0, 0), 2.0, False, True),
    ("odd_path_30_P", (30, 30, 30), ALL_P, (0, 0, 0), 2.0 ** -2, False,
     True),
]

# wavefront cases: (id, shape, kinds, lo, rho, timed). The first four are
# the big levels of the 7-level hierarchy (the two largest take the rung)
# and the 256^3 bench level; the rest are awkward on purpose.
WAVE_CASES = [
    ("path_l4_272x80x80", (272, 80, 80), ALL_C, (1520, 960, 960), 2.0, True),
    ("path_l5_512x96x96", (512, 96, 96), ALL_C, (3040, 1952, 1952), 2.0,
     True),
    ("path_l6_960x144x144", (960, 144, 144), ALL_C, (6080, 3952, 3952), 2.0,
     True),
    ("bench_256", (256, 256, 256), ALL_D, (0, 0, 0), 2.0, True),
    ("odd_lo_100x72x56", (100, 72, 56), ALL_C, (49, 40, 40), 2.0, False),
    ("narrower_than_a_tile", (37, 18, 10), ((D, C), (C, D), (N, C)),
     (0, 3, 0), 2.0, False),
    ("mixed_faces", (40, 56, 48), ((D, C), (N, D), (C, N)), (3, 0, 8), 2.0,
     False),
    ("periodic_y", (48, 40, 72), ((C, D), (P, P), (C, N)), (0, 7, 0), 0.5,
     False),
    ("periodic_z", (33, 50, 36), ((N, C), (D, C), (P, P)), (1, 1, 1), 2.0,
     False),
    ("periodic_yz_small", (24, 12, 8), ((D, D), (P, P), (P, P)), (0, 0, 0),
     2.0, False),
    # the march's wider tile (44, 36 written: fused_sweeps.march_tile) at 2
    # sweeps, with an odd parity offset and mixed faces; and 144, the
    # finest level's width, ragged for the 4-sweep and f64 tiles
    ("tile44_odd_lo", (40, 72, 36), ((D, C), (N, D), (C, N)), (3, 1, 8), 2.0,
     False),
    ("ragged_144", (20, 144, 144), ALL_C, (1, 0, 0), 2.0, False),
    # the largest patch of the canonical patches hierarchy: relax_kernel_plan
    # keeps it on gsrb_relax (its four f32 arrays fit the L2), so the march
    # is held and timed here beside gsrb_relax at the same shape
    ("patch_d6_144", (144, 144, 144), ALL_C, (1568, 1976, 1976), 2.0, True),
    ("patch_144_odd_lo", (144, 144, 144), ALL_C, (1569, 1976, 1976), 2.0,
     False),
]

# multisweep cases: (id, shape, kinds, lo, rho, timed). The first is
# the periodic box's level; 512^3 is the class of the JAX package's tiled
# kernel (2.1 GB for the four f32 arrays). The kernel cuts x into segments
# from nx = 16 * (2 * nsweeps) on: the two_segments / one_segment pairs sit
# just above and below that for both chunks, and the tiny ones wrap one
# segment onto its own planes several times.
MULTI_CASES = [
    ("periodic_256", (256, 256, 256), ALL_P, (0, 0, 0), 2.0, True),
    ("periodic_512x96x96", (512, 96, 96), ALL_P, (0, 0, 0), 2.0, True),
    ("periodic_x_only", (128, 72, 56), ((P, P), (D, N), (N, D)), (0, 0, 0),
     2.0, False),
    ("odd_lo_100x72x56", (100, 72, 56), ((P, P), (C, D), (N, C)),
     (49, 40, 40), 2.0, False),
    ("narrower_than_a_tile", (38, 18, 10), ((P, P), (C, D), (N, C)),
     (0, 3, 0), 2.0, False),
    ("two_segments_np4", (66, 40, 24), ALL_P, (1, 0, 0), 2.0, False),
    ("one_segment_np4", (62, 40, 24), ALL_P, (0, 0, 0), 2.0, False),
    ("two_segments_np8", (130, 24, 40), ((P, P), (D, D), (P, P)), (0, 0, 0),
     2.0, False),
    ("one_segment_np8", (126, 24, 40), ((P, P), (D, D), (P, P)), (0, 1, 0),
     2.0, False),
    ("tiny_nx6", (6, 44, 36), ALL_P, (0, 0, 0), 2.0, False),
    ("tiny_nx2", (2, 12, 8), ((P, P), (N, D), (P, P)), (1, 0, 0), 2.0, False),
    # the JAX package's flat rung (row 12): a lane-misaligned level it names,
    # x open; here the same whole-level kernel
    ("flat_472x64x64", (472, 64, 64), ALL_C, (0, 0, 0), 2.0, True),
    ("open_x_mixed_faces", (40, 56, 48), ((D, C), (N, D), (C, N)), (3, 0, 8),
     2.0, False),
    ("open_x_periodic_yz", (96, 40, 72), ((C, D), (P, P), (P, P)), (0, 7, 0),
     0.5, False),
    ("periodic_512", (512, 512, 512), ALL_P, (0, 0, 0), 2.0, True),
    # the wider tile with periodic y and z, wrapping one segment onto its
    # own planes, and cut into two x segments
    ("tile44_periodic_yz", (32, 72, 108), ALL_P, (0, 1, 0), 2.0, False),
    ("tile44_tiny_nx6", (6, 36, 72), ALL_P, (1, 0, 0), 2.0, False),
    ("tile44_two_segments", (66, 36, 36), ((P, P), (D, N), (C, D)),
     (0, 0, 1), 2.0, False),
    # the top depth of the box at N = 240 (phase periodic_odd)
    ("odd_path_240_P", (240, 240, 240), ALL_P, (0, 0, 0), 2.0, True),
]
# run in f32 only (the four f64 arrays and the plain version's temporaries
# of a 512^3 level would take a quarter of the card)
F32_ONLY_CASES = ("periodic_512",)

# tower cases: (id, shape, kinds, lo, timed); the first is the canonical
# path's, the second the periodic box's (six depths, 128^3 down to 4^3, every
# axis wrapped at every depth), the next two the chains of the sharded paths
# on 4 x-slabs, where every depth down to 32^3 is cut and the tower starts at
# 16^3 (the periodic box, the 7-level hierarchy's base)
TOWER_CASES = [
    ("path_l0_64", (64, 64, 64), ALL_D, (0, 0, 0), True),
    ("periodic_path_128", (128, 128, 128), ALL_P, (0, 0, 0), True),
    ("sharded_path_16_P", (16, 16, 16), ALL_P, (0, 0, 0), True),
    ("sharded_path_16", (16, 16, 16), ALL_D, (0, 0, 0), True),
    ("l3_176x64x64", (176, 64, 64), ALL_C, (416, 288, 288), False),
    ("mixed_faces", (32, 48, 40), ((D, C), (N, D), (C, N)), (16, 0, 8),
     False),
    ("periodic_axis", (32, 32, 32), ((P, P), (D, C), (C, N)), (0, 0, 0),
     False),
    # the launch's other splits: an odd 17^3 bottom too big for the one-block
    # tail (every depth grid-wide), and a 16x16x15 bottom that is the whole
    # tail (tower_up has no tail to run); both with an odd, open nz at the
    # bottom
    ("no_tail_68", (68, 68, 68), ((D, N), (C, D), (N, C)), (4, 0, 8), False),
    ("bottom_tail_64x64x60", (64, 64, 60), ((P, P), (P, P), (D, N)),
     (0, 4, 0), False),
    # bottoms periodic of odd extent, pre-smoothed in place by tower_down:
    # the 240^3 box's chain (120^3 -> 15^3, the bottom the tail), 144^3 ->
    # 9^3, 80^3 -> 5^3, a 25^3 bottom too big for the tail (grid-wide), and
    # a bottom odd and periodic in z alone
    ("odd_bottom_120_P", (120, 120, 120), ALL_P, (0, 0, 0), True),
    ("odd_bottom_144_P", (144, 144, 144), ALL_P, (0, 0, 0), False),
    ("odd_bottom_80_P", (80, 80, 80), ALL_P, (0, 0, 0), False),
    ("odd_bottom_grid_100_P", (100, 100, 100), ALL_P, (0, 0, 0), False),
    ("odd_z_bottom_96x48x40", (96, 48, 40), ((D, C), (N, D), (P, P)),
     (0, 0, 8), False),
]


def gsrb_forms(u, with_b: bool, kinds, compute: int = 0) -> tuple:
    """The geometry fused_sweeps.gsrb_geometry picks for the level (at the
    capacity of the kernels of `compute`: 1 the bf16 tier), and its form
    then every other form that takes it (the slab form only f32 levels with
    constant b whose tiles fit a block's shared memory)."""
    isz = u.element_size()
    cap = fs.gsrb_capacity(u.device, isz, compute,
                           bool(fs.odd_wrap_axes(u.shape, kinds)))
    picked = fs.gsrb_geometry(u.shape, isz, with_b, kinds, cap)
    forms = [picked.form]
    for form in fs.GSRB_FORMS:
        try:
            fs.gsrb_geometry(u.shape, isz, with_b, kinds, cap, form=form)
        except ValueError:
            continue
        if form not in forms:
            forms.append(form)
    return picked, forms


def check_gsrb(cid: str, f: dict, lo, kw: dict, dtype, timed: bool,
               bound: tuple | None = None) -> dict:
    """gsrb_relax (4 sweeps) against its plain version, through the wrapper
    (the form gsrb_geometry picks) and in every other form that takes the
    level (fused_sweeps.gsrb_launch): one launch per call, the input
    untouched. Timed: the wrapper's time, its device and host time per call,
    and each form's time and device time."""
    relax = lambda fn, **x: fn(f["u"], f["rhs"], f["a"], f["b"], nsweeps=4,
                               lo=lo, **kw, **x)
    ref = relax(fs.gsrb_relax_plain)
    u_in = f["u"].clone()
    geom, forms = gsrb_forms(f["u"], f["b"] is not None, kw["kinds"])
    worst = (0.0, 0.0)
    for form in forms:
        calls = kernel_counts.LAUNCHES["gsrb_relax"]
        launches = kernel_counts.DEVICE_LAUNCHES["gsrb_relax"]
        out = (relax(fs.gsrb_relax) if form == geom.form
               else relax(fs.gsrb_launch, form=form))
        torch.cuda.synchronize()
        check(kernel_counts.LAUNCHES["gsrb_relax"] == calls + 1
              and kernel_counts.DEVICE_LAUNCHES["gsrb_relax"]
              == launches + 1,
              f"gsrb_relax {cid} {dtype} {form}: not one launch per call")
        err, rel = rel_err(out, ref)
        worst = max(worst, (rel, err))
        check(rel <= TOL[dtype] and bool(torch.isfinite(out).all()),
              f"gsrb_relax {cid} {dtype} {form}: rel err {rel} > "
              f"{TOL[dtype]}")
        again = (relax(fs.gsrb_relax) if form == geom.form
                 else relax(fs.gsrb_launch, form=form))
        check(torch.equal(again, out), f"gsrb_relax {cid} {dtype} {form}: "
              f"two launches differ: {rel_err(again, out)}")
        check(torch.equal(u_in, f["u"]),
              f"gsrb_relax {cid} {dtype} {form}: input modified")
        check(not torch.equal(out, f["u"]), f"gsrb_relax {cid}: no update")
    rec = {"max_abs_err": worst[1], "rel_err": worst[0], "form": geom.form,
           "blocks": geom.blocks, "forms_checked": forms,
           "relaunch_bitwise": True, "wrap_face_cells": geom.faces}
    if timed:
        run = lambda: relax(fs.gsrb_relax)
        rec.update(
            ms=time_ms(run), device_ms=device_ms(run), host_us=host_us(run),
            plain_ms=time_ms(lambda: relax(fs.gsrb_relax_plain), reps=10,
                             warmup=1),
            bound_ms=bound[0], bound_by=bound[1],
            forms_ms={form: time_ms(lambda: relax(fs.gsrb_launch, form=form))
                      for form in forms},
            forms_device_ms={form: device_ms(
                lambda: relax(fs.gsrb_launch, form=form)) for form in forms})
    return rec


# The bf16 tier (smoother_precision = bfloat16). A kernel against:
#  * its twin (the plain version with the kernels' colour select,
#    fs.gsrb_sweeps_folded(_where=True): a pass leaves the other colour's
#    cells as they are): bit for bit; tower_down depth by depth, each
#    depth's relaxation from the state and rhs the kernel gave it (its
#    residual and restriction stay f32 and are held at TOL), tower_up as a
#    whole chain;
#  * its plain bf16 version (what the wrapper runs on the CPU; the JAX
#    body's twin), of max|plain|: the plain version keeps the JAX body's
#    arithmetic colour select, s = acc + par * (s - acc), which in bf16 moves
#    a kept cell by an ulp of the would-be update acc, not of the cell, where
#    the kernel never writes a kept cell: BF16_TOL (read on the card up to
#    2.15 % of max|plain| for gsrb_relax, 1.5 % for a tower_down depth and
#    2.3 % for a tower_up chain; other inputs can read more: 6.2 % at the
#    64^3 chain's 8^3 depth on the CPU with other seeds); a tower as
#    against its twin;
#  * its f32 form, of max|f32| (f32 dtype and not equal as well): within the
#    JAX package's contract (tests/test_fused_sweeps.py::
#    test_bf16_compute_tier_tracks_f32), BF16_CONTRACT; of a tower call, its
#    depth-0 state and its result, its other outputs reported.
BF16 = "bfloat16"
BF16_TOL = 0.05
BF16_CONTRACT = 0.05
# level cases the tier's path never sends to gsrb_relax (the march rungs
# take them)
BF16_SKIP = ("path_l5_512x96x96", "big_960x144x144", "periodic_path_256",
             "odd_path_240_P")


def tier_twin(u, rhs, a, **kw):
    """The bf16 tier as its kernels compute it (fs.gsrb_sweeps_folded with
    the kernels' colour select)."""
    return fs.gsrb_sweeps_folded(u, rhs, a, compute_dtype=BF16, _where=True,
                                 **kw)


def check_against_f32(what: str, out, f32, tol: float) -> float:
    """The tier's result against the f32 form's: f32, not equal, within tol
    of max|f32|; returns that ratio."""
    err, rel = rel_err(out, f32)
    check(out.dtype == torch.float32 and 0 < err and rel <= tol,
          f"{what}: {out.dtype}, {rel} of max|f32| against the f32 form "
          f"(must differ, limit {tol})")
    return rel


def check_gsrb_bf16(cid: str, f: dict, lo, kw: dict, timed: bool,
                    bound: tuple | None, f32_rec: dict) -> dict:
    """gsrb_relax in the bf16 tier (4 sweeps, constant b) through the
    wrapper (the form gsrb_geometry picks at the tier kernels' capacity)
    and in every other form that takes the level: one launch a call,
    counted under gsrb_relax_bf16, the input untouched; against its plain
    bf16 version (BF16_TOL), bit for bit against its twin (tier_twin) and
    against the f32 kernel's result (BF16_CONTRACT).
    Timed: as check_gsrb, beside the f32 form's times from `f32_rec`."""
    tier = dict(compute_dtype=BF16)
    relax = lambda fn, **x: fn(f["u"], f["rhs"], f["a"], None, nsweeps=4,
                               lo=lo, **kw, **x)
    ref = relax(fs.gsrb_relax_plain, **tier)
    twin = tier_twin(f["u"], f["rhs"], f["a"], nsweeps=4, lo=lo, **kw)
    f32 = relax(fs.gsrb_relax)
    u_in = f["u"].clone()
    geom, forms = gsrb_forms(f["u"], False, kw["kinds"], compute=1)
    worst, against = (0.0, 0.0), 0.0
    for form in forms:
        out = one_launch("gsrb_relax_bf16", lambda: (
            relax(fs.gsrb_relax, **tier) if form == geom.form
            else relax(fs.gsrb_launch, form=form, **tier)))
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        worst = max(worst, (rel, err))
        check(rel <= BF16_TOL and bool(torch.isfinite(out).all()),
              f"gsrb_relax_bf16 {cid} {form}: {rel} of max|plain| > "
              f"{BF16_TOL}")
        check(torch.equal(out, twin), f"gsrb_relax_bf16 {cid} {form}: not "
              f"bit for bit its twin: {rel_err(out, twin)}")
        again = (relax(fs.gsrb_relax, **tier) if form == geom.form
                 else relax(fs.gsrb_launch, form=form, **tier))
        check(torch.equal(again, out), f"gsrb_relax_bf16 {cid} {form}: two "
              f"launches differ")
        against = max(against, check_against_f32(
            f"gsrb_relax_bf16 {cid} {form}", out, f32, BF16_CONTRACT))
        check(torch.equal(u_in, f["u"]),
              f"gsrb_relax_bf16 {cid} {form}: input modified")
    rec = {"max_abs_err": worst[1], "rel_err": worst[0],
           "tolerance": BF16_TOL, "equals_twin": True, "against_f32": against,
           "against_f32_limit": BF16_CONTRACT, "form": geom.form,
           "blocks": geom.blocks, "forms_checked": forms}
    if timed:
        run = lambda: relax(fs.gsrb_relax, **tier)
        rec.update(
            ms=time_ms(run), device_ms=device_ms(run), host_us=host_us(run),
            plain_ms=time_ms(lambda: relax(fs.gsrb_relax_plain, **tier),
                             reps=10, warmup=1),
            bound_ms=bound[0], bound_by=bound[1],
            forms_device_ms={form: device_ms(lambda: relax(
                fs.gsrb_launch, form=form, **tier)) for form in forms},
            f32_ms=f32_rec.get("ms"), f32_device_ms=f32_rec.get("device_ms"),
            f32_host_us=f32_rec.get("host_us"), f32_form=f32_rec["form"])
    return rec


def check_level_case(case, dtype) -> dict:
    cid, shape, kinds, lo, rho, with_b, timed = case
    f = level_fields(shape, dtype, seed=1, with_b=with_b)
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
    ncells = shape[0] * shape[1] * shape[2]
    isz = f["u"].element_size()
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "tolerance": TOL[dtype]}
    narr = 4 + (1 if with_b else 0)
    rec["gsrb_relax"] = check_gsrb(
        cid, f, lo, kw, dtype, timed,
        bound_ms(level_bytes(ncells, isz, narr), 4 * 32.0 * ncells))
    if dtype == torch.float32 and cid not in BF16_SKIP:
        rec["gsrb_relax_bf16"] = check_gsrb_bf16(
            cid, f, lo, kw, timed,
            bound_ms(level_bytes(ncells, isz, 4), 4 * 32.0 * ncells),
            rec["gsrb_relax"])

    rec.update(check_residual(cid, f, kw, dtype, timed))
    return rec


def one_launch(name: str, fn):
    """fn() with the check that it was one wrapper call and one kernel
    launch of `name`."""
    calls = kernel_counts.LAUNCHES[name]
    launches = kernel_counts.DEVICE_LAUNCHES[name]
    out = fn()
    check(kernel_counts.LAUNCHES[name] == calls + 1
          and kernel_counts.DEVICE_LAUNCHES[name] == launches + 1,
          f"{name}: not one launch per call")
    return out


def check_residual(cid: str, f: dict, kw: dict, dtype, timed: bool) -> dict:
    """residual and, where every axis is even, residual_restrict against
    their plain versions (csrc/residual.cu, one launch a call): the
    restricted form into a new tensor and into a strided slice of a larger
    parent (the rest of it untouched), each bitwise equal to
    restrict_full(residual). Timed: each form's batched time, device and
    host time per call, plain time and bound (inputs once, the output
    once: the whole residual, or an eighth of it)."""
    args = (f["u"], f["rhs"], f["a"], f["b"])
    shape, isz = tuple(f["u"].shape), f["u"].element_size()
    ncells = math.prod(shape)
    res = one_launch("residual", lambda: fs.residual(*args, **kw))
    torch.cuda.synchronize()
    err, rel = rel_err(res, fs.residual_plain(*args, **kw))
    out = {"residual": {"max_abs_err": err, "rel_err": rel,
                        "relaunch_bitwise": True,
                        "geometry": fs.residual_geometry_on(
                            *args, out=res, restrict=False)._asdict()}}
    check(rel <= TOL[dtype], f"residual {cid} {dtype}: rel err {rel}")
    check(torch.equal(fs.residual(*args, **kw), res),
          f"residual {cid} {dtype}: two launches differ")
    nin = 3 + (f["b"] is not None)
    runs = {"residual": (lambda: fs.residual(*args, **kw),
                         lambda: fs.residual_plain(*args, **kw),
                         level_bytes(ncells, isz, nin + 1))}
    if not any(n % 2 for n in shape):
        rc = one_launch("residual_restrict",
                        lambda: fs.residual_restrict(*args, **kw))
        torch.cuda.synchronize()
        err, rel = rel_err(rc, fs.residual_restrict_plain(*args, **kw))
        check(rel <= TOL[dtype],
              f"residual_restrict {cid} {dtype}: rel err {rel}")
        check(torch.equal(rc, st.restrict_full(res)),
              f"residual_restrict {cid} {dtype}: not restrict_full of "
              f"residual bit for bit")
        check(torch.equal(fs.residual_restrict(*args, **kw), rc),
              f"residual_restrict {cid} {dtype}: two launches differ")
        # into the covered part of a parent, as the AMR downsweep writes it
        half = tuple(n // 2 for n in shape)
        parent = torch.full(tuple(n + 3 for n in half), -7.0, dtype=dtype,
                            device="cuda")
        view = parent[1:1 + half[0], 2:2 + half[1], 1:1 + half[2]]
        one_launch("residual_restrict",
                   lambda: fs.residual_restrict(*args, out=view, **kw))
        torch.cuda.synchronize()
        rest = parent.clone()
        rest[1:1 + half[0], 2:2 + half[1], 1:1 + half[2]] = -7.0
        check(torch.equal(view, rc) and bool((rest == -7.0).all()),
              f"residual_restrict {cid} {dtype}: into a parent's slice")
        out["residual_restrict"] = {
            "max_abs_err": err, "rel_err": rel, "equals_restrict_full": True,
            "into_slice": True, "relaunch_bitwise": True, "geometry": fs.residual_geometry_on(
                *args, out=rc, restrict=True)._asdict()}
        runs["residual_restrict"] = (
            lambda: fs.residual_restrict(*args, **kw),
            lambda: fs.residual_restrict_plain(*args, **kw),
            level_bytes(ncells, isz, nin) + ncells * isz / 8)
    if timed:
        for name, (run, plain, nbytes) in runs.items():
            b, by = bound_ms(nbytes, 16.0 * ncells)
            out[name].update(
                ms=time_ms(run), device_ms=device_ms(run),
                host_us=host_us(run),
                plain_ms=time_ms(plain, reps=10, warmup=1),
                bound_ms=b, bound_by=by)
    return out


# residual cases beside LEVEL_CASES, for each form of csrc/residual.cu
# (fused_sweeps.residual_form): (id, shape, kinds, rho, with_b, misaligned).
# An odd nz (one cell a thread; the whole residual only), an odd periodic
# y (a tile's last row pair half in the level, the row below it wrapped),
# nz = 2 mod 4 (two cells a thread in f32), operands off a 16-byte boundary
# (two cells a thread, one copy a cell), the smallest level.
RESIDUAL_CASES = [
    ("odd_nz", (20, 18, 33), ((D, C), (N, D), (C, N)), 2.0, True, False),
    ("odd_periodic_y", (20, 17, 24), ((D, C), (P, P), (C, N)), 2.0, False,
     False),
    ("nz_2_mod_4", (24, 20, 34), ALL_P, 0.5, True, False),
    ("misaligned", (16, 20, 24), ((C, D), (D, N), (P, P)), 2.0, False, True),
    ("smallest_P", (2, 2, 2), ALL_P, 2.0, False, False),
]


def check_residual_case(case, dtype) -> dict:
    cid, shape, kinds, rho, with_b, misaligned = case
    f = level_fields(shape, dtype, seed=9, with_b=with_b)
    if misaligned:  # one element past a 16-byte boundary, still contiguous
        for k in ("u", "rhs", "a"):
            buf = torch.empty(f[k].numel() + 1, dtype=dtype, device="cuda")
            f[k] = buf[1:].view(shape).copy_(f[k])
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "tolerance": TOL[dtype]}
    rec.update(check_residual(cid, f, kw, dtype, False))
    want = fs.residual_form(shape[2], f["u"].element_size(), not misaligned)
    check((rec["residual"]["geometry"]["vz"],
           rec["residual"]["geometry"]["vec"]) == want,
          f"residual {cid}: form {rec['residual']['geometry']}")
    return rec


# gsrb_relax cases for each split of its launch (fused_sweeps.gsrb_geometry),
# beside LEVEL_CASES: (id, shape, kinds, lo, with_b). Every form that takes a
# level runs it (check_gsrb: the slab form f32 with constant b only, forced
# where the geometry picks the grid form), f32 and f64.
GSRB_CASES = [
    # odd lo on tiles that do not divide the level: x (12 and 13 planes),
    # then x and y (11 and 12 planes, 6 and 7 rows)
    ("uneven_tiles_odd_lo", (270, 78, 80), ALL_C, (1521, 960, 960), False),
    ("uneven_tiles_xy", (128, 83, 80), ((D, C), (N, D), (C, N)), (0, 1, 0),
     False),
    # nx below the block count: 2 x tiles of a plane, 64 y tiles of a row;
    # x periodic, so each tile's two x neighbours are the same block
    ("nx_below_blocks_ring", (2, 64, 48), ((P, P), (D, C), (C, N)), (1, 0, 0),
     False),
    # the periodic-x ring of 16 x tiles, and every axis periodic (33 x 4
    # tiles, y wrapping too)
    ("periodic_x_ring", (48, 40, 36), ((P, P), (D, C), (C, N)), (0, 1, 0),
     False),
    ("all_periodic_tiles", (264, 32, 32), ALL_P, (1, 0, 0), False),
    # a one-block level with every face kind
    ("one_block_16", (16, 16, 16), ((D, N), (C, D), (N, C)), (1, 0, 0),
     False),
    # variable b: the grid form
    ("var_b_272x80x80", (272, 80, 80), ALL_C, (0, 0, 0), True),
    ("var_b_odd_nz", (40, 30, 33), ((D, C), (P, P), (C, N)), (0, 0, 1), True),
]


def check_gsrb_case(case, dtype) -> dict:
    cid, shape, kinds, lo, with_b = case
    f = level_fields(shape, dtype, seed=5, with_b=with_b)
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37)
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "tolerance": TOL[dtype],
           "gsrb_relax": check_gsrb(cid, f, lo, kw, dtype, False)}
    if dtype == torch.float32 and not with_b:
        rec["gsrb_relax_bf16"] = check_gsrb_bf16(cid, f, lo, kw, False, None,
                                                 rec["gsrb_relax"])
    return rec


# batches of same-shape sibling patches (gsrb_relax_batch,
# residual_restrict_batch): (id, shape, kinds, rho, the patches' lo, timed).
# The canonical patches hierarchy's three pairs (depths 4-6, every lo a
# multiple of 8: the first patch at its LEVEL_CASES lo, the second beside
# it), a pair at odd parity, three patches, a small pair with every face
# kind (the one-block slab form), and the largest pair in f64 too
# (BATCH_F64); three 144^3 patches at odd parity (the march form with three
# patches), and three 112^3 patches (3 x 22.5 MB overflow the L2 that one
# fits, at a tile width the march is not built for: the serial form) at
# odd parity and with periodic x and z faces.
BATCH_CASES = [
    ("batch_d4_72x80x80_pair", (72, 80, 80), ALL_C, 2.0,
     ((376, 472, 472), (376, 552, 472)), True),
    ("batch_d5_104x96x96_pair", (104, 96, 96), ALL_C, 2.0,
     ((768, 976, 976), (768, 1072, 976)), True),
    ("batch_d6_144_pair", (144, 144, 144), ALL_C, 2.0,
     ((1568, 1976, 1976), (1568, 2120, 1976)), True),
    ("batch_odd_parity_pair", (72, 80, 80), ALL_C, 2.0,
     ((377, 472, 472), (377, 552, 472)), False),
    ("batch_three_48", (48, 48, 48), ALL_C, 2.0,
     ((488, 488, 488), (536, 488, 488), (584, 488, 488)), False),
    ("batch_one_block_mixed", (16, 16, 16), ((D, N), (C, D), (N, C)), 0.5,
     ((1, 0, 0), (1, 16, 0)), False),
    ("batch_three_144_odd", (144, 144, 144), ALL_C, 2.0,
     ((1569, 1976, 1976), (1569, 2120, 1976), (1569, 2264, 1976)), True),
    ("batch_three_112_odd", (112, 112, 112), ALL_C, 2.0,
     ((113, 224, 224), (225, 224, 224), (337, 224, 224)), False),
    ("batch_three_112_periodic", (112, 112, 112), ((P, P), (D, N), (P, P)),
     2.0, ((0, 0, 0), (112, 0, 0), (0, 112, 0)), False),
    # periodic axes of odd extent (each form that takes them: one block a
    # patch, the grid and serial forms with their wrap faces), and an odd
    # periodic x over many blocks
    ("batch_odd_periodic_15_P", (15, 15, 15), ALL_P, 2.0,
     ((0, 0, 0), (30, 0, 0)), True),
    ("batch_odd_periodic_x_45x64x64", (45, 64, 64), ((P, P), (D, N), (C, D)),
     2.0, ((1, 0, 0), (1, 64, 0)), False),
]
# the sweeps of a batch call in the kernels phase (the solver's nsmooth)
BATCH_SWEEPS = 4
BATCH_F64 = ("batch_d6_144_pair", "batch_odd_parity_pair",
             "batch_odd_periodic_15_P", "batch_odd_periodic_x_45x64x64")


def batch_forms(shape, itemsize: int, kinds, patches: int) -> tuple:
    """The geometry fs.gsrb_geometry picks for a batch of `patches` levels
    of `shape` (BATCH_SWEEPS sweeps) at the card's capacity, and every form
    that takes it."""
    cap = fs.gsrb_capacity(torch.device("cuda"), itemsize, 0,
                           bool(fs.odd_wrap_axes(shape, kinds)))
    picked = fs.gsrb_geometry(shape, itemsize, False, kinds, cap,
                              patches=patches, nsweeps=BATCH_SWEEPS)
    forms = [picked.form]
    for form in fs.GSRB_FORMS:
        try:
            fs.gsrb_geometry(shape, itemsize, False, kinds, cap, form=form,
                             patches=patches, nsweeps=BATCH_SWEEPS)
        except ValueError:
            continue
        if form not in forms:
            forms.append(form)
    return picked, forms


def check_batch_case(case, dtype) -> dict:
    """gsrb_relax_batch (4 sweeps) and residual_restrict_batch on P patches
    against their plain versions (TOL) and BIT FOR BIT against P single
    calls of gsrb_relax / residual_restrict; every form gsrb_geometry can
    pick for the batch (forced by gsrb_batch_launch); one launch a call,
    the inputs untouched, each restricted residual into its own parent's
    slice. Timed: each batched form's device and host time per call beside
    P single calls', the plain version's time and the bound (P times a
    single call's bytes over HBM_BYTES_S); and every form's device and host
    time per call (forms_device_ms, forms_host_us)."""
    cid, shape, kinds, rho, los, timed = case
    npatch = len(los)
    fields = [level_fields(shape, dtype, seed=20 + k) for k in range(npatch)]
    us, rhss, as_ = ([f[k] for f in fields] for k in ("u", "rhs", "a"))
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
    isz = us[0].element_size()
    ncells = math.prod(shape)
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "patches": npatch, "lo": [list(lo) for lo in los],
           "tolerance": TOL[dtype]}
    u_in = [u.clone() for u in us]
    relax = dict(nsweeps=BATCH_SWEEPS, los=los, **kw)
    ref = fs.gsrb_relax_batch_plain(us, rhss, as_, **relax)
    single = [fs.gsrb_relax(u, r, a, nsweeps=BATCH_SWEEPS, lo=lo, **kw)
              for u, r, a, lo in zip(us, rhss, as_, los)]
    geom, forms = batch_forms(shape, isz, kinds, npatch)
    worst = {}  # by kernel: the march form's, the others'
    for form in forms:
        name = batch_kernel(form)
        out = one_launch(name, lambda: (
            fs.gsrb_relax_batch(us, rhss, as_, **relax) if form == geom.form
            else fs.gsrb_batch_launch(us, rhss, as_, form=form, **relax)))
        torch.cuda.synchronize()
        for k, (o, r, one) in enumerate(zip(out, ref, single)):
            err, rel = rel_err(o, r)
            worst[name] = max(worst.get(name, (0.0, 0.0)), (rel, err))
            check(rel <= TOL[dtype] and bool(torch.isfinite(o).all()),
                  f"gsrb_relax_batch {cid} {dtype} {form} patch {k}: rel "
                  f"err {rel} > {TOL[dtype]}")
            check(torch.equal(o, one),
                  f"gsrb_relax_batch {cid} {dtype} {form} patch {k}: not "
                  f"bit for bit the single call")
        again = (fs.gsrb_relax_batch(us, rhss, as_, **relax)
                 if form == geom.form
                 else fs.gsrb_batch_launch(us, rhss, as_, form=form, **relax))
        check(all(torch.equal(a, o) for a, o in zip(again, out)),
              f"gsrb_relax_batch {cid} {dtype} {form}: two launches differ")
        check(all(torch.equal(a, b) for a, b in zip(u_in, us)),
              f"gsrb_relax_batch {cid} {dtype} {form}: input modified")
    # the wrapper's record (the form it picks; the errors of every form),
    # and the march kernel's own where it is among the forms
    picked = batch_kernel(geom.form)
    rec["gsrb_relax_batch"] = {
        "max_abs_err": max(worst.values())[1],
        "rel_err": max(worst.values())[0], "form": geom.form,
        "kernel": picked, "blocks_per_patch": geom.blocks,
        "forms_checked": forms, "equals_single_calls": True}
    if "march" in forms:  # its blocks are the launch's, in rounds
        launch = fs.batch_march_geometry(
            shape, kinds, fs.batch_march_capacity(us[0].device), npatch)
        rec["gsrb_relax_batch_march"] = {
            "max_abs_err": worst["gsrb_relax_batch_march"][1],
            "rel_err": worst["gsrb_relax_batch_march"][0], "form": "march",
            "picked": geom.form == "march", "equals_single_calls": True,
            "blocks": launch.blocks, "tile": launch.tile,
            "xseg": launch.xseg, "items": npatch
            * -(-shape[0] // launch.xseg) * -(-shape[1] // (launch.tile - 8))
            * -(-shape[2] // (launch.tile - 8))}
        if geom.form == "march":
            rec["gsrb_relax_batch"].update(
                blocks_per_patch=None, blocks=launch.blocks)
    # the restricted residual, each patch into its own parent's slice
    # (a level of odd extent is a bottom: nothing restricts it)
    even = all(n % 2 == 0 for n in shape)
    if even:
        half = tuple(n // 2 for n in shape)
        parents = [torch.full(tuple(n + 3 for n in half), -7.0,
                              dtype=dtype, device="cuda")
                   for _ in range(npatch)]
        views = [p[1:1 + half[0], 2:2 + half[1], 1:1 + half[2]]
                 for p in parents]
        rref = fs.residual_restrict_batch_plain(us, rhss, as_, **kw)
        rsingle = [fs.residual_restrict(u, r, a, **kw)
                   for u, r, a in zip(us, rhss, as_)]
        rc = one_launch("residual_restrict_batch", lambda: (
            fs.residual_restrict_batch(us, rhss, as_, **kw)))
        one_launch("residual_restrict_batch", lambda: (
            fs.residual_restrict_batch(us, rhss, as_, outs=views, **kw)))
        torch.cuda.synchronize()
        worst = (0.0, 0.0)
        for k in range(npatch):
            err, rel = rel_err(rc[k], rref[k])
            worst = max(worst, (rel, err))
            check(rel <= TOL[dtype], f"residual_restrict_batch {cid} "
                  f"{dtype} patch {k}: rel err {rel}")
            check(torch.equal(rc[k], rsingle[k])
                  and torch.equal(views[k], rsingle[k]),
                  f"residual_restrict_batch {cid} {dtype} patch {k}: not "
                  f"bit for bit the single call")
            rest = parents[k].clone()
            rest[1:1 + half[0], 2:2 + half[1], 1:1 + half[2]] = -7.0
            check(bool((rest == -7.0).all()), f"residual_restrict_batch "
                  f"{cid}: wrote outside patch {k}'s slice")
        rec["residual_restrict_batch"] = {
            "max_abs_err": worst[1], "rel_err": worst[0],
            "equals_single_calls": True, "into_slices": True,
            "geometry": fs.residual_batch_geometry(us, rhss, as_)._asdict()}
    if timed:
        runs = {
            "gsrb_relax_batch": (
                lambda: fs.gsrb_relax_batch(us, rhss, as_, **relax),
                lambda: [fs.gsrb_relax(u, r, a, nsweeps=BATCH_SWEEPS,
                                       lo=lo, **kw)
                         for u, r, a, lo in zip(us, rhss, as_, los)],
                lambda: fs.gsrb_relax_batch_plain(us, rhss, as_, **relax),
                level_bytes(ncells, isz, 4), 4 * 32.0 * ncells),
            "residual_restrict_batch": (
                lambda: fs.residual_restrict_batch(us, rhss, as_, **kw),
                lambda: [fs.residual_restrict(u, r, a, **kw)
                         for u, r, a in zip(us, rhss, as_)],
                lambda: fs.residual_restrict_batch_plain(us, rhss, as_,
                                                         **kw),
                level_bytes(ncells, isz, 3) + ncells * isz / 8,
                16.0 * ncells)}
        if not even:
            del runs["residual_restrict_batch"]
        for name, (run, singles, plain, nbytes, flops) in runs.items():
            b, by = bound_ms(npatch * nbytes, npatch * flops)
            rec[name].update(
                ms=time_ms(run), device_ms=device_ms(run),
                host_us=host_us(run), singles_ms=time_ms(singles),
                singles_device_ms=device_ms(singles),
                singles_host_us=host_us(singles),
                plain_ms=time_ms(plain, reps=10, warmup=1), bound_ms=b,
                bound_by=by)
        # a group launch's host time beside one single call's (patch 0),
        # in turns, which it must not exceed
        for name, one in (
                ("gsrb_relax_batch", lambda: fs.gsrb_relax(
                    us[0], rhss[0], as_[0], nsweeps=BATCH_SWEEPS, lo=los[0],
                    **kw)),
                ("residual_restrict_batch", lambda: fs.residual_restrict(
                    us[0], rhss[0], as_[0], **kw))):
            if name not in runs:
                continue
            group, single = host_us_pair(runs[name][0], one)
            rec[name].update(group_host_us=group, single_host_us=single)
        launch = {form: (lambda form=form: fs.gsrb_batch_launch(
            us, rhss, as_, form=form, **relax)) for form in forms}
        rec["gsrb_relax_batch"]["forms_device_ms"] = {
            form: device_ms(run) for form, run in launch.items()}
        rec["gsrb_relax_batch"]["forms_host_us"] = {
            form: host_us(run) for form, run in launch.items()}
        if picked == "gsrb_relax_batch_march":  # the wrapper's times are its
            rec[picked].update({k: rec["gsrb_relax_batch"][k] for k in (
                "ms", "device_ms", "host_us", "singles_ms",
                "singles_device_ms", "singles_host_us", "plain_ms",
                "bound_ms", "bound_by", "group_host_us", "single_host_us")})
    return rec


def batch_kernel(form: str) -> str:
    """The counter a gsrb_relax_batch launch in `form` goes to: the batch
    march's (csrc/gsrb_batch_march.cu) or the batched gsrb_relax's."""
    return "gsrb_relax_batch_march" if form == "march" else \
        "gsrb_relax_batch"


def one_launch_kernels() -> dict:
    """The two wrappers of the kernel that carries a chunk of sweeps in one
    launch (x open / any face kinds): name -> (wrapper, plain version,
    chunks, cases)."""
    return {
        "wavefront_relax": (wf.wavefront_relax, wf.wavefront_relax_plain,
                            wf.CHUNKS, WAVE_CASES),
        "multisweep_relax": (fs.multisweep_relax, fs.multisweep_relax_plain,
                             fs.MULTISWEEP_CHUNKS, MULTI_CASES),
    }


def march_steps(u, ms: float, bound: float, nsweeps: int = 2,
                compute: int = 0) -> dict:
    """The whole-level march's launch on `u` (fused_sweeps.march_geometry;
    compute 1: the bf16 tier's form): tile width, x segments, steps of the
    longest block (its segment, the rind planes at both ends and the
    drain), rounds of blocks, and from the kernel's time `ms` the time of
    one step and the fraction of the byte bound reached."""
    tile, nseg, xseg = fs.march_geometry_on(u, nsweeps, compute)
    inner = tile - 4 * nsweeps
    tiles = -(-u.shape[1] // inner) * -(-u.shape[2] // inner)
    cap = fs.march_capacity(u.device, u.element_size(), nsweeps, tile,
                            compute)
    steps = xseg + 3 * 2 * nsweeps - 1
    rounds = -(-tiles * nseg // cap)
    return {"tile": tile, "segments": nseg, "xseg": xseg, "blocks": tiles * nseg,
            "capacity": cap, "steps_per_block": steps, "rounds": rounds,
            "us_per_step": 1e3 * ms / (rounds * steps),
            "fraction_of_bound": bound / ms}


def check_one_launch_case(name: str, case, dtype) -> dict:
    """wavefront_relax or multisweep_relax against its plain version AND
    against the gsrb_relax kernel (the same function in another kernel);
    nsweeps 2 and 4; one launch per call, the input untouched."""
    fn, plain, chunks, _ = one_launch_kernels()[name]
    cid, shape, kinds, lo, rho, timed = case
    f = level_fields(shape, dtype, seed=3)
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37, lo=lo)
    ncells = shape[0] * shape[1] * shape[2]
    isz = f["u"].element_size()
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "tolerance": TOL[dtype], name: {}}
    worst = (0.0, 0.0)
    against = set()
    u_in = f["u"].clone()
    for ns in chunks:
        others = {
            "plain": plain(f["u"], f["rhs"], f["a"], nsweeps=ns, **kw),
            "gsrb_relax": fs.gsrb_relax(f["u"], f["rhs"], f["a"], None,
                                        nsweeps=ns, **kw)}
        before = kernel_counts.DEVICE_LAUNCHES[name]
        out = fn(f["u"], f["rhs"], f["a"], nsweeps=ns, **kw)
        torch.cuda.synchronize()
        check(kernel_counts.DEVICE_LAUNCHES[name] == before + 1,
              f"{name}: not one launch per call")
        check(torch.equal(u_in, f["u"]), f"{name} {cid}: input modified")
        check(torch.equal(fn(f["u"], f["rhs"], f["a"], nsweeps=ns, **kw),
                          out),
              f"{name} {cid} {dtype} nsweeps {ns}: two launches differ")
        for what, other in others.items():
            err, rel = rel_err(out, other)
            worst = max(worst, (rel, err))
            against.add(what)
            check(rel <= TOL[dtype] and bool(torch.isfinite(out).all()),
                  f"{name} {cid} {dtype} nsweeps {ns} vs {what}: "
                  f"rel err {rel} > {TOL[dtype]}")
        del others, out
    rec[name].update(rel_err=worst[0], max_abs_err=worst[1],
                     against=sorted(against), relaunch_bitwise=True)
    if timed:
        run = lambda ns: fn(f["u"], f["rhs"], f["a"], nsweeps=ns, **kw)
        run2x2 = lambda: fn(run(2), f["rhs"], f["a"], nsweeps=2, **kw)
        b, by = bound_ms(level_bytes(ncells, isz, 4), 2 * 32.0 * ncells)
        ms = time_ms(lambda: run(2))
        rec[name].update(
            nsweeps=2,
            ms=ms, **march_steps(f["u"], ms, b),
            plain_ms=time_ms(lambda: plain(
                f["u"], f["rhs"], f["a"], nsweeps=2, **kw), reps=6,
                warmup=1),
            bound_ms=b, bound_by=by,
            ms_4sweeps_one_launch=time_ms(lambda: run(4)),
            ms_4sweeps_two_launches=time_ms(run2x2),
            gsrb_relax_ms_2sweeps=time_ms(lambda: fs.gsrb_relax(
                f["u"], f["rhs"], f["a"], None, nsweeps=2, **kw)),
            gsrb_relax_ms_4sweeps=time_ms(lambda: fs.gsrb_relax(
                f["u"], f["rhs"], f["a"], None, nsweeps=4, **kw)),
        )
    return rec


# The bf16 tier of the marches (csrc/multisweep.cu, csrc/multisweep_halo.cu:
# every float form built again with bf16 colour passes). Each form against
# its twin (tier_twin, the kernels' colour select) bit for bit, with a and
# rhs in 16-byte chunks and one element a copy; the whole-level form against
# bf16 gsrb_relax at the same shape bit for bit (one update,
# gsrb_update_bf16); every shard form joined against the whole-level form
# bit for bit; against its plain bf16 version (BF16_TOL) and its f32 form
# at the JAX package's contract of the family: BF16_CONTRACT, 0.1 for the
# wavefront (tests/test_wavefront.py::test_wavefront_bf16_tier_tracks_f32).
WAVE_CONTRACT = 0.1
# the march case the tier is not held at: 512^3 (the twin's bf16
# temporaries of 134M cells; no path of the tier sends it)
BF16_MARCH_SKIP = ("periodic_512",)


def misaligned(t):
    """A copy of t whose storage starts one element past the allocation's
    start (4 bytes past a 16-byte boundary for f32), so that a march takes
    its one-element copies of a and rhs."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def f32_ratios(r: dict) -> dict:
    """A timed bf16 march record's times over its f32 form's, both measured
    in the same call: batched (ms) and device."""
    return {"f32_ratio": r["ms"] / r["f32_ms"],
            "device_f32_ratio": r["device_ms"] / r["f32_device_ms"]}


def check_march_bf16(name: str, case) -> dict:
    """wavefront_relax or multisweep_relax (`name`) in the bf16 tier at one
    case (f32 operands; nsweeps 2 and 4): one launch a call, counted under
    name_bf16, the input untouched; bit for bit its twin and bf16
    gsrb_relax at the same shape, with a and rhs as made (16-byte chunks
    where nz allows) and misaligned (one element a copy); against its plain
    bf16 version (BF16_TOL) and its f32 form (the family's contract).
    Timed: its time, device and host time per call beside the f32 form's
    in this call, the plain bf16 version's time, the bound (the f32 form's
    bytes: the operands stay f32) and its launch (march_steps)."""
    fn, plain, chunks, _ = one_launch_kernels()[name]
    cid, shape, kinds, lo, rho, timed = case
    tname = fs.tier_name(name, BF16)
    tier = dict(compute_dtype=BF16)
    contract = WAVE_CONTRACT if name == "wavefront_relax" else BF16_CONTRACT
    f = level_fields(shape, torch.float32, seed=3)
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37, lo=lo)
    u_in = f["u"].clone()
    chunked = shape[2] % 4 == 0
    worst, against, paths = (0.0, 0.0), 0.0, []
    for ns in chunks:
        args = (f["u"], f["rhs"], f["a"])
        twin = tier_twin(*args, nsweeps=ns, **kw)
        gsrb = fs.gsrb_relax(*args, None, nsweeps=ns, **kw, **tier)
        ref = plain(*args, nsweeps=ns, **kw, **tier)
        f32 = fn(*args, nsweeps=ns, **kw)
        operands = [("V1" if chunked else "V0", f["rhs"], f["a"])]
        if chunked:
            operands.append(("V0", misaligned(f["rhs"]), misaligned(f["a"])))
        for v, rhs, a in operands:
            out = one_launch(tname, lambda: fn(f["u"], rhs, a, nsweeps=ns,
                                               **kw, **tier))
            torch.cuda.synchronize()
            what = f"{tname} {cid} nsweeps {ns} {v}"
            paths.append(v)
            check(torch.equal(out, twin), f"{what}: not bit for bit its "
                  f"twin: {rel_err(out, twin)}")
            check(torch.equal(out, gsrb), f"{what}: not bit for bit bf16 "
                  f"gsrb_relax: {rel_err(out, gsrb)}")
            err, rel = rel_err(out, ref)
            worst = max(worst, (rel, err))
            check(rel <= BF16_TOL and bool(torch.isfinite(out).all()),
                  f"{what}: {rel} of max|plain| > {BF16_TOL}")
            against = max(against, check_against_f32(what, out, f32,
                                                     contract))
            check(torch.equal(u_in, f["u"]), f"{what}: input modified")
        del twin, gsrb, ref, f32, operands
    rec = {"case": cid, "shape": list(shape), "dtype": "float32", tname: {
        "rel_err": worst[0], "max_abs_err": worst[1], "tolerance": BF16_TOL,
        "equals_twin": True, "equals_gsrb_relax_bf16": True,
        "against_f32": against, "against_f32_limit": contract,
        "v_paths": sorted(set(paths))}}
    if timed:
        args = (f["u"], f["rhs"], f["a"])
        run = lambda: fn(*args, nsweeps=2, **kw, **tier)
        run32 = lambda: fn(*args, nsweeps=2, **kw)
        ncells = math.prod(shape)
        b, by = bound_ms(level_bytes(ncells, 4, 4), 2 * 32.0 * ncells)
        ms = time_ms(run)
        rec[tname].update(
            nsweeps=2, ms=ms, **march_steps(f["u"], ms, b, compute=1),
            device_ms=device_ms(run), host_us=host_us(run),
            f32_ms=time_ms(run32), f32_device_ms=device_ms(run32),
            f32_host_us=host_us(run32),
            plain_ms=time_ms(lambda: plain(*args, nsweeps=2, **kw, **tier),
                             reps=6, warmup=1),
            bound_ms=b, bound_by=by)
        rec[tname].update(f32_ratios(rec[tname]))
        # the instantiation that ran (a and rhs in 16-byte chunks where nz
        # allows: the fields are made aligned) with its registers and spills
        form = f"whole NP4 W{rec[tname]['tile']} V{int(chunked)}"
        rec[tname].update(form=form, **tier_forms(
            *ptxas_resources()).get(form, {}))
    return rec


# the one-sweep and one-pass entry points' cases: (id, shape, kinds, lo,
# with_b, timed)
SWEEP_CASES = [
    ("sweep_96x80x80_odd_lo_b", (96, 80, 80), ALL_C, (49, 40, 40), True,
     True),
    ("sweep_96x80x80_odd_lo", (96, 80, 80), ALL_C, (49, 40, 40), False,
     True),
    ("sweep_256_P", (256, 256, 256), ALL_P, (0, 0, 0), False, True),
    ("sweep_4_P", (4, 4, 4), ALL_P, (0, 0, 0), False, True),
    ("sweep_37x30x45_yP_b", (37, 30, 45), ((D, N), (P, P), (C, D)),
     (1, 0, 0), True, False),
    ("sweep_24x18x6", (24, 18, 6), ALL_D, (0, 1, 0), False, False),
]
# the case whose f32 calls are the sweep_entry_points run (the entry points
# driven with the counters set to 0 just before, as a caller would call
# them: the full sweep in its march, the half sweep in its stream), which
# the kernels line reports, and the counts of that run
SWEEP_RUN_CASE = "sweep_256_P"
SWEEP_COUNTS: dict = {}


def check_sweep_entry_points(case, dtype) -> dict:
    """gsrb_full_sweep and gsrb_half_sweep (csrc/gsrb_sweep.cu: one launch
    a call, out of place) in the form each takes, against their plain
    versions; the caller's u untouched, one launch a call, the full sweep
    bit for bit two half sweeps and gsrb_relax with nsweeps = 1; timed:
    device, host and batched times beside the byte bound (each array read
    once, out written once). SWEEP_RUN_CASE in f32 is also the
    sweep_entry_points run of the kernels line."""
    cid, shape, kinds, lo, with_b, timed = case
    f = level_fields(shape, dtype, seed=7, with_b=with_b)
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37, lo=lo)
    args = (f["u"], f["rhs"], f["a"], f["b"])
    u_in = f["u"].clone()
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "with_b": with_b, "tolerance": TOL[dtype]}
    first = cid == SWEEP_RUN_CASE and dtype == torch.float32
    if first:
        kernel_counts.reset()
    before = dict(kernel_counts.DEVICE_LAUNCHES)
    full = fs.gsrb_full_sweep(*args, **kw)
    halves = [fs.gsrb_half_sweep(*args, color=c, **kw) for c in (0, 1)]
    torch.cuda.synchronize()
    if first:
        SWEEP_COUNTS["sweep_entry_points"] = kernel_counts.snapshot()
    got = {k: kernel_counts.DEVICE_LAUNCHES[k] - before[k]
           for k in kernel_counts.KERNELS}
    check(got == {k: {"gsrb_full_sweep": 1, "gsrb_half_sweep": 2}.get(k, 0)
                  for k in got}, f"{cid}: launches {got}")
    check(torch.equal(f["u"], u_in), f"{cid}: input modified")
    err, rel = rel_err(full, fs.gsrb_full_sweep_plain(*args, **kw))
    isz = f["u"].element_size()
    geoms = {full_: fs._sweep_launch(tuple(shape), isz, with_b, kinds,
                                     f["u"].get_device(), full_)[0]
             for full_ in (True, False)}
    rec["gsrb_full_sweep"] = {"max_abs_err": err, "rel_err": rel,
                              **geoms[True]._asdict()}
    check(rel <= TOL[dtype] and bool(torch.isfinite(full).all()),
          f"gsrb_full_sweep {cid} {dtype}: rel err {rel}")
    worst = (0.0, 0.0)
    for c in (0, 1):
        ref = fs.gsrb_half_sweep_plain(*args, color=c, **kw)
        err, rel = rel_err(halves[c], ref)
        worst = max(worst, (rel, err))
        check(rel <= TOL[dtype] and bool(torch.isfinite(halves[c]).all()),
              f"gsrb_half_sweep {cid} colour {c} {dtype}: rel err {rel}")
        # a colour pass leaves the other colour's cells untouched
        check(int((halves[c] != f["u"]).sum()) <= (full.numel() + 1) // 2,
              f"gsrb_half_sweep {cid} colour {c}: touched both colours")
    check(not torch.equal(halves[0], halves[1]), "half sweeps: same colour")
    rec["gsrb_half_sweep"] = {"max_abs_err": worst[1], "rel_err": worst[0],
                              **geoms[False]._asdict()}
    two = fs.gsrb_half_sweep(halves[0], *args[1:], color=1, **kw)
    one = fs.gsrb_relax(*args, nsweeps=1, **kw)
    check(torch.equal(full, two) and torch.equal(full, one),
          f"{cid}: gsrb_full_sweep is not two half sweeps / "
          f"gsrb_relax(nsweeps=1)")
    check(torch.equal(f["u"], u_in), f"{cid}: input modified")
    if not timed:
        return rec
    ncells = full.numel()
    for name, fn, plain, passes in (
            ("gsrb_full_sweep", lambda: fs.gsrb_full_sweep(*args, **kw),
             lambda: fs.gsrb_full_sweep_plain(*args, **kw), 2),
            ("gsrb_half_sweep",
             lambda: fs.gsrb_half_sweep(*args, color=0, **kw),
             lambda: fs.gsrb_half_sweep_plain(*args, color=0, **kw), 1)):
        b, by = bound_ms(level_bytes(ncells, isz, 5 if with_b else 4),
                         passes * 16.0 * ncells / 2)
        dev = device_ms(fn)
        # the host time beside one gsrb_relax call's, taken in turns
        mine, relax = host_us_pair(fn, lambda: fs.gsrb_relax(
            *args, nsweeps=1, **kw))
        rec[name].update(ms=time_ms(fn), device_ms=dev, host_us=host_us(fn),
                         host_us_in_turns=mine,
                         gsrb_relax_host_us_in_turns=relax,
                         wall_ms=wall_ms(fn),
                         plain_ms=time_ms(plain, reps=6, warmup=1),
                         bound_ms=b, bound_by=by, reached=b / dev)
    return rec


def tower_barriers(ndep: int, tail: int, nsmooth: int) -> dict:
    """Grid barriers one call of each tower kernel passes (csrc/tower.cu):
    down, per grid-wide depth, one before each colour pass but the first
    and one before the restriction (which makes the next depth's first
    pass), and one before the one-block tail; up, one after the tail where
    grid-wide depths follow, per grid-wide depth one before each colour
    pass and one after the depth but the last."""
    np_ = 2 * nsmooth
    wide = min(tail, ndep)
    down = sum(max(np_ - 1, 0) + int(d + 1 < ndep) for d in range(wide))
    down += int(0 < wide < ndep)
    top = min(tail, ndep - 1)
    up = int(0 < top < ndep - 1) + sum(np_ + int(d > 0) for d in range(top))
    return {"tower_down": down, "tower_up": up}


def barrier_us(blocks: int) -> float:
    """One grid barrier's time on the card in a cooperative launch of
    `blocks` tower-sized blocks (the probe mgk_tower_barriers: 64 barriers
    against none), microseconds."""
    lib = cuda_ext.lib()

    def run(n):
        err = lib.mgk_tower_barriers(
            blocks, n, torch.cuda.current_stream().cuda_stream)
        cuda_ext.check(err, "tower barrier probe")

    return (time_ms(lambda: run(64)) - time_ms(lambda: run(0))) / 64 * 1e3


def check_tower_case(case, dtype) -> dict:
    cid, shape, kinds, lo, timed = case
    spec = chain_spec(shape, lo, kinds, dx0=0.11)
    ndep = spec.ndepths
    f = level_fields(shape, dtype, seed=2)
    a_list = [f["a"]]
    for _ in range(1, ndep):
        a_list.append(st.coarsen_coef(a_list[-1], "harmonic").contiguous())
    # the size term at f32, which is what the solver's kernel path runs; the
    # f64 run holds the same kernels at twice the bytes
    check(ct.tower_supported(spec, {"b": (None,) * ndep}, 0),
          f"tower case {cid} not tower-shaped")
    isz = f["u"].element_size()
    faces = fs.face_cells(spec.boxes[-1].shape, kinds)
    blocks, tail, smem = ct.tower_geometry(
        [b.shape for b in spec.boxes], isz,
        ct.tower_capacity(f["u"].device, isz, 0, faces > 0), faces)
    rec = {"case": cid, "shape": list(shape), "depths": ndep,
           "dtype": str(dtype)[6:], "tolerance": TOL[dtype],
           "geometry": {"blocks": blocks, "tail": tail, "smem": smem,
                        "bottom": list(spec.boxes[-1].shape),
                        "wrap_face_cells": faces,
                        "grid_barriers": tower_barriers(ndep, tail,
                                                        spec.nsmooth)}}
    inputs = [t.clone() for t in [f["u"], f["rhs"]] + a_list]

    def one_launch(name, fn):
        """fn() through the kernel: one wrapper call, one launch."""
        calls = kernel_counts.LAUNCHES[name]
        launches = kernel_counts.DEVICE_LAUNCHES[name]
        out = fn()
        check(kernel_counts.LAUNCHES[name] == calls + 1
              and kernel_counts.DEVICE_LAUNCHES[name] == launches + 1,
              f"{name} {cid} {dtype}: not one launch per call")
        return out

    down = lambda fn: fn(spec, 0, f["u"], f["rhs"], a_list)
    (ku, kr, kb), (pu, pr, pb) = one_launch(
        "tower_down", lambda: down(ct.tower_down)), down(ct.tower_down_plain)
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for k, p in zip(list(ku) + list(kr) + [kb], list(pu) + list(pr) + [pb]):
        err, rel = rel_err(k, p)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    rec["tower_down"] = {"max_abs_err": worst_abs, "rel_err": worst_rel,
                         "relaunch_bitwise": True}
    check(worst_rel <= TOL[dtype],
          f"tower_down {cid} {dtype}: rel err {worst_rel}")
    ku2, kr2, kb2 = down(ct.tower_down)
    check(all(torch.equal(x, y) for x, y in zip(
        list(ku) + list(kr) + [kb], list(ku2) + list(kr2) + [kb2])),
        f"tower_down {cid} {dtype}: two launches differ")

    # up pass from the plain down pass's outputs, on both sides
    e_bot = 0.5 * pb
    rhs_list = [f["rhs"]] + list(pr)
    up_in = [e_bot.clone()] + [t.clone() for t in list(pu) + list(pr)]
    up = lambda fn: fn(spec, 0, e_bot, list(pu), rhs_list[:-1], a_list[:-1])
    out, ref = one_launch("tower_up", lambda: up(ct.tower_up)), up(
        ct.tower_up_plain)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    rec["tower_up"] = {"max_abs_err": err, "rel_err": rel,
                       "relaunch_bitwise": True}
    check(rel <= TOL[dtype], f"tower_up {cid} {dtype}: rel err {rel}")
    check(torch.equal(up(ct.tower_up), out),
          f"tower_up {cid} {dtype}: two launches differ")
    # the kernels only read their inputs
    check(all(torch.equal(x, y) for x, y in zip(
        inputs + up_in, [f["u"], f["rhs"]] + a_list + [e_bot] + list(pu)
        + list(pr))), f"tower {cid} {dtype}: an input was written")

    if timed:
        cells = [b.num_cells for b in spec.boxes]
        # down: reads u0, rhs0 and every a_d; writes every u_d and the
        # restricted rhs_d (d >= 1)
        nbytes = isz * (2 * cells[0] + sum(cells) + sum(cells)
                        + sum(cells[1:]))
        flops = sum((4 * 32.0 + 16.0) * c for c in cells)
        b, by = bound_ms(nbytes, flops)
        rec["tower_down"].update(
            ms=time_ms(lambda: down(ct.tower_down)),
            device_ms=device_ms(lambda: down(ct.tower_down)),
            host_us=host_us(lambda: down(ct.tower_down)),
            plain_ms=time_ms(lambda: down(ct.tower_down_plain), reps=10,
                             warmup=1),
            bound_ms=b, bound_by=by)
        # up: reads e_bot and u_d, rhs_d, a_d above the bottom; writes u_0
        up_cells = sum(cells[:-1])
        nbytes = isz * (cells[-1] + 3 * up_cells + cells[0])
        b, by = bound_ms(nbytes, (4 * 32.0 + 1.0) * up_cells)
        rec["tower_up"].update(
            ms=time_ms(lambda: up(ct.tower_up)),
            device_ms=device_ms(lambda: up(ct.tower_up)),
            host_us=host_us(lambda: up(ct.tower_up)),
            plain_ms=time_ms(lambda: up(ct.tower_up_plain), reps=10,
                             warmup=1),
            bound_ms=b, bound_by=by)
        if dtype == torch.float32 and blocks > 1:
            rec["geometry"]["barrier_us"] = barrier_us(blocks)
    if dtype == torch.float32:
        rec.update(check_tower_bf16(cid, spec, f, a_list, timed, rec))
    return rec


def tower_depths_bf16(what: str, spec, states, starts, rhs_list,
                      a_list) -> list:
    """Depth k of a bf16 tower call: states[k], the state the kernel wrote,
    is bit for bit its twin's relaxation (tier_twin) of starts[k] against
    rhs_list[k], the state and rhs the kernel gave that depth, and within
    BF16_TOL of max|plain| of the plain bf16 version's. Returns each
    depth's reading against the plain version."""
    out = []
    for k, (x, u0, rhs) in enumerate(zip(states, starts, rhs_list)):
        kw = dict(nsweeps=spec.nsmooth, kinds=spec.kinds, rho=spec.rho[k],
                  alpha=spec.alpha, beta=spec.beta, dx=spec.dx[k],
                  lo=spec.boxes[k].lo)
        twin = tier_twin(u0, rhs, a_list[k], **kw)
        check(torch.equal(x, twin), f"{what} depth {k}: not bit for bit its "
              f"twin: {rel_err(x, twin)}")
        rel = rel_err(x, fs.gsrb_sweeps_folded(u0, rhs, a_list[k],
                                               compute_dtype=BF16, **kw))[1]
        check(rel <= BF16_TOL and bool(torch.isfinite(x).all()),
              f"{what} depth {k}: {rel} of max|plain| > {BF16_TOL}")
        out.append(rel)
    return out


def check_tower_bf16(cid: str, spec, f: dict, a_list, timed: bool,
                     f32_rec: dict) -> dict:
    """tower_down and tower_up in the bf16 tier (the spec's smoother_compute
    "bfloat16"): one launch a call counted under *_bf16, the inputs
    untouched. tower_down depth by depth (tower_depths_bf16: bit for bit
    against the twin and within BF16_TOL of the plain bf16 version,
    from the inputs the kernel gave each depth; its shared-memory tail
    writes every depth's state too), its restricted residuals within TOL of
    the plain f32 residual and restriction of the kernel's states; tower_up
    (whose tail keeps the states of its depths in shared memory) as a
    whole chain: bit for bit its twin (the plain version with the kernels'
    colour select), within BF16_TOL of the plain version; against
    the f32 kernel's from the same inputs: tower_down's depth-0 state (one
    relaxation of the caller's u) and tower_up's result at BF16_CONTRACT,
    every output's deviation reported; tower_down's outputs against the
    plain version's whole chain reported. Timed: as check_tower_case,
    beside the f32 form's times and bounds from `f32_rec` (the operands
    stay f32)."""
    sb = dataclasses.replace(spec, smoother_compute=BF16)
    nd = spec.ndepths
    inputs = [t.clone() for t in [f["u"], f["rhs"]] + a_list]
    down = lambda sp, fn: fn(sp, 0, f["u"], f["rhs"], a_list)
    kd = one_launch("tower_down_bf16", lambda: down(sb, ct.tower_down))
    pd, fd = down(sb, ct.tower_down_plain), down(spec, ct.tower_down)
    torch.cuda.synchronize()
    flat = lambda o: list(o[0]) + list(o[1]) + [o[2]]  # noqa: E731
    check(all(torch.equal(x, y) for x, y in zip(
        flat(kd), flat(down(sb, ct.tower_down)))),
        f"tower_down_bf16 {cid}: two launches differ")
    states, rests = list(kd[0]) + [kd[2]], list(kd[1])
    rhs_in = [f["rhs"]] + rests
    per_depth = tower_depths_bf16(
        f"tower_down_bf16 {cid}", spec, states,
        [f["u"]] + [torch.zeros_like(r) for r in rests], rhs_in, a_list)
    rest_err = 0.0
    for k in range(nd - 1):
        kw = dict(kinds=spec.kinds, rho=spec.rho[k], alpha=spec.alpha,
                  beta=spec.beta, dx=spec.dx[k])
        ref = ct._restrict_pairs(fs.residual_plain(states[k], rhs_in[k],
                                                   a_list[k], **kw))
        rest_err = max(rest_err, rel_err(rests[k], ref)[1])
    check(rest_err <= TOL[torch.float32], f"tower_down_bf16 {cid}: "
          f"restricted residual {rest_err} of max|plain| > TOL")
    against = check_against_f32(f"tower_down_bf16 {cid} depth 0",
                                kd[0][0], fd[0][0], BF16_CONTRACT)
    out = {"tower_down_bf16": {
        "max_abs_err": max(rel_err(x, p)[0] for x, p in zip(
            states, list(pd[0]) + [pd[2]])),
        "rel_err": max(per_depth), "per_depth_rel_err": per_depth,
        "tolerance": BF16_TOL, "equals_twin": True,
        "restricted_rel_err": rest_err,
        "chain_rel_err_plain": max(rel_err(x, p)[1] for x, p in zip(
            flat(kd), flat(pd))),
        "against_f32": against, "against_f32_limit": BF16_CONTRACT,
        "outputs_against_f32": [rel_err(x, y)[1] for x, y in zip(
            flat(kd), flat(fd))]}}
    pu, pr, pb = pd
    e_bot = 0.5 * pb
    rhs_list = [f["rhs"]] + list(pr)
    up_in = [e_bot.clone()] + [t.clone() for t in list(pu) + list(pr)]
    up = lambda sp, fn: fn(sp, 0, e_bot, list(pu), rhs_list[:-1],
                           a_list[:-1])
    ku = one_launch("tower_up_bf16", lambda: up(sb, ct.tower_up))
    ref, f32 = up(sb, ct.tower_up_plain), up(spec, ct.tower_up)
    torch.cuda.synchronize()
    # tower_up has no f32 step but the prolongation's one add, which the
    # plain version makes alike: the whole chain is its twin bit for bit
    twin = ct.tower_up_plain(sb, 0, e_bot, list(pu), rhs_list[:-1],
                             a_list[:-1], _where=True)
    check(torch.equal(ku, twin), f"tower_up_bf16 {cid}: not bit for bit its "
          f"twin: {rel_err(ku, twin)}")
    check(torch.equal(up(sb, ct.tower_up), ku),
          f"tower_up_bf16 {cid}: two launches differ")
    err, rel = rel_err(ku, ref)
    check(rel <= BF16_TOL and bool(torch.isfinite(ku).all()),
          f"tower_up_bf16 {cid}: {rel} of max|plain| > {BF16_TOL}")
    out["tower_up_bf16"] = {
        "max_abs_err": err, "rel_err": rel, "tolerance": BF16_TOL,
        "equals_twin": True,
        "against_f32": check_against_f32(f"tower_up_bf16 {cid}", ku, f32,
                                         BF16_CONTRACT),
        "against_f32_limit": BF16_CONTRACT}
    check(all(torch.equal(x, y) for x, y in zip(
        inputs + up_in, [f["u"], f["rhs"]] + a_list + [e_bot] + list(pu)
        + list(pr))), f"tower_bf16 {cid}: an input was written")
    if timed:
        for name, run, plain, f32_name in (
                ("tower_down_bf16", lambda: down(sb, ct.tower_down),
                 lambda: down(sb, ct.tower_down_plain), "tower_down"),
                ("tower_up_bf16", lambda: up(sb, ct.tower_up),
                 lambda: up(sb, ct.tower_up_plain), "tower_up")):
            ref32 = f32_rec[f32_name]
            out[name].update(
                ms=time_ms(run), device_ms=device_ms(run),
                host_us=host_us(run),
                plain_ms=time_ms(plain, reps=10, warmup=1),
                bound_ms=ref32["bound_ms"], bound_by=ref32["bound_by"],
                f32_ms=ref32["ms"], f32_device_ms=ref32["device_ms"],
                f32_host_us=ref32["host_us"])
    return out


# sharded cases: (id, level shape, kinds, lo, mesh shape, shard, timed). The
# kernel runs on shard `shard` of the level cut over a mesh of cuda:0 named
# prod(mesh shape) times, with the operands the sharded path hands it
# (parallel/halo); then mg.relax on the whole level with that mesh (every
# shard, 4 sweeps as two launches of 2, joined) is held against the
# whole-level kernel. The first of each kind is the periodic box's (256^3 on
# 4 x-slabs / on (2, 2) pencils), then the 7-level hierarchy's local slabs
# (its finest level, 960x144x144, and its 64^3 base on 4 x-slabs), then odd
# offsets and mixed faces; then the cases the shard march's copies can get
# wrong: rows that do not start on 16 bytes (nz odd: one element a copy), the
# nsweeps = 2 slice of rhs and a pads built for 4 sweeps (SHARD_COEF_HMAX),
# an x-slab cut into several x segments, and a one-shard periodic x mesh
# whose seams wrap onto its own pads.
SHARD_CASES = [
    ("slab_64x256x256_P", (256, 256, 256), ALL_P, (0, 0, 0), (4,), (1, 0, 0),
     True),
    ("slab_240x144x144_edge", (960, 144, 144), ALL_C, (6080, 3952, 3952),
     (4,), (0, 0, 0), True),
    ("slab_16x64x64_edge", (64, 64, 64), ALL_D, (0, 0, 0), (4,), (3, 0, 0),
     True),
    ("slab_odd_offset", (84, 40, 36), ((P, P), (D, C), (N, C)), (1, 0, 3),
     (4,), (1, 0, 0), False),
    ("slab_mixed_seams", (96, 56, 48), ((D, C), (N, D), (C, N)), (3, 0, 8),
     (4,), (2, 0, 0), False),
    ("pencil_128x128x256_P", (256, 256, 256), ALL_P, (0, 0, 0), (2, 2),
     (1, 0, 0), True),
    ("pencil_odd_offsets", (42, 46, 36), ((D, C), (N, D), (C, N)), (1, 0, 0),
     (2, 2), (1, 1, 0), False),
    ("pencil_periodic_odd", (42, 46, 36), ALL_P, (0, 3, 0), (2, 2), (1, 0, 0),
     False),
    ("slab_misaligned_nz", (64, 40, 37), ((D, C), (N, D), (C, N)), (1, 0, 2),
     (4,), (1, 0, 0), False),
    ("pencil_misaligned_nz", (48, 44, 37), ((N, D), (D, C), (C, D)),
     (0, 1, 0), (2, 2), (1, 1, 0), False),
    ("slab_pad_slice_hmax8", (96, 56, 48), ((D, C), (N, D), (C, N)),
     (3, 0, 8), (4,), (2, 0, 0), False),
    ("slab_segments", (528, 40, 36), ((N, D), (D, C), (C, C)), (0, 1, 1),
     (4,), (1, 0, 0), False),
    ("slab_one_shard_periodic", (48, 40, 36), ALL_P, (0, 1, 0), (1,),
     (0, 0, 0), False),
    # the box at N = 240 on 4 x-slabs (phase periodic_odd): its top depth's
    # slab, and its 60^3 depth's, 15 planes a shard
    ("slab_60x240x240_P", (240, 240, 240), ALL_P, (0, 0, 0), (4,),
     (1, 0, 0), True),
    ("slab_15x60x60_P", (60, 60, 60), ALL_P, (0, 0, 0), (4,), (1, 0, 0),
     False),
]
# cases whose rhs and aCoef pads are built for a deeper chunk (h_max rows a
# side) and sliced [h_max - H, h_max + H), as halo.sharded_relax slices them
SHARD_COEF_HMAX = {"slab_pad_slice_hmax8": 8}
# reassembled sharded relax against the whole-level kernel (of max|ref|)
REASSEMBLED_TOL = {torch.float32: 2e-6, torch.float64: 1e-13}


def shard_operands(f, kinds, mshape, H: int, rho: float = 2.0,
                   h_max: int | None = None) -> dict:
    """What the sharded path hands the kernel of every shard for a chunk of
    H/2 sweeps, by shard: the shard and its pads (x-slabs) or its prepadded
    arrays (pencils), and the meta; built by parallel/halo's own helpers.
    h_max: the x-slabs' rhs and aCoef pads built h_max rows a side and
    sliced to H, as halo.sharded_relax does for chunks of mixed depth."""
    mesh = pmesh.make_mesh(["cuda:0"] * math.prod(mshape), mshape)
    counts = tuple(mshape) + (1,) * (3 - len(mshape))
    lay = shards.layout(mesh, counts)
    devs = lay.devs
    sh = {k: shards.split_dict(f[k], lay) for k in ("u", "rhs", "a")}
    n_loc = [f["u"].shape[ax] // counts[ax] for ax in range(3)]
    px = kinds[0][0] == P
    meta = halo._metas(devs, counts, n_loc, px)
    if len(mshape) == 1:
        hm = max(H, h_max or H)
        sl = slice(hm - H, hm + H)
        pads = (halo._u_rows(sh["u"], kinds, rho, H, counts[0], lay),
                halo._coef_rows(sh["rhs"], hm, counts[0], px, lay),
                halo._coef_rows(sh["a"], hm, counts[0], px, lay))
        return {k: {"u": sh["u"][k], "rhs": sh["rhs"][k], "a": sh["a"][k],
                    "pads": (pads[0][k], pads[1][k][sl], pads[2][k][sl]),
                    "meta": meta[k]}
                for k in devs}
    pre = {n: halo._prepad(sh[n], H, "ghost" if n == "u" else "zero", kinds,
                           rho, counts, lay) for n in sh}
    return {k: {"pre": (pre["u"][k], pre["rhs"][k], pre["a"][k]),
                "meta": meta[k], "ny_global": f["u"].shape[1]} for k in devs}


def shard_launch(ops: dict, loc, nsweeps: int, ms: float,
                 bound: float, compute: int = 0) -> dict:
    """The shard march's launch on one shard
    (fused_sweeps.shard_geometry_on; compute 1: the bf16 tier's form): tile
    width, x segments, steps of the longest block, rounds of blocks, the
    time of one step and the fraction of the byte bound reached, and the
    instantiation that runs (its form, a and rhs in 16-byte chunks or not,
    as the C entry reports it for these operands:
    mgk_multisweep_shard_chunked) with its registers and spill stores
    (ptxas -v)."""
    pre = "pre" in ops
    arrays = ops["pre"] if pre else (ops["u"], ops["rhs"], ops["a"],
                                     *ops["pads"])
    u = arrays[0]
    isz = u.element_size()
    tile, nseg, xseg = fs.shard_geometry_on(tuple(loc), nsweeps, isz,
                                            u.device.index, pre, compute)
    inner = tile - 4 * nsweeps
    tiles = -(-loc[1] // inner) * -(-loc[2] // inner)
    cap = fs.shard_capacity(u.device, isz, nsweeps, tile, pre, compute)
    steps = xseg + 3 * 2 * nsweeps - 1
    rounds = -(-tiles * nseg // cap)
    chunks = ctypes.c_int(0)
    cuda_ext.check(cuda_ext.lib().mgk_multisweep_shard_chunked(
        int(isz == 8), int(pre), loc[1], loc[2], nsweeps,
        *(t.data_ptr() for t in arrays), *(None,) * (3 * pre),
        ctypes.byref(chunks)), "multisweep shard chunked")
    form = (f"{'f32' if isz == 4 else 'f64'} NP{2 * nsweeps} W{tile} "
            f"V{chunks.value} {'pre' if pre else 'slab'}"
            f"{' bf16' if compute else ''}")
    return {"tile": tile, "segments": nseg, "xseg": xseg,
            "blocks": tiles * nseg, "capacity": cap,
            "steps_per_block": steps, "rounds": rounds,
            "us_per_step": 1e3 * ms / (rounds * steps),
            "fraction_of_bound": bound / ms, "form": form,
            **shard_forms(*ptxas_resources()).get(form, {})}


def check_shard_case(case, dtype) -> dict:
    """The halo kernel (x-slab) or the prepadded one (pencil) against its
    plain version on one shard, nsweeps 2 and 4; then the sharded relax of
    the whole level against the whole-level kernel."""
    cid, shape, kinds, lo, mshape, key, timed = case
    name = ("multisweep_relax_halo" if len(mshape) == 1
            else "multisweep_relax_tiled_pre")
    f = level_fields(shape, dtype, seed=4)
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37, lo=lo)
    counts = tuple(mshape) + (1,) * (3 - len(mshape))
    loc = [shape[ax] // counts[ax] for ax in range(3)]
    rec = {"case": cid, "shape": loc, "level": list(shape),
           "mesh": list(mshape), "shard": list(key), "dtype": str(dtype)[6:],
           "tolerance": TOL[dtype], name: {}}

    def call(ops, ns, kernel=True):
        if "pads" in ops:
            if kernel:
                return fs.multisweep_relax(
                    ops["u"], ops["rhs"], ops["a"], nsweeps=ns,
                    halo=ops["pads"] + (ops["meta"],), **kw)
            return fs.multisweep_relax_halo_plain(
                ops["u"], ops["rhs"], ops["a"], *ops["pads"], ops["meta"],
                nsweeps=ns, **kw)
        fn = (fs.multisweep_relax_tiled_pre if kernel
              else fs.multisweep_relax_tiled_pre_plain)
        return fn(*ops["pre"], ops["meta"], ny_global=ops["ny_global"],
                  nsweeps=ns, **kw)

    h_max = SHARD_COEF_HMAX.get(cid)
    if h_max:
        rec["coef_pad_h_max"] = h_max
    worst = (0.0, 0.0)
    for ns in fs.MULTISWEEP_CHUNKS:
        ops = shard_operands(f, kinds, mshape, 2 * ns, h_max=h_max)[key]
        before = kernel_counts.DEVICE_LAUNCHES[name]
        out = call(ops, ns)
        torch.cuda.synchronize()
        check(kernel_counts.DEVICE_LAUNCHES[name] == before + 1,
              f"{name}: not one launch per call")
        err, rel = rel_err(out, call(ops, ns, kernel=False))
        worst = max(worst, (rel, err))
        check(rel <= TOL[dtype] and bool(torch.isfinite(out).all()),
              f"{name} {cid} {dtype} nsweeps {ns}: rel err {rel}")
        check(torch.equal(call(ops, ns), out),
              f"{name} {cid} {dtype} nsweeps {ns}: two launches differ")
    rec[name].update(rel_err=worst[0], max_abs_err=worst[1],
                     meta=list(ops["meta"]), relaunch_bitwise=True)

    # 4 sweeps of the whole level as the sharded path runs them (per chunk
    # of 2: every shard's kernel on the operands parallel/halo builds,
    # joined) against the whole-level kernel (two launches of 2)
    def sharded_sweeps():
        u = f["u"]
        for _ in range(2):
            outs = {k: call(o, 2) for k, o in shard_operands(
                dict(f, u=u), kinds, mshape, 4).items()}
            u = shards.join_dict(outs, shards.layout(one_card_mesh(
                mshape), counts), u.device)
        return u

    sharded = sharded_sweeps()
    if dtype == torch.float32 and math.prod(mshape) > 1:
        # the solver's own route: mg.relax with the mesh (f32 only: the
        # kernels are the f32 preconditioner's), the same launches. A
        # one-shard mesh cuts no depth (mesh.shard_counts): the solver
        # smooths such a level with the whole-level kernel
        mesh = pmesh.make_mesh(["cuda:0"] * math.prod(mshape), mshape)
        spec = mg.LevelMGSpec(
            kinds=kinds, boxes=(Box.from_shape(shape, lo),), dx=(0.37,),
            rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4, smoother="auto",
            mesh=mesh)
        coefs = {"a": (f["a"],), "b": (None,), "lam": (None,)}
        before = kernel_counts.LAUNCHES[name]
        via_relax = mg.relax(spec, coefs, 0, f["u"], f["rhs"], 4)
        check(kernel_counts.LAUNCHES[name] - before == 2 * math.prod(mshape),
              f"{name} {cid}: the sharded relax did not launch every shard")
        check(torch.equal(via_relax, sharded),
              f"{name} {cid}: mg.relax with the mesh is not the shards' "
              f"kernels joined")
        # the resident form: u and rhs kept on their shards, aCoef cut and
        # padded once with the coefficients (mg.build_level_coefs)
        rcoefs = mg.build_level_coefs(spec, f["a"])
        u_s, r_s = (halo.split_level(spec, 0, f[k]) for k in ("u", "rhs"))
        before = dict(kernel_counts.HALO)
        resident = mg.relax(spec, rcoefs, 0, u_s, r_s, 4)
        moved = {k: v - before[k] for k, v in kernel_counts.HALO.items()}
        check(moved["level_splits"] == moved["level_joins"] == 0
              and moved["coef_splits"] == moved["coef_pad_builds"] == 0,
              f"{name} {cid}: the resident relax split or padded: {moved}")
        check(torch.equal(resident.join(), sharded),
              f"{name} {cid}: the resident relax is not the shards' kernels "
              f"joined")
        rec["resident_relax"] = {"halo": moved, "bitwise": True}
    whole = fs.multisweep_relax(f["u"], f["rhs"], f["a"], nsweeps=2, **kw)
    whole = fs.multisweep_relax(whole, f["rhs"], f["a"], nsweeps=2, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(sharded, whole)
    rec["reassembled"] = {"max_abs_err": err, "rel_err": rel,
                          "tolerance": REASSEMBLED_TOL[dtype],
                          "bitwise": bool(torch.equal(sharded, whole))}
    check(rel <= REASSEMBLED_TOL[dtype],
          f"sharded relax {cid} {dtype}: rel err {rel} against the "
          f"whole-level kernel")
    if timed:
        ops = shard_operands(f, kinds, mshape, 4)[key]
        isz = f["u"].element_size()
        nin = (math.prod(loc) + 2 * 4 * loc[1] * loc[2] if "pads" in ops
               else ops["pre"][0].numel())
        ncells = math.prod(loc)
        # read u, rhs, a with their pads once, write the shard once
        b, by = bound_ms(isz * (3 * nin + ncells), 2 * 32.0 * ncells)
        ms = time_ms(lambda: call(ops, 2))
        rec[name].update(
            nsweeps=2,
            ms=ms, **shard_launch(ops, loc, 2, ms, b),
            device_ms=device_ms(lambda: call(ops, 2)),
            host_us=host_us(lambda: call(ops, 2)),
            plain_ms=time_ms(lambda: call(ops, 2, kernel=False), reps=6,
                             warmup=1),
            bound_ms=b, bound_by=by,
            whole_level_relax_ms={
                "sharded": time_ms(sharded_sweeps, reps=6, warmup=1),
                **({"resident": time_ms(lambda: mg.relax(
                    spec, rcoefs, 0, u_s, r_s, 4), reps=6, warmup=1),
                    "per_call": time_ms(lambda: mg.relax(
                        spec, coefs, 0, f["u"], f["rhs"], 4), reps=6,
                        warmup=1)}
                   if "resident_relax" in rec else {}),
                "unsharded_two_launches": time_ms(lambda: fs.multisweep_relax(
                    fs.multisweep_relax(f["u"], f["rhs"], f["a"], nsweeps=2,
                                        **kw), f["rhs"], f["a"], nsweeps=2,
                    **kw))})
    return rec


def shard_relax(ops: dict, ns: int, kw: dict, how: str = "kernel"):
    """One shard's sweeps (shard_operands' `ops`): `how` "kernel" the
    wrapper (the halo kernel or the prepadded one), "f32" the same at the
    operands' precision, "plain" / "twin" its plain version in the bf16
    tier (twin: with the kernels' colour select); every other `how` runs
    the tier."""
    extra = {} if how == "f32" else dict(compute_dtype=BF16)
    if how == "twin":
        extra["_where"] = True
    wrapper = how in ("kernel", "f32")
    if "pads" in ops:
        if wrapper:
            return fs.multisweep_relax(
                ops["u"], ops["rhs"], ops["a"], nsweeps=ns,
                halo=ops["pads"] + (ops["meta"],), **kw, **extra)
        return fs.multisweep_relax_halo_plain(
            ops["u"], ops["rhs"], ops["a"], *ops["pads"], ops["meta"],
            nsweeps=ns, **kw, **extra)
    fn = (fs.multisweep_relax_tiled_pre if wrapper
          else fs.multisweep_relax_tiled_pre_plain)
    return fn(*ops["pre"], ops["meta"], ny_global=ops["ny_global"],
              nsweeps=ns, **kw, **extra)


def check_shard_bf16(case) -> dict:
    """The bf16 tier of the halo kernel (x-slab) or the prepadded one
    (pencil) on one shard of a SHARD_CASES level (f32; nsweeps 2 and 4):
    one launch a call, counted under its name with _bf16; bit for bit its
    twin (the plain version with the kernels' colour select), against its
    plain bf16 version (BF16_TOL) and its f32 form (BF16_CONTRACT); then 4
    sweeps of the whole level as the sharded path runs them in the tier
    (every shard's kernel per chunk of 2, joined) bit for bit the
    whole-level bf16 march (two launches of 2). Timed: its time, device
    and host time per call beside the f32 form's, the plain bf16 version's
    time, the bound and its launch (shard_launch)."""
    cid, shape, kinds, lo, mshape, key, timed = case
    name = ("multisweep_relax_halo" if len(mshape) == 1
            else "multisweep_relax_tiled_pre")
    tname = fs.tier_name(name, BF16)
    f = level_fields(shape, torch.float32, seed=4)
    kw = dict(kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37, lo=lo)
    counts = tuple(mshape) + (1,) * (3 - len(mshape))
    loc = [shape[ax] // counts[ax] for ax in range(3)]
    h_max = SHARD_COEF_HMAX.get(cid)
    worst, against = (0.0, 0.0), 0.0
    for ns in fs.MULTISWEEP_CHUNKS:
        ops = shard_operands(f, kinds, mshape, 2 * ns, h_max=h_max)[key]
        out = one_launch(tname, lambda: shard_relax(ops, ns, kw))
        torch.cuda.synchronize()
        what = f"{tname} {cid} nsweeps {ns}"
        twin = shard_relax(ops, ns, kw, "twin")
        check(torch.equal(out, twin),
              f"{what}: not bit for bit its twin: {rel_err(out, twin)}")
        err, rel = rel_err(out, shard_relax(ops, ns, kw, "plain"))
        worst = max(worst, (rel, err))
        check(rel <= BF16_TOL and bool(torch.isfinite(out).all()),
              f"{what}: {rel} of max|plain| > {BF16_TOL}")
        against = max(against, check_against_f32(
            what, out, shard_relax(ops, ns, kw, "f32"), BF16_CONTRACT))

    def sharded_sweeps():
        u = f["u"]
        for _ in range(2):
            outs = {k: shard_relax(o, 2, kw) for k, o in shard_operands(
                dict(f, u=u), kinds, mshape, 4).items()}
            u = shards.join_dict(outs, shards.layout(one_card_mesh(
                mshape), counts), u.device)
        return u

    sharded = sharded_sweeps()
    whole = f["u"]
    for _ in range(2):
        whole = fs.multisweep_relax(whole, f["rhs"], f["a"], nsweeps=2,
                                    compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    check(torch.equal(sharded, whole), f"{tname} {cid}: the shards joined "
          f"are not the whole-level bf16 march: {rel_err(sharded, whole)}")
    rec = {"case": cid, "shape": loc, "level": list(shape),
           "mesh": list(mshape), "shard": list(key), "dtype": "float32",
           tname: {"rel_err": worst[0], "max_abs_err": worst[1],
                   "tolerance": BF16_TOL, "equals_twin": True,
                   "against_f32": against,
                   "against_f32_limit": BF16_CONTRACT,
                   "joined_equals_whole_level": True}}
    if timed:
        ops = shard_operands(f, kinds, mshape, 4)[key]
        nin = (math.prod(loc) + 2 * 4 * loc[1] * loc[2] if "pads" in ops
               else ops["pre"][0].numel())
        ncells = math.prod(loc)
        b, by = bound_ms(4 * (3 * nin + ncells), 2 * 32.0 * ncells)
        run = lambda: shard_relax(ops, 2, kw)
        run32 = lambda: shard_relax(ops, 2, kw, "f32")
        ms = time_ms(run)
        rec[tname].update(
            nsweeps=2, ms=ms, **shard_launch(ops, loc, 2, ms, b, compute=1),
            device_ms=device_ms(run), host_us=host_us(run),
            f32_ms=time_ms(run32), f32_device_ms=device_ms(run32),
            f32_host_us=host_us(run32),
            plain_ms=time_ms(lambda: shard_relax(ops, 2, kw, "plain"),
                             reps=6, warmup=1),
            bound_ms=b, bound_by=by)
        rec[tname].update(f32_ratios(rec[tname]))
    return rec


def phase_kernels() -> dict:
    checks = []
    for dtype in (torch.float32, torch.float64):
        for case in LEVEL_CASES:
            checks.append(check_level_case(case, dtype))
            torch.cuda.empty_cache()
        for case in GSRB_CASES:
            checks.append(check_gsrb_case(case, dtype))
        for case in BATCH_CASES:
            if dtype == torch.float32 or case[0] in BATCH_F64:
                checks.append(check_batch_case(case, dtype))
                torch.cuda.empty_cache()
        for case in RESIDUAL_CASES:
            checks.append(check_residual_case(case, dtype))
        for case in TOWER_CASES:
            checks.append(check_tower_case(case, dtype))
        for name, (_, _, _, cases) in one_launch_kernels().items():
            for case in cases:
                if dtype == torch.float64 and case[0] in F32_ONLY_CASES:
                    continue
                checks.append(check_one_launch_case(name, case, dtype))
                torch.cuda.empty_cache()
                if dtype == torch.float32 and case[0] not in BF16_MARCH_SKIP:
                    checks.append(check_march_bf16(name, case))
                    torch.cuda.empty_cache()
        for case in SWEEP_CASES:
            checks.append(check_sweep_entry_points(case, dtype))
            torch.cuda.empty_cache()
        for case in SHARD_CASES:
            checks.append(check_shard_case(case, dtype))
            torch.cuda.empty_cache()
            if dtype == torch.float32:
                checks.append(check_shard_bf16(case))
                torch.cuda.empty_cache()
    # wrappers raise on what the kernels do not take (no silent fallback)
    u = torch.zeros((8, 8, 8), dtype=torch.float32, device="cuda")
    kw = dict(nsweeps=1, kinds=ALL_D, rho=2.0, alpha=1.0, beta=-1.0, dx=1.0,
              lo=(0, 0, 0))
    for bad in (u.to(torch.float16), u[:, :, ::2], u[:4]):
        try:
            fs.gsrb_relax(bad, u, u, **kw)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure("gsrb_relax accepted a bad operand")
    wkw = dict(kw, nsweeps=2)
    for bad_kw, bad_u in (
            (dict(wkw, kinds=((P, P), (D, D), (D, D))), u),  # periodic x
            (dict(wkw, nsweeps=3), u),
            (wkw, u.to(torch.float16)), (wkw, u[:, :, ::2])):
        try:
            wf.wavefront_relax(bad_u, u, u, **bad_kw)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure("wavefront_relax accepted a bad call")
    rkw = dict(kinds=ALL_D, rho=2.0, alpha=1.0, beta=-1.0, dx=1.0)
    for bad_u, bad_out in ((torch.zeros((8, 7, 8), device="cuda"), None),
                           (u, torch.zeros((4, 4, 8), device="cuda")),
                           (u, torch.zeros((4, 4, 8), device="cuda")[
                               :, :, ::2])):
        try:
            fs.residual_restrict(bad_u, bad_u, bad_u, out=bad_out, **rkw)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure("residual_restrict accepted a bad call")
    u7 = torch.zeros((7, 8, 8), dtype=torch.float32, device="cuda")
    for bad_kw, bad_u in (
            (dict(wkw, kinds=((P, P), (D, D), (D, D))), u7),  # odd periodic
            (dict(wkw, nsweeps=3), u),
            (wkw, u.to(torch.float16)), (wkw, u[:, :, ::2])):
        try:
            fs.multisweep_relax(bad_u, bad_u, bad_u, **bad_kw)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure("multisweep_relax accepted a bad call")
    # the shard marches' launches at the timed cases, on a line of their own
    tier = {n: " bf16" if n.endswith("_bf16") else "" for n in (
        "multisweep_relax_halo", "multisweep_relax_tiled_pre",
        "multisweep_relax_halo_bf16", "multisweep_relax_tiled_pre_bf16")}
    emit({"phase": "shard_launch", "cases": {
        f"{c['case']} {c['dtype']}{tier[n]}": {
            k: c[n][k] for k in ("tile", "segments", "xseg", "blocks",
                                 "steps_per_block", "us_per_step", "form",
                                 "D", "registers", "spill_stores")
            if k in c[n]}
        for c in checks for n in tier if "tile" in c.get(n, {})}})
    out = {"phase": "kernels",
           "kernels": list(kernel_counts.KERNELS),
           "tolerance": {"float32": TOL[torch.float32],
                         "float64": TOL[torch.float64],
                         "of": "max|reference| (4 sweeps per relaxation)"},
           "checks": checks}
    emit(out)
    return out


# ---------------------------------------------------------------- solves


SMALL_LEVEL_KERNELS = ("gsrb_relax", "residual", "residual_restrict",
                       "tower_down", "tower_up")
TOWERS = ("tower_down", "tower_up")


# kernels whose wrapper call is one kernel launch on the solve paths (the
# batched forms: groups of at most fs.BATCH_MAX patches)
ONE_LAUNCH = TOWERS + ("gsrb_relax", "residual", "residual_restrict",
                       "gsrb_relax_batch", "gsrb_relax_batch_march",
                       "residual_restrict_batch",
                       "gsrb_relax_bf16", "tower_down_bf16", "tower_up_bf16",
                       "wavefront_relax_bf16", "multisweep_relax_bf16",
                       "multisweep_relax_halo_bf16",
                       "multisweep_relax_tiled_pre_bf16",
                       "gsrb_full_sweep", "gsrb_half_sweep")


def check_one_launch(counts: dict, what: str) -> None:
    """Every tower, gsrb_relax and residual call of the run was one kernel
    launch (csrc/tower.cu, csrc/gsrb_relax.cu, csrc/residual.cu)."""
    for k in ONE_LAUNCH:
        check(counts["device_launches"][k] == counts["launches"][k],
              f"{what}: {k} is not one launch per call: "
              f"{counts['device_launches'][k]} launches in "
              f"{counts['launches'][k]} calls")


# the kernels of the canonical 7-level path (x is never periodic there)
CANONICAL_KERNELS = SMALL_LEVEL_KERNELS + ("wavefront_relax",)
# the kernels of the periodic box (its 256^3 depth is staged, 128^3 and
# below run inside the tower)
PERIODIC_KERNELS = ("multisweep_relax", "residual", "residual_restrict",
                    "tower_down", "tower_up")


def run_solve(overrides, label: str, keep: dict | None = None,
              params: str = CANONICAL, mesh=None) -> dict:
    """load_params -> generate_hierarchy -> poisson_solve on the card.
    `keep`, when given, receives cfg, geom and the solve's result."""
    cfg = mgt.load_params(params, overrides=list(overrides))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, calls, halos, reserved, k_hist = [], [], [], [], []

    def hook(nl_iter, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if nl_iter:  # the K the iteration before this one was solved with
            k_hist.append(state["constant_K"])
        calls.append(dict(kernel_counts.LAUNCHES))
        halos.append(dict(kernel_counts.HALO))
        reserved.append(torch.cuda.memory_reserved())

    t0 = time.perf_counter()
    geom = generate_hierarchy(cfg)
    t_hier = time.perf_counter() - t0
    res = poisson_solve(cfg, geom=geom, verbose=False, output_hook=hook,
                        mesh=mesh)
    torch.cuda.synchronize()
    hook(None, None)
    if keep is not None:
        keep.update(cfg=cfg, geom=geom, res=res)
    per_iter = [b - a for a, b in zip(stamps, stamps[1:])]
    # wrapper calls that reached the card, per Picard iteration, in the
    # order of kernel_counts.KERNELS
    calls_per_iter = [[b[k] - a[k] for k in kernel_counts.KERNELS]
                      for a, b in zip(calls, calls[1:])]
    for p in res.psi:
        check(p.is_cuda and p.dtype == torch.float64, "psi not f64 on cuda")
        check(bool(torch.isfinite(p).all()), "psi not finite")
        check(0.5 < float(p.min()) and float(p.max()) < 2.0,
              "psi out of range")
    return {
        "label": label, "overrides": list(overrides),
        "levels": [list(b.shape) for b in geom.boxes],
        "history": res.dpsi_norm_history, "linear_iters": res.linear_iters,
        "linear_residuals": res.linear_residuals,
        "constant_K": res.constant_K, "converged": res.converged,
        "K_history": k_hist + [res.constant_K], "hierarchy_s": t_hier,
        "s_per_iteration": per_iter,
        "kernel_order": list(kernel_counts.KERNELS),
        "kernel_calls_per_iteration": calls_per_iter,
        # splits, joins, pads and bytes of the sharded path per iteration
        # (kernel_counts.HALO; zero without a mesh)
        "halo_per_iteration": [{k: b[k] - a[k] for k in a}
                               for a, b in zip(halos, halos[1:])],
        "memory_reserved_per_iteration": reserved[1:],
        "total_s": time.perf_counter() - t0,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


# the solve phase's configuration (the bf16_tier phase's with average_down)
SOLVE_BASE = ["max_level = 3", "precond_precision = single", "verbosity = 0"]


def phase_solve() -> dict:
    base = SOLVE_BASE
    kernel_counts.reset()
    main = run_solve(base, "main")
    counts = kernel_counts.snapshot()  # the main path's run, nothing else
    h, it = main["history"], main["linear_iters"]
    check(main["levels"] == [list(s) for s in SCALE7_SHAPES[:4]],
          f"unexpected hierarchy {main['levels']}")
    check(all(counts["launches"][k] > 0 for k in SMALL_LEVEL_KERNELS),
          f"a kernel was never launched: {counts}")
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"a plain version ran on the card's path: {counts}")
    check_one_launch(counts, "solve")
    check_residual_calls(main, "solve")
    check(h[0] > h[1] > h[2], f"history not decreasing: {h}")
    check(all(i <= 4 for i in it), f"linear iters {it}")
    staged = run_solve(base + ["smoother = xla", "max_NL_iterations = 2"],
                       "staged")
    rel = abs(staged["history"][0] - h[0]) / h[0]
    check(rel <= 1e-6, f"staged smoother first step differs: {rel}")
    n_iter = len(h)
    out = {
        "phase": "solve", "main": main, "staged_first_step":
        staged["history"][0], "staged_rel_diff": rel,
        "staged_s_per_iteration": staged["s_per_iteration"],
        # launches = wrapper calls that reached the card; each enqueues
        # several kernel launches from one C call (device_launches)
        "launches": counts["launches"],
        "device_launches": counts["device_launches"],
        "plain_calls": counts["plain_calls"],
        "launches_per_picard_iteration": {
            k: v / n_iter for k, v in counts["launches"].items()},
    }
    emit(out)
    return out


def phase_lock3() -> dict:
    run = run_solve(["max_level = 2", "precond_precision = single",
                     "verbosity = 0"], "lock3")
    h = run["history"]
    rel = abs(h[0] - LOCK3_FIRST) / LOCK3_FIRST
    check(rel <= 1e-6, f"3-level first step {h[0]} vs {LOCK3_FIRST}")
    check(min(h) < 5e-8, f"3-level plateau {min(h)}")
    out = {"phase": "lock3", "first_step_rel_diff": rel, "plateau": min(h),
           **run}
    emit(out)
    return out


def phase_split(cfg, geom, psi, reps: int = 2) -> dict:
    """Seconds per phase of one steady Picard iteration from `psi`, each
    phase timed to completion on the card (profiling.scope(block=True)):
    prepare (aCoef, rhs), coefs (depth chains, bottom inverse), ONE
    composite operator application, ONE preconditioner application, ONE
    composite max-norm, the whole linear solve, finish (update + norm).
    One warm pass first; the mean of `reps` passes after it."""
    device = psi[0].device
    spec = comp.make_amr_spec(geom, cfg, device)
    fields = [ld.problem_fields(geom, cfg, l, psi[0].dtype, device)
              for l in range(geom.num_levels)]
    dpsi = [torch.zeros_like(p) for p in psi]
    tree = profiling.TimerTree()
    iters = []
    for rep in range(reps + 1):
        if rep == 1:
            tree.reset()
        with tree.scope("prepare", block=True):
            a_list, rhs_list, _ = nl.prepare_iteration(geom, cfg, fields, psi)
        with tree.scope("coefs", block=True):
            coefs = comp.build_coefs(spec, a_list)
        with tree.scope("apply", block=True):
            comp.composite_apply(spec, coefs, rhs_list)
        with tree.scope("precond", block=True):
            comp.precond(spec, coefs, rhs_list)
        with tree.scope("norm", block=True):
            red.composite_max_norm(rhs_list, geom=geom)
        with tree.scope("solve", block=True):
            out = comp.solve_linear(spec, coefs, rhs_list, dpsi)
        with tree.scope("finish", block=True):
            nl.finish_iteration(geom, psi, out.x, cfg.average_down)
        iters.append(int(out.iters))
    ph = {k: v.total / v.count for k, v in tree.root.children.items()}
    n_it = iters[-1]
    # BiCGStab: two operator and two preconditioner applications and about
    # four reductions per iteration, plus the initial residual
    explained = n_it * (2 * ph["apply"] + 2 * ph["precond"]
                        + 4 * ph["norm"]) + ph["apply"]
    return {
        "phases_s": ph, "krylov_iters": iters,
        "iteration_s": ph["prepare"] + ph["coefs"] + ph["solve"]
        + ph["finish"],
        "solve_explained_s": explained,
        "solve_unexplained_s": ph["solve"] - explained,
    }


# wrapper calls of the residual's two forms per preconditioner application
# (two a Krylov iteration): each refined level restricts its residual into
# its parent once a V-cycle (residual_restrict), the composite residual
# between the two V-cycles takes every level whole and the bottom solve of
# each V-cycle its depth (residual); the periodic box restricts its staged
# 256^3 depth once a V-cycle
RESIDUAL_CALLS = {"solve": {"residual": 4 + 2, "residual_restrict": 2 * 3},
                  "periodic": {"residual": 1 + 2, "residual_restrict": 2}}


def check_residual_calls(run: dict, what: str,
                         per_application: dict | None = None) -> None:
    """Every Picard iteration made RESIDUAL_CALLS[what] (or
    `per_application`) calls of each form of the residual per
    preconditioner application."""
    per_application = per_application or RESIDUAL_CALLS[what]
    for calls, krylov in zip(run["kernel_calls_per_iteration"],
                             run["linear_iters"]):
        for name, n in per_application.items():
            got = calls[kernel_counts.KERNELS.index(name)]
            check(got == 2 * krylov * n,
                  f"{what}: {got} {name} calls in an iteration of {krylov} "
                  f"Krylov iterations, not {2 * krylov * n}")


def batched_groups_of(spec) -> list:
    """The batch groups (AMRSolverSpec.batch_groups) that amr_vcycle runs
    as batches, bCoef constant: those the mesh cuts no patch of
    (composite._group_batchable)."""
    return [g for g in spec.batch_groups
            if all(mg._shard_counts(spec.level_specs[x], 0) == UNCUT
                   for x in g)]


def batch_calls_of(spec, group) -> int:
    """Wrapper calls of a batched kernel per batched call of `group`: one
    on the home, or one per mesh position the group is spread over
    (composite.batch_positions)."""
    pos = comp.batch_positions(spec, group)
    return 1 if pos is None else len(set(pos))


def batch_kernel_calls_of(spec) -> dict:
    """gsrb_relax_batch's wrapper calls per preconditioner application
    (relax_calls_of) by the counter each goes to (batch_kernel): the batch
    march's where the patches of the call take it (fs.batch_takes_march;
    a call takes the group on the home, or its patches at one mesh
    position), gsrb_relax_batch's elsewhere."""
    out = {"gsrb_relax_batch": 0, "gsrb_relax_batch_march": 0}
    for g in batched_groups_of(spec):
        ls = spec.level_specs[g[0]]
        shape = ls.boxes[0].shape
        pos = comp.batch_positions(spec, g)
        sizes = ([len(g)] if pos is None else
                 [pos.count(p) for p in sorted(set(pos))])
        for kind, s in mg.plan_for(ls, shape, torch.float32, "cuda",
                                   spec.nsmooth):
            if kind != "resident":
                continue
            for n in sizes:
                march = fs.batch_takes_march(shape, 4, False, ls.kinds, n, s)
                out[batch_kernel("march" if march else "grid")] += \
                    2 * spec.num_mg_iterations
    return out


def relax_calls_of(spec) -> dict:
    """Wrapper calls of the relax kernels per preconditioner application,
    by kernel and level shape ("nx x ny x nz"), on a hierarchy whose base
    chain runs in the towers: every refined entry relaxes twice a V-cycle
    (the downsweep and the post-smooth with CF ghosts), each relax the
    launches relax_kernel_plan gives its shape at f32 on the card; a batch
    group (batched_groups_of) as a group: gsrb_relax_batch's calls
    (batch_calls_of) where its shape takes gsrb_relax, one march launch per
    patch where it takes the march (gsrb_relax_batch only where there is
    a group)."""
    kernel = {"resident": "gsrb_relax", "wave": "wavefront_relax",
              "multisweep": "multisweep_relax"}
    out: dict = {name: {} for name in kernel.values()}
    groups = batched_groups_of(spec)
    if groups:
        out["gsrb_relax_batch"] = {}
    grouped = {x: g for g in groups for x in g}
    for e in range(1, spec.num_levels):
        g = grouped.get(e)
        if g is not None and e != g[0]:
            continue  # counted with its group's first patch
        ls = spec.level_specs[e]
        shape = ls.boxes[0].shape
        key = "x".join(map(str, shape))
        for kind, _ in mg.plan_for(ls, shape, torch.float32, "cuda",
                                   spec.nsmooth):
            name, n = kernel[kind], 1
            if g is not None:
                name, n = (("gsrb_relax_batch", batch_calls_of(spec, g))
                           if kind == "resident" else (name, len(g)))
            calls = out[name]
            calls[key] = calls.get(key, 0) + 2 * spec.num_mg_iterations * n
    return out


def residual_calls_of(spec) -> dict:
    """RESIDUAL_CALLS for any hierarchy whose base chain goes into the
    tower at its top depth: the composite residual between V-cycles takes
    every entry whole and each V-cycle's bottom solve its depth (residual);
    every refined entry restricts its residual into its parent once a
    V-cycle (residual_restrict), a batch group in its batched calls
    (residual_restrict_batch, batch_calls_of; only where there is a
    group)."""
    geom, nmg = spec.geom, spec.num_mg_iterations
    entries = sum(len(geom.entries_at_depth(d))
                  for d in range(geom.max_depth + 1))
    groups = batched_groups_of(spec)
    out = {"residual": (nmg - 1) * entries + nmg,
           "residual_restrict": nmg * (entries - 1 - sum(map(len, groups)))}
    if groups:
        out["residual_restrict_batch"] = nmg * sum(
            batch_calls_of(spec, g) for g in groups)
    return out


UNCUT = (1, 1, 1)


def _cut_pairs(spec) -> list:
    """The refined entries that read or write another level by level
    windows: those whose level or parent the mesh cuts at depth 0, each
    with whether it has coarse-fine faces (cf_interp.cf_faces)."""
    geom = spec.geom
    cut = [mg._shard_counts(ls, 0) != UNCUT for ls in spec.level_specs]
    return [(l, bool(cfi.cf_faces(geom, l)))
            for l in range(1, spec.num_levels)
            if cut[l] or cut[geom.parent[l]]]


def _placed_groups(spec) -> list:
    """The batch groups computed at mesh positions
    (composite.batch_positions), bCoef constant."""
    return [g for g in batched_groups_of(spec)
            if comp.batch_positions(spec, g) is not None]


def shard_traffic_of(spec, const_b: bool = True) -> dict:
    """Splits, joins and level windows (kernel_counts.HALO) per
    preconditioner application of a hierarchy on a mesh, from its cuts
    (multigrid._shard_counts) alone. The AMR levels split and join nothing:
    a cut level comes in and goes out as its shards. What splits and joins
    is the base level's depth chain: no split or join between two cut
    depths with equal counts; where the next depth is cut otherwise or not
    at all, the restricted residual is joined (1) and the correction under
    the shards split (1), and a cut depth taken up whole splits its u and
    rhs and joins its result (2, 1) at every visit (num_mg per visit of
    the depth above); a cut bottom depth is solved whole (3 joins, 3
    splits, its residual split and joined per call). Level windows: per
    V-cycle every refined entry whose level or parent is cut writes its
    restricted residual into the parent (1), reads the coarse correction
    under it (1) and, where it has coarse-fine faces, the faces' coarse
    planes of its post-smooth (1); between two V-cycles the composite
    residual's coarse-fine term reads them again (1). A batch group
    computed at mesh positions (_placed_groups) moves its patches there
    and back once a V-cycle (2 patch_moves), and each of its patches
    writes, reads and reads planes as a cut pair does (2 + 1 level windows
    per V-cycle) but never between V-cycles (its correction is whole on
    the home there). No coefficient is split or joined and no pad
    built."""
    s = j = 0

    def chain(ls, d, resident, visits):
        nonlocal s, j
        c = mg._shard_counts(ls, d)
        if c == UNCUT:
            return
        if not resident:
            s, j = s + 2 * visits, j + visits
        if d + 1 == ls.ndepths:
            check(mg._use_direct_bottom(ls),
                  "shard_traffic_of: a cut bottom depth without the direct "
                  "solve")
            s, j = s + 3 * visits, j + 3 * visits
            return
        same = mg._shard_counts(ls, d + 1) == c
        if not same:
            s, j = s + visits, j + visits
        chain(ls, d + 1, same, visits * max(ls.num_mg, 1))

    chain(spec.level_specs[0], 0, True, 1)
    pairs = _cut_pairs(spec)
    per_cycle = sum(2 + cf for _, cf in pairs)
    between = sum(cf for _, cf in pairs)
    in_pairs = {l for l, _ in pairs}
    placed = _placed_groups(spec) if const_b else []
    per_cycle += sum(2 + bool(cfi.cf_faces(spec.geom, x))
                     for g in placed for x in g if x not in in_pairs)
    m = spec.num_mg_iterations
    return {"level_splits": m * s, "level_joins": m * j,
            "level_windows": m * per_cycle + (m - 1) * between,
            "coef_splits": 0, "coef_joins": 0, "coef_pad_builds": 0,
            "patch_moves": m * 2 * len(placed)}


def picard_windows_of(spec, krylov: int, average_down: bool = False) -> int:
    """Level windows of one Picard iteration outside the preconditioner:
    every refined entry whose level or parent is cut and that has
    coarse-fine faces reads the faces' coarse planes once in each ghosted
    psi of prepare_iteration (two on a periodic domain: K's integrand and
    the rhs), in the initial residual and in each of BiCGStab's two
    operator applications a Krylov iteration; with average_down every such
    entry writes its restriction into its parent once."""
    pairs = _cut_pairs(spec)
    n_cf = sum(cf for _, cf in pairs)
    prepare = 2 if spec.geom.bc.periodic else 1
    return (prepare + 1 + 2 * krylov) * n_cf + (
        len(pairs) if average_down else 0)


HALO_DERIVED = ("level_splits", "level_joins", "level_windows",
                "coef_splits", "coef_joins", "coef_pad_builds",
                "patch_moves")
# what poisson_solve joins of each cut level at its end: psi, dpsi and the
# ten physics field arrays (phi, rho_grad, the six A_ij, A^2, psi_bh)
RESULT_ARRAYS = 12


def result_joins_of(spec) -> int:
    """Level joins of a sharded solve's result (after its last
    iteration): every array of NLResult of every level the mesh cuts."""
    return RESULT_ARRAYS * sum(mg._shard_counts(ls, 0) != UNCUT
                               for ls in spec.level_specs)


def check_halo_counts(run: dict, spec, what: str,
                      average_down: bool = False) -> dict:
    """Every Picard iteration of a sharded run split, joined, windowed, cut
    and padded exactly what one coefficient build (shard_coef_builds_of),
    two preconditioner applications per Krylov iteration
    (shard_traffic_of) and the composite operator, the prepare and the
    finish of the iteration (picard_windows_of) imply, and after the last
    one the result's joins (result_joins_of); returns the parts."""
    build, app = shard_coef_builds_of(spec), shard_traffic_of(spec)
    last = len(run["linear_iters"]) - 1
    for i, (got, krylov) in enumerate(zip(run["halo_per_iteration"],
                                          run["linear_iters"])):
        want = {k: build.get(k, 0) + 2 * krylov * app.get(k, 0)
                for k in HALO_DERIVED}
        want["level_windows"] += picard_windows_of(spec, krylov,
                                                   average_down)
        if i == last:
            want["level_joins"] += result_joins_of(spec)
        check({k: got[k] for k in want} == want,
              f"{what}: halo counts {got} in an iteration of {krylov} "
              f"Krylov iterations, the hierarchy implies {want}")
    return {"per_build": build, "per_application": app,
            "result_joins": result_joins_of(spec),
            "picard_windows_per_iteration": [
                picard_windows_of(spec, k, average_down)
                for k in run["linear_iters"]]}


def shard_coef_builds_of(spec, device_type: str = "cuda",
                         const_b: bool = True) -> dict:
    """Coefficient splits, joins and pad builds of one composite.build_coefs
    on a mesh. aCoef (and a variable bCoef) arrive on the shards, so depth
    0 cuts nothing; the chain below is coarsened on the shards and, where
    a depth is cut otherwise than the one above, resharded: one join of
    each array, and one split where the new depth is cut. A cut bottom
    depth joins its a, lambda (and b) for the dense inverse, and each
    coefficient set then cuts it as coefficients that arrive whole: aCoef,
    and lambda (and b) for the plain sharded ops. Pads: per depth the
    mesh cuts, in the f32 set of a mixed-precision preconditioner, the
    halo kernels' aCoef pads where they run (f32 with kernels allowed, a
    constant bCoef, z not cut, nsmooth a multiple of the kernels' chunk,
    no odd periodic extent). Each batch group computed at mesh positions
    places its patches' aCoef and lambda there once per coefficient set
    (one patch move each)."""
    out = {"coef_splits": 0, "coef_joins": 0, "coef_pad_builds": 0,
           "patch_moves": 0}
    arrays = 1 if const_b else 2
    dtypes = [torch.float64] + (
        [torch.float32] if spec.precond_dtype == "float32" else [])
    if const_b:
        out["patch_moves"] = len(_placed_groups(spec)) * len(dtypes)
    for ls in spec.level_specs:
        cuts = [mg._shard_counts(ls, d) for d in range(ls.ndepths)]
        for d in range(1, ls.ndepths):
            if cuts[d - 1] != UNCUT and cuts[d] != cuts[d - 1]:
                out["coef_joins"] += arrays
                out["coef_splits"] += arrays if cuts[d] != UNCUT else 0
        whole_bottom = cuts[-1] != UNCUT and mg._use_direct_bottom(ls)
        if whole_bottom:
            out["coef_joins"] += 1 + arrays
        for dtype in dtypes:
            for d in range(ls.ndepths):
                counts = cuts[d]
                if counts == UNCUT:
                    continue
                kernel = (const_b and counts[2] == 1
                          and mg._kernels_allowed_for(ls, dtype, device_type)
                          and fs.sharded_plan(tuple(ls.boxes[d].shape),
                                              ls.nsmooth, ls.kinds))
                out["coef_pad_builds"] += 1 if kernel else 0
                if whole_bottom and d == ls.ndepths - 1:
                    out["coef_splits"] += 1 + (0 if kernel else 1) + (
                        0 if const_b else 1)
    return out


def check_route(run: dict, counts: dict, spec, what: str) -> None:
    """The kernels of a run on the canonical hierarchy (scale7, records):
    each relax kernel called at each level shape as often as the hierarchy
    and the Krylov counts imply (relax_calls_of), the residual's two forms
    likewise (residual_calls_of), the same calls in every iteration of
    equal Krylov count; every kernel those imply and the towers launched
    and no other, each tower, gsrb_relax and residual call one launch; no
    plain version."""
    apps = 2 * sum(run["linear_iters"])
    want = {name: {k: n * apps for k, n in calls.items()}
            for name, calls in relax_calls_of(spec).items()}
    by_shape = {k: v for k, v in counts["by_shape"].items()
                if v or k in want}
    check(by_shape == want,
          f"{what}: relax calls by shape {counts['by_shape']}, the "
          f"hierarchy implies {want}")
    check(ct.tower_supported(
        spec.level_specs[0], {"b": (None,) * spec.level_specs[0].ndepths},
        0), f"{what}: the base chain does not start in the tower")
    # gsrb_relax_batch's calls by the kernel each launches
    launched = (set(SMALL_LEVEL_KERNELS)
                | {k for k, v in want.items()
                   if v and k != "gsrb_relax_batch"}
                | {k for k, n in batch_kernel_calls_of(spec).items() if n})
    if residual_calls_of(spec).get("residual_restrict_batch"):
        launched.add("residual_restrict_batch")
    check(all(counts["launches"][k] > 0 for k in launched)
          and all(counts["launches"][k] == 0 for k in kernel_counts.KERNELS
                  if k not in launched),
          f"{what}: kernels launched {counts['launches']}, the path takes "
          f"{sorted(launched)}")
    check(counts["device_launches"]["wavefront_relax"]
          == counts["launches"]["wavefront_relax"],
          f"{what}: wavefront_relax is not one launch per call")
    check_one_launch(counts, what)
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"{what}: a plain version ran on the card's path: {counts}")
    by_iters: dict = {}
    for calls, n_it in zip(run["kernel_calls_per_iteration"],
                           run["linear_iters"]):
        by_iters.setdefault(n_it, set()).add(tuple(calls))
    check(all(len(v) == 1 for v in by_iters.values()),
          f"{what}: kernel calls differ between iterations of equal Krylov "
          f"count: {run['kernel_calls_per_iteration']}")
    check_residual_calls(run, what, residual_calls_of(spec))


def wave_plan_table() -> dict:
    """Which rung relax_kernel_plan gives each level shape of the 7-level
    hierarchy (and the 256^3 bench level) for 4 sweeps of an f32 level on
    the card; the two biggest and 256^3 must take the wavefront."""
    spec = chain_spec((64, 64, 64), (0, 0, 0), ALL_C, dx0=0.1)
    table = {}
    for shape in SCALE7_SHAPES + [(256, 256, 256)]:
        plan = mg.plan_for(spec, shape, torch.float32, "cuda", 4)
        table["x".join(map(str, shape))] = plan
        if shape in SCALE7_SHAPES[-2:] + [(256, 256, 256)]:
            check(plan and plan[0][0] == "wave", f"{shape} not on the wave rung")
    return table


@contextlib.contextmanager
def calls_by_shape(names=("gsrb_relax", "wavefront_relax",
                          "multisweep_relax", "gsrb_relax_batch")):
    """Counts the calls of the named relax (or residual) wrappers by level
    shape while the block runs (the wrappers the solver reaches through
    their modules; a batched wrapper by its patches' shape); yields {name:
    {"nx x ny x nz": calls}}."""
    mods = {"gsrb_relax": fs, "wavefront_relax": wf, "multisweep_relax": fs,
            "residual": fs, "residual_restrict": fs, "gsrb_relax_batch": fs,
            "residual_restrict_batch": fs}
    seen: dict = {n: {} for n in names}
    saved = {n: getattr(mods[n], n) for n in names}

    def counted(name, fn):
        def call(u, *args, **kw):
            shape = u[0].shape if isinstance(u, (list, tuple)) else u.shape
            key = "x".join(map(str, shape))
            seen[name][key] = seen[name].get(key, 0) + 1
            return fn(u, *args, **kw)
        return call

    for n in names:
        setattr(mods[n], n, counted(n, saved[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(mods[n], n, saved[n])


def phase_scale7() -> dict:
    keep: dict = {}
    kernel_counts.reset()
    with calls_by_shape() as by_shape:
        run = run_solve(["max_level = 6", "max_NL_iterations = 3",
                         "precond_precision = single", "verbosity = 0"],
                        "scale7", keep)
    counts = kernel_counts.snapshot()  # the full-depth path, nothing else
    h, it = run["history"], run["linear_iters"]
    check(run["levels"] == [list(s) for s in SCALE7_SHAPES],
          f"unexpected hierarchy {run['levels']}")
    rel1 = abs(h[0] - SCALE7[0]) / SCALE7[0]
    rel2 = abs(h[1] - SCALE7[1]) / SCALE7[1]
    check(rel1 <= 1e-5, f"7-level step 1 {h[0]} vs {SCALE7[0]}")
    check(rel2 <= 2e-2, f"7-level step 2 {h[1]} vs {SCALE7[1]}")
    check(h[2] < 1e-6, f"7-level step 3 {h[2]}")
    check(all(i <= 3 for i in it), f"7-level linear iters {it}")
    check_route(run, dict(counts, by_shape=by_shape),
                comp.make_amr_spec(keep["geom"], keep["cfg"]), "scale7")
    split = phase_split(keep["cfg"], keep["geom"], keep["res"].psi)
    keep.clear()
    torch.cuda.empty_cache()
    emit({"phase": "scale7_split", **split})
    out = {"phase": "scale7", "step1_rel_diff": rel1, "step2_rel_diff": rel2,
           "launches": counts["launches"],
           "device_launches": counts["device_launches"],
           "plain_calls": counts["plain_calls"],
           "relax_plan_4_sweeps": wave_plan_table(), "split": split,
           # wrapper calls by level shape over the run's Picard iterations
           "relax_calls_by_shape": by_shape, **run}
    emit(out)
    return out


# --------------------------------------------------------------- records

# the recorded histories of the canonical configuration at max_level = 6
# (docs/): the plain run in f64 on a CPU, and the two average_down runs
# (bounding box, patches), each converged below 1e-10 at entry 8 with an f32
# preconditioner
RECORDS = {"plain": "canonical_7level_result.json",
           "avgdown": "canonical_7level_avgdown_result.json",
           "patches_avgdown": "canonical_7level_patches_avgdown_result.json"}
RECORDS_BASE = ["max_level = 6", "verbosity = 0"]
# entries 4-6 of the plain run with the f32 preconditioner: a flat plateau
# (max / min <= PLATEAU7_FLAT) in a range that brackets the recorded f32
# plateau (1.586e-7, docs/canonical_7level_tpu_result.json), the f64 one
# (1.822e-7) and this path's own. The plateau is what the covered coarse
# cells, which no norm sees and only average_down resets, carry from the
# first steps: an f32 preconditioner's rounding of them moves it. On an
# H100 the kernels read 1.3146e-7, the same f32 preconditioner with
# smoother = xla (no kernel) 2.0187e-7, the f64 one 1.8218e-7 (the f64
# record to 4e-6): scripts/records_probe.py. The low end is 5 % below the
# kernels' reading, the margin the high end keeps above the f64 record.
PLATEAU7 = (1.25e-7, 1.92e-7)
PLATEAU7_FLAT = 1.01
# the patches runs: the base and three single levels (SCALE7_SHAPES[:4]),
# then three sibling patches at each of depths 4-6
PATCHES = ["level_decomposition = patches", "average_down = 1",
           "max_NL_iterations = 12", "precond_precision = single"]


# the records phase's patches run (sequential: forest_batching = auto, no
# mesh), which the forest_batching phase holds its batched run to
RECORDS_PATCHES: dict = {}
# the forest_batching phase's run: the records' patches configuration with
# its same-shape sibling patches swept as batches
FOREST_FORCE = PATCHES + ["forest_batching = force"]


def record(name: str) -> dict:
    with open(os.path.join(ROOT, "docs", RECORDS[name])) as f:
        return json.load(f)


def levels_by_depth(geom) -> list:
    """Entry shapes per refinement depth, the `levels` of a record."""
    return [[list(geom.boxes[e].shape) for e in geom.entries_at_depth(d)]
            for d in range(geom.max_depth + 1)]


def records_solve(overrides, label: str) -> tuple:
    """run_solve at max_level = 6 with the counters and the relax calls by
    shape of that run alone; its AMR spec, for what the run implies."""
    keep: dict = {}
    kernel_counts.reset()
    with calls_by_shape() as by_shape:
        run = run_solve(RECORDS_BASE + list(overrides), label, keep)
    counts = dict(kernel_counts.snapshot(), by_shape=by_shape)
    spec = comp.make_amr_spec(keep["geom"], keep["cfg"])
    run["levels_by_depth"] = levels_by_depth(keep["geom"])
    keep.clear()
    torch.cuda.empty_cache()
    return run, counts, spec


def check_avgdown_record(run: dict, rec: dict, first: float,
                         what: str) -> dict:
    """An average_down run against its record: the record's boxes depth by
    depth, entry 1 within 1e-5 of `first`, entries 2-4 within 2 %, entry 7
    at most 5e-10, converged below 1e-10 by entry 8, each Krylov count
    within one of the record's."""
    h, it, ref = run["history"], run["linear_iters"], rec["history"]
    check(run["levels_by_depth"] == rec["levels"],
          f"{what}: boxes {run['levels_by_depth']}, recorded {rec['levels']}")
    out = {"step1_rel_diff": abs(h[0] - first) / first,
           "steps2_4_rel_diff": [abs(a - b) / b
                                 for a, b in zip(h[1:4], ref[1:4])],
           "recorded_history": ref, "recorded_linear_iters":
           rec["linear_iters"]}
    check(out["step1_rel_diff"] <= 1e-5, f"{what}: step 1 {h[0]} vs {first}")
    check(len(h) >= 4 and max(out["steps2_4_rel_diff"]) <= 2e-2,
          f"{what}: steps 2-4 {h[1:4]} vs {ref[1:4]}")
    check(len(h) < 7 or h[6] <= 5e-10, f"{what}: entry 7 {h[6:7]}")
    check(run["converged"] and len(h) <= 8 and h[-1] < 1e-10,
          f"{what}: not converged below 1e-10 by entry 8: {h}")
    check(all(abs(a - b) <= 1 for a, b in zip(it, rec["linear_iters"])),
          f"{what}: Krylov {it} vs recorded {rec['linear_iters']}")
    return out


def patch_plan_table(spec) -> dict:
    """The rung relax_kernel_plan gives each refined entry's shape, 4
    sweeps of an f32 level on the card."""
    return {"x".join(map(str, spec.geom.boxes[e].shape)): mg.plan_for(
        spec.level_specs[e], spec.geom.boxes[e].shape, torch.float32,
        "cuda", 4) for e in range(1, spec.num_levels)}


def phase_records() -> dict:
    plain_rec = record("plain")
    ref = plain_rec["history"]
    out = {"phase": "records", "records": {
        k: os.path.join("docs", v) for k, v in RECORDS.items()}}

    # 1. the plain 7 levels at the f32 preconditioner, to the plateau
    run, counts, spec = records_solve(
        ["max_NL_iterations = 6", "precond_precision = single"], "plain_f32")
    h = run["history"]
    check(run["levels"] == plain_rec["levels"],
          f"plain_f32: hierarchy {run['levels']}")
    check(len(h) == 6, f"plain_f32: {len(h)} entries: {h}")
    rel = [abs(a - b) / b for a, b in zip(h, ref)]
    check(rel[0] <= 1e-5 and rel[1] <= 2e-2 and h[2] < 1e-6,
          f"plain_f32: steps 1-3 {h[:3]} vs {ref[:3]}")
    plateau = h[3:6]
    check(all(PLATEAU7[0] <= x <= PLATEAU7[1] for x in plateau)
          and max(plateau) / min(plateau) <= PLATEAU7_FLAT,
          f"plain_f32: plateau {plateau} not flat in {PLATEAU7}")
    check(all(i <= 3 for i in run["linear_iters"]),
          f"plain_f32: Krylov {run['linear_iters']}")
    check_route(run, counts, spec, "plain_f32")
    out["plain_f32"] = {"rel_diff": rel, "plateau_max_over_min":
                        max(plateau) / min(plateau), **counts, **run}

    # 2. the same with the f64 preconditioner (no kernel: the staged body),
    # against the f64 record
    run, counts, _ = records_solve(
        ["max_NL_iterations = 6", "precond_precision = double"], "plain_f64")
    h, it = run["history"], run["linear_iters"]
    rel = [abs(a - b) / b for a, b in zip(h, ref)]
    check(len(h) == 6 and max(rel[:2]) <= 1e-7 and max(rel[2:]) <= 1e-3,
          f"plain_f64: {h} vs {ref}: {rel}")
    check(it[:3] == plain_rec["linear_iters"][:3]
          and all(abs(a - b) <= 1 for a, b in
                  zip(it[3:], plain_rec["linear_iters"][3:])),
          f"plain_f64: Krylov {it} vs {plain_rec['linear_iters']}")
    out["plain_f64"] = {"rel_diff": rel, **counts, **run}
    # the data of the choice precond_precision = auto makes on the card
    out["precond_precision"] = {
        p: {k: out[f"plain_{p}"][k] for k in (
            "s_per_iteration", "linear_iters", "max_memory_allocated",
            "hierarchy_s", "total_s")} for p in ("f32", "f64")}

    # 3. bounding box + average_down
    rec = record("avgdown")
    run, counts, spec = records_solve(
        ["average_down = 1", "max_NL_iterations = 9",
         "precond_precision = single"], "bbox_avgdown")
    agree = check_avgdown_record(run, rec, ref[0], "bbox_avgdown")
    check_route(run, counts, spec, "bbox_avgdown")
    out["bbox_avgdown"] = {**agree, **counts, **run}

    # 4. patches + average_down, then the staged smoother (no kernel) as
    # the arbiter of the kernels' arithmetic on the forest
    rec = record("patches_avgdown")
    run, counts, spec = records_solve(PATCHES, "patches_avgdown")
    agree = check_avgdown_record(run, rec, rec["history"][0],
                                 "patches_avgdown")
    check_route(run, counts, spec, "patches_avgdown")
    RECORDS_PATCHES.update(run=run, by_shape=counts["by_shape"])
    staged = run_solve(RECORDS_BASE + PATCHES + [
        "smoother = xla", "max_NL_iterations = 2"], "patches_staged")
    srel = abs(staged["history"][0] - run["history"][0]) / run["history"][0]
    check(srel <= 1e-5, f"patches: staged smoother step 1 differs: {srel}")
    out["patches_avgdown"] = {
        **agree, "staged_first_step": staged["history"][0],
        "staged_rel_diff": srel, "staged_linear_iters":
        staged["linear_iters"], "staged_s_per_iteration":
        staged["s_per_iteration"], "relax_plan_4_sweeps":
        patch_plan_table(spec), "residual_calls_per_application":
        residual_calls_of(spec), **counts, **run}
    out["runs"] = {"patches": counts}
    emit(out)
    return out


def sequential_calls_of(spec) -> dict:
    """What relax_calls_of / residual_calls_of give the same hierarchy
    with every entry on its own (forest_batching = off), per
    preconditioner application: the calls a batched run replaces."""
    import dataclasses

    seq = dataclasses.replace(spec, batch_groups=())
    return {"gsrb_relax": sum(relax_calls_of(seq)["gsrb_relax"].values()),
            "residual_restrict": residual_calls_of(seq)["residual_restrict"]}


def phase_forest_batching() -> dict:
    """The records' patches configuration (PATCHES: 13 entries, the
    same-shape pairs at depths 4-6) with forest_batching = force: each pair
    swept by the batched kernels, one launch for the pair
    (gsrb_relax_batch, residual_restrict_batch). Held to the record as the
    records phase holds the sequential run (check_avgdown_record), to the
    route and the wrapper calls its batch groups imply (check_route: every
    single and batched call by shape, no plain version), and, where the
    records phase ran in the same call, bit for bit to that phase's
    sequential run (history, Krylov counts, K); s/iteration beside it."""
    rec = record("patches_avgdown")
    run, counts, spec = records_solve(FOREST_FORCE, "patches_force")
    groups = spec.batch_groups
    check(len(groups) == 3 and all(len(g) == 2 for g in groups)
          and batched_groups_of(spec) == list(groups),
          f"patches_force: batch groups {groups}")
    agree = check_avgdown_record(run, rec, rec["history"][0],
                                 "patches_force")
    check_route(run, counts, spec, "patches_force")
    apps = 2 * sum(run["linear_iters"])
    relax, res = relax_calls_of(spec), residual_calls_of(spec)
    # gsrb_relax_batch's calls by the kernel each launches (the 144^3
    # pair's the march)
    want = {"gsrb_relax": sum(relax["gsrb_relax"].values()),
            **batch_kernel_calls_of(spec),
            "residual_restrict": res["residual_restrict"],
            "residual_restrict_batch": res["residual_restrict_batch"]}
    got = {k: counts["launches"][k] for k in want}
    check(got == {k: n * apps for k, n in want.items()},
          f"patches_force: calls {got} in {apps} applications, the batch "
          f"groups imply {want} each")
    out = {"phase": "forest_batching", "overrides": FOREST_FORCE,
           "batch_groups": [list(g) for g in groups],
           "group_shapes": ["x".join(map(str, spec.geom.shape(g[0])))
                            for g in groups],
           "applications": apps, "calls_per_application": want,
           "sequential_calls_per_application": sequential_calls_of(spec),
           **agree, **counts, **run}
    seq = RECORDS_PATCHES.get("run")
    if seq is not None:
        for k in ("history", "linear_iters", "K_history"):
            check(run[k] == seq[k], f"patches_force: {k} {run[k]}, the "
                  f"sequential run {seq[k]}")
        out.update(bit_for_bit_sequential=True,
                   sequential_s_per_iteration=seq["s_per_iteration"],
                   sequential_by_shape=RECORDS_PATCHES["by_shape"])
    else:
        out["bit_for_bit_sequential"] = "not checked: the records phase " \
                                        "did not run in this call"
    FOREST_COUNTS["forest_batching"] = counts
    emit(out)
    return out


# the forest_batching phase's counts (its kernels' main path)
FOREST_COUNTS: dict = {}


# ------------------------------------------------------------- bf16_tier

# the bf16_tier phase's counts (the tier kernels' main paths)
BF16_COUNTS: dict = {}
BF16_OVERRIDE = ["smoother_precision = bfloat16"]
# the tier's end-to-end run: the 4-level canonical solve (SOLVE_BASE) with
# the records' patches settings (level_decomposition = patches,
# average_down = 1; at max_level 3 the same four boxes), with room for the
# tier's slower Picard contraction (it converged by entry 14 in the plain
# versions on the CPU: scripts/bf16_tier.py, patches3). Without
# average_down (the solve phase's run) and at the records' full depth
# (max_level 6) the tier does not converge, in the JAX package's arithmetic
# as in the kernels' (scripts/bf16_tier.py; PERF.md section 6).
BF16_SOLVE = SOLVE_BASE + ["level_decomposition = patches",
                           "average_down = 1", "max_NL_iterations = 20"]
# the tier on the march rungs: scale7 (7 levels, no average_down: not
# expected to converge) and the periodic box (PERIODIC_BASE), each beside
# its f32 run and bit for bit the same solve with every tier wrapper
# replaced by its twin on the card; the box on 4 x-slabs and (2, 2) pencils
# of one card beside their f32 runs
BF16_SCALE7 = ["max_level = 6", "max_NL_iterations = 2",
               "precond_precision = single", "verbosity = 0"]
# the relax kernels that take the tier, each counted under its name with
# _bf16 there; every other kernel runs at f32 in a run of the tier
TIER_RELAX = ("gsrb_relax", "wavefront_relax", "multisweep_relax",
              "multisweep_relax_halo", "multisweep_relax_tiled_pre",
              "tower_down", "tower_up")
TIER_WRAPPERS: dict = {}


def install_relax(mode: str) -> None:
    """What sweeps the levels and the towers of a solve on the card:
    `kernel` the wrappers (the kernels, the solver's own path); `plain` /
    `twin` the plain versions on the card's tensors in place of every
    relax wrapper the solver reaches (gsrb_relax, wavefront_relax,
    multisweep_relax and its halo= form, multisweep_relax_tiled_pre, the
    towers): the JAX body's arithmetic, its arithmetic colour select
    included, or (twin) with the kernels' colour select, which the tier's
    kernels are held to bit for bit. The residual and restriction kernels
    run in every mode. (scripts/bf16_tier.py --relax.)"""
    mods = {"gsrb_relax": fs, "wavefront_relax": wf, "multisweep_relax": fs,
            "multisweep_relax_tiled_pre": fs, "tower_down": ct,
            "tower_up": ct}
    if not TIER_WRAPPERS:
        TIER_WRAPPERS.update({n: getattr(m, n) for n, m in mods.items()})
    if mode == "kernel":
        for n, m in mods.items():
            setattr(m, n, TIER_WRAPPERS[n])
        return
    where = mode == "twin"

    def multisweep(u, rhs, a, halo=None, **kw):
        if halo is None:
            return fs.multisweep_relax_plain(u, rhs, a, _where=where, **kw)
        return fs.multisweep_relax_halo_plain(u, rhs, a, *halo,
                                              _where=where, **kw)

    fs.gsrb_relax = lambda u, rhs, a, b=None, **kw: fs.gsrb_relax_plain(
        u, rhs, a, b, _where=where, **kw)
    wf.wavefront_relax = lambda u, rhs, a, **kw: wf.wavefront_relax_plain(
        u, rhs, a, _where=where, **kw)
    fs.multisweep_relax = multisweep
    fs.multisweep_relax_tiled_pre = lambda *args, **kw: (
        fs.multisweep_relax_tiled_pre_plain(*args, _where=where, **kw))
    ct.tower_down = lambda *args: ct.tower_down_plain(*args, _where=where)
    ct.tower_up = lambda *args: ct.tower_up_plain(*args, _where=where)


def tier_solve(overrides, label: str, params: str = CANONICAL,
               relax: str = "kernel") -> dict:
    """load_params -> generate_hierarchy -> poisson_solve on the card, the
    levels and towers swept as install_relax(`relax`) says, the counters
    set to 0 just before: a solve that need not converge (a
    NonConvergenceError ends it and is reported). The Picard history as
    far as it got, K, the Krylov counts and final linear residuals, each
    iteration's seconds, the peak memory, the counts of the run and the
    relax wrappers' calls by shape."""
    cfg = mgt.load_params(params, overrides=list(overrides))
    geom = generate_hierarchy(cfg)
    log: list = []
    inner = nl.nl_iteration

    def logged(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        log.append((float(out[2]), float(out[3]), int(out[4]["iters"]),
                    float(out[4]["final_rnorm"]),
                    time.perf_counter() - t0))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    install_relax(relax)
    nl.nl_iteration = logged
    kernel_counts.reset()
    raised = None
    try:
        with calls_by_shape() as by_shape:
            poisson_solve(cfg, geom=geom, verbose=False)
    except nl.NonConvergenceError as e:
        raised = f"NonConvergenceError: {e}"
    finally:
        nl.nl_iteration = inner
        install_relax("kernel")
    counts = dict(kernel_counts.snapshot(), by_shape=by_shape)
    return {"label": label, "overrides": list(overrides), "relax": relax,
            "levels": [list(b.shape) for b in geom.boxes], "raised": raised,
            "history": [x[0] for x in log], "K_history": [x[1] for x in log],
            "linear_iters": [x[2] for x in log],
            "linear_residuals": [x[3] for x in log],
            "s_per_iteration": [x[4] for x in log],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "spec": comp.make_amr_spec(geom, cfg), "counts": counts}


def check_tier_against_f32(run: dict, f32: dict, what: str) -> dict:
    """The kernels of a run of the tier against the f32 run of the same
    configuration: every relax kernel the f32 run launched launched under
    its _bf16 name instead (TIER_RELAX), every other kernel at f32, each
    as often per preconditioner application (two a Krylov iteration) as in
    the f32 run, and no other kernel; one launch a call; no plain
    version."""
    got, base = run["counts"]["launches"], f32["counts"]["launches"]
    apps, apps32 = 2 * sum(run["linear_iters"]), 2 * sum(f32["linear_iters"])
    want = {(fs.tier_name(k, BF16) if k in TIER_RELAX else k): n
            for k, n in base.items() if n}
    check(apps > 0 and {k for k, n in got.items() if n} == set(want)
          and all(got[k] * apps32 == n * apps for k, n in want.items()),
          f"{what}: launches {got} in {apps} preconditioner applications; "
          f"the f32 run's {base} in {apps32}")
    check_one_launch(run["counts"], what)
    check(all(v == 0 for v in run["counts"]["plain_calls"].values()),
          f"{what}: a plain version ran on the card's path: "
          f"{run['counts']['plain_calls']}")
    return {"applications": apps, "applications_f32": apps32,
            "launches_per_application": {k: got[k] / apps for k in want}}


def same_solve(a: dict, b: dict, what: str) -> None:
    """Two solves' Picard histories, K, Krylov counts and final linear
    residuals bit for bit (NaN equal to NaN), and the same end."""
    def equal(x, y):
        return len(x) == len(y) and all(
            p == q or (math.isnan(p) and math.isnan(q)) for p, q in zip(x, y))

    for k in ("history", "K_history", "linear_residuals"):
        check(equal(a[k], b[k]), f"{what}: {k} {a[k]} against {b[k]}")
    check(a["linear_iters"] == b["linear_iters"]
          and a["raised"] == b["raised"],
          f"{what}: Krylov {a['linear_iters']} ({a['raised']}) against "
          f"{b['linear_iters']} ({b['raised']})")


def tier_record(run: dict) -> dict:
    """What the phase prints of a tier_solve."""
    return {k: v for k, v in run.items() if k not in ("spec", "counts")} | {
        k: run["counts"][k] for k in ("launches", "device_launches",
                                      "plain_calls", "by_shape")}


def check_tier_route(run: dict, counts: dict, spec, what: str) -> None:
    """The kernels of a run in the bf16 tier: every relaxation of every
    entry a gsrb_relax_bf16 call as often as the hierarchy and the Krylov
    counts imply (relax_calls_of, counted by shape at the gsrb_relax
    wrapper, which takes the tier's calls), the base chain in the towers'
    tier, the residual's two forms as at f32 (residual_calls_of); no f32
    gsrb_relax or tower launch (no batch group, constant b: nothing the
    tier leaves at f32), no march, no plain version, one launch a call."""
    check(not spec.batch_groups, f"{what}: batch groups {spec.batch_groups}")
    check(all(ls.smoother_compute == BF16 for ls in spec.level_specs),
          f"{what}: smoother_compute not bfloat16 on every level")
    apps = 2 * sum(run["linear_iters"])
    want = {k: n * apps for k, n in relax_calls_of(spec)["gsrb_relax"].items()}
    got = {k: v for k, v in counts["by_shape"]["gsrb_relax"].items() if v}
    launches = counts["launches"]
    check(got == want and launches["gsrb_relax_bf16"] == sum(want.values())
          and sum(want.values()) > 0,
          f"{what}: gsrb_relax_bf16 calls {launches['gsrb_relax_bf16']}, by "
          f"shape {got}; the hierarchy implies {want}")
    launched = {"gsrb_relax_bf16", "tower_down_bf16", "tower_up_bf16",
                "residual", "residual_restrict"}
    check(all(launches[k] > 0 for k in launched)
          and all(launches[k] == 0 for k in kernel_counts.KERNELS
                  if k not in launched),
          f"{what}: kernels launched {launches}, the tier's path takes "
          f"{sorted(launched)}")
    check_one_launch(counts, what)
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"{what}: a plain version ran on the card's path: {counts}")
    check_residual_calls(run, what, residual_calls_of(spec))


def tier_against_f32(run: dict, f32: dict) -> dict:
    """A bf16 run beside the f32 run of the same configuration, with the
    records' limits, each reading with its limit and whether it is met
    (step 1 within 1e-5 of the f32 run's; steps 2-4 within 2 %; Krylov at
    most one more a Picard iteration; entry 7 at most 5e-10 and below
    1e-10 by entry 8), and both runs' s/iteration and peak memory."""
    h, h32 = run["history"], f32["history"]
    it, it32 = run["linear_iters"], f32["linear_iters"]
    step1 = abs(h[0] - h32[0]) / h32[0]
    steps = [abs(a - b) / b for a, b in zip(h[1:4], h32[1:4])]
    extra = [a - b for a, b in zip(it, it32)]
    limits = {
        "step1_rel_diff_f32": [step1, 1e-5, step1 <= 1e-5],
        "steps2_4_rel_diff_f32": [steps, 2e-2, bool(steps)
                                  and max(steps) <= 2e-2],
        "krylov_minus_f32": [extra, 1, max(extra) <= 1],
        "entry7": [h[6] if len(h) > 6 else None, 5e-10,
                   len(h) < 7 or h[6] <= 5e-10],
        "below_1e-10_by_entry_8": [len(h), 8, len(h) <= 8]}
    return {"records_limits": limits,
            "records_limits_met": all(v[2] for v in limits.values()),
            "history_f32": h32, "linear_iters_f32": it32,
            "s_per_iteration": run["s_per_iteration"],
            "s_per_iteration_f32": f32["s_per_iteration"],
            "max_memory_allocated": run["max_memory_allocated"],
            "max_memory_allocated_f32": f32["max_memory_allocated"]}


def phase_bf16_tier() -> dict:
    """smoother_precision = bfloat16 end to end, each run beside the f32
    run of the same configuration:
      * BF16_SOLVE (the 4-level solve with average_down) must converge
        (every entry finite, below the tolerance within its 20 Picard
        iterations; a NonConvergenceError ends the phase) and go the
        tier's route (check_tier_route); the records' limits are reported
        beside the f32 run's readings (tier_against_f32);
      * scale7 (BF16_SCALE7: the wave rung at 512x96x96 and 960x144x144)
        and the periodic box (PERIODIC_BASE: the multisweep rung at 256^3)
        go the tier's route against their f32 runs (check_tier_against_f32:
        the *_bf16 march launches as often per preconditioner application
        as the f32 marches, no f32 relax launch, no plain version; scale7's
        relax calls by shape as its hierarchy implies, relax_calls_of), and
        each is bit for bit (NaN-aware; converged or not) the same solve
        with every tier wrapper replaced by its twin on the card
        (install_relax("twin")); their histories, Krylov counts and
        s/iteration are reported, convergence asserted on neither;
      * the box on 4 x-slabs and on (2, 2) pencils of cuda:0 (sharded_solve:
        its splits and joins held to check_halo_counts) against its f32
        runs (check_tier_against_f32: the shard marches' *_bf16 launches),
        step 1 beside the unsharded tier run's; the x-slab run is the
        processes phase's one-process reference in the tier."""
    out = {"phase": "bf16_tier", "overrides": BF16_SOLVE + BF16_OVERRIDE}
    f32 = run_solve(BF16_SOLVE, "solve_avgdown_f32")
    kernel_counts.reset()
    with calls_by_shape() as by_shape:
        run = run_solve(BF16_SOLVE + BF16_OVERRIDE, "solve_avgdown_bf16")
    counts = dict(kernel_counts.snapshot(), by_shape=by_shape)
    cfg = mgt.load_params(CANONICAL, overrides=BF16_SOLVE + BF16_OVERRIDE)
    spec = comp.make_amr_spec(generate_hierarchy(cfg), cfg)
    h = run["history"]
    check(all(math.isfinite(x) for x in h) and run["converged"]
          and h[-1] < cfg.tolerance,
          f"solve_avgdown_bf16: not converged: history {h}, Krylov "
          f"{run['linear_iters']}")
    check(f32["converged"], f"solve_avgdown_f32: history {f32['history']}")
    check(run["levels"] == f32["levels"], f"solve_avgdown_bf16: levels "
          f"{run['levels']}, f32 {f32['levels']}")
    check_tier_route(run, counts, spec, "solve_avgdown_bf16")
    BF16_COUNTS["bf16_tier"] = counts
    torch.cuda.empty_cache()
    out["solve_avgdown"] = {**tier_against_f32(run, f32), **counts, **run}

    # the march rungs, unsharded: the kernels, their twins, the f32 run
    for name, over, params, march in (
            ("scale7", BF16_SCALE7, CANONICAL, "wavefront_relax"),
            ("periodic", PERIODIC_BASE, PERIODIC, "multisweep_relax")):
        ref32 = tier_solve(over, f"{name}_f32", params)
        torch.cuda.empty_cache()
        tier = tier_solve(over + BF16_OVERRIDE, f"{name}_bf16", params)
        torch.cuda.empty_cache()
        twin = tier_solve(over + BF16_OVERRIDE, f"{name}_bf16_twin", params,
                          relax="twin")
        torch.cuda.empty_cache()
        what = f"{name}_bf16"
        check(tier["levels"] == ref32["levels"] and tier["history"],
              f"{what}: levels {tier['levels']}, history {tier['history']}")
        check(all(ls.smoother_compute == BF16
                  for ls in tier["spec"].level_specs),
              f"{what}: smoother_compute not bfloat16 on every level")
        route = check_tier_against_f32(tier, ref32, what)
        check(tier["counts"]["launches"][fs.tier_name(march, BF16)] > 0,
              f"{what}: no {march} launch in the tier")
        if name == "scale7":
            apps = route["applications"]
            want = {n: {k: c * apps for k, c in calls.items()}
                    for n, calls in relax_calls_of(tier["spec"]).items()}
            got = {n: c for n, c in tier["counts"]["by_shape"].items()
                   if c or n in want}
            check(got == want, f"{what}: relax calls by shape "
                  f"{tier['counts']['by_shape']}, the hierarchy implies "
                  f"{want}")
        same_solve(tier, twin, f"{what} against its twins")
        BF16_COUNTS[f"bf16_{name}"] = tier["counts"]
        h, h32 = tier["history"], ref32["history"]
        out[name] = {**tier_record(tier), **route, "equals_twin_solve": True,
                     "step1_rel_diff_f32": abs(h[0] - h32[0]) / h32[0],
                     "history_f32": h32,
                     "linear_iters_f32": ref32["linear_iters"],
                     "K_history_f32": ref32["K_history"],
                     "s_per_iteration_f32": ref32["s_per_iteration"],
                     "max_memory_allocated_f32":
                     ref32["max_memory_allocated"],
                     "twin_s_per_iteration": twin["s_per_iteration"]}

    # the box's shards in the tier (one card named four times)
    for path, mshape in (("sharded_x", SHARD_X),
                         ("sharded_pencil", SHARD_PENCIL)):
        run32, counts32 = sharded_solve(PERIODIC_BASE, f"{path}_f32", mshape,
                                        PERIODIC)
        torch.cuda.empty_cache()
        run, counts = sharded_solve(PERIODIC_BASE + BF16_OVERRIDE,
                                    f"bf16_{path}", mshape, PERIODIC)
        torch.cuda.empty_cache()
        what = f"bf16_{path}"
        route = check_tier_against_f32(
            {"counts": counts, "linear_iters": run["linear_iters"]},
            {"counts": counts32, "linear_iters": run32["linear_iters"]},
            what)
        kernel = ("multisweep_relax_halo_bf16" if path == "sharded_x"
                  else "multisweep_relax_tiled_pre_bf16")
        m = kernel_counts.KERNELS.index(kernel)
        check(all(c[m] > 0 for c in run["kernel_calls_per_iteration"]),
              f"{what}: an iteration made no {kernel} call")
        BF16_COUNTS[what] = counts
        SHARDED_REFERENCE[what] = run
        h = run["history"]
        hu = out["periodic"]["history"]
        out[what] = {"mesh": list(mshape), **run, **route,
                     "launches": counts["launches"],
                     "device_launches": counts["device_launches"],
                     "plain_calls": counts["plain_calls"],
                     "halo": counts["halo"],
                     "step1_rel_diff_unsharded_bf16":
                     abs(h[0] - hu[0]) / hu[0],
                     "history_f32": run32["history"],
                     "linear_iters_f32": run32["linear_iters"],
                     "s_per_iteration_f32": run32["s_per_iteration"]}
    emit(out)
    return out


# -------------------------------------------------------------- periodic

PERIODIC_BASE = ["max_NL_iterations = 3", "precond_precision = single",
                 "verbosity = 0"]
# one refined level around a puncture moved next to the high x face (at
# 256^3 the level comes out as 232 x 80 x 80, ending at that face)
PERIODIC_TWO_LEVEL = ["max_level = 1", "refine_threshold = 0.2",
                      "bh1_offset = 7.0", "bh2_offset = 2.0"]
# cells nearer than this to a puncture are left out of the Hamiltonian norm:
# the regular part of psi is not smooth at a puncture, and no stencil
# converges there
HAM_RMIN = 1.5
# the same box without the punctures (the triple-sine field alone): every
# term is smooth, so this is the variant that can show the order of
# convergence, and it is held to second order with no cell left out
PERIODIC_SMOOTH = ["bh1_bare_mass = 0", "bh2_bare_mass = 0",
                   "bh1_momentum = 0", "bh2_momentum = 0",
                   "bh1_spin = 0", "bh2_spin = 0"]


def hamiltonian_rms(keep: dict, rmin: float | None = HAM_RMIN) -> float:
    """Root mean square of diagnostics.hamiltonian_residual of a solve's
    base level over the cells farther than `rmin` from both punctures
    (None: over every cell)."""
    cfg, geom, res = keep["cfg"], keep["geom"], keep["res"]
    psi = res.psi[0]
    h = dg.hamiltonian_residual(geom, cfg, psi, 0, res.constant_K)
    x, y, z = (torch.as_tensor(c, dtype=psi.dtype, device=psi.device)
               for c in geom.coords(0))
    x, y, z = x[2:-2], y[:, 2:-2], z[:, :, 2:-2]
    far = None
    for off in (cfg.bh1_offset, cfg.bh2_offset):
        m = (x - off) ** 2 + y * y + z * z > (rmin or 0.0) ** 2
        far = m if far is None else far & m
    check(bool(torch.isfinite(h).all()), "hamiltonian residual not finite")
    if rmin is None:
        return float(h.pow(2).mean().sqrt())
    return float(h[far.expand_as(h)].pow(2).mean().sqrt())


def check_periodic_run(run: dict, counts: dict, what: str) -> None:
    """K finite and negative, a strictly contracting history, few Krylov
    iterations, every kernel of the periodic path launched (one launch per
    multisweep call), the same calls wherever the Krylov count is the same,
    and no plain version."""
    import math

    k, h, it = run["constant_K"], run["history"], run["linear_iters"]
    check(math.isfinite(k) and k < 0.0, f"{what}: constant_K {k}")
    check(all(b < a for a, b in zip(h, h[1:])) and len(h) >= 2,
          f"{what}: history not contracting: {h}")
    check(all(i <= 4 for i in it), f"{what}: linear iters {it}")
    check(all(counts["launches"][n] > 0 for n in PERIODIC_KERNELS),
          f"{what}: a kernel was never launched: {counts}")
    check(counts["device_launches"]["multisweep_relax"]
          == counts["launches"]["multisweep_relax"],
          f"{what}: multisweep_relax is not one launch per call")
    check_one_launch(counts, what)
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"{what}: a plain version ran on the card's path: {counts}")
    m = kernel_counts.KERNELS.index("multisweep_relax")
    per_iter = [c[m] for c in run["kernel_calls_per_iteration"]]
    check(all(n > 0 for n in per_iter),
          f"{what}: an iteration made no multisweep_relax call: {per_iter}")
    by_iters: dict = {}
    for calls, n_it in zip(run["kernel_calls_per_iteration"], it):
        by_iters.setdefault(n_it, set()).add(tuple(calls))
    check(all(len(v) == 1 for v in by_iters.values()),
          f"{what}: kernel calls differ between iterations of equal Krylov "
          f"count: {run['kernel_calls_per_iteration']} {it}")


def check_against_staged(run: dict, staged: dict, what: str,
                         step_tol: float = 1e-5,
                         later_k_tol: float = 1e-10) -> dict:
    """The same solve with `smoother = xla` (no kernel) on the card: step 1
    to `step_tol` relative, the first K to 1e-10 relative (it is set from
    psi = 1 before any solve) and the K of later common iterations to
    `later_k_tol` (they follow the linear solves), equal Krylov counts."""
    n = len(staged["history"])
    rel = abs(staged["history"][0] - run["history"][0]) / run["history"][0]
    krels = [abs(a - b) / abs(b) for a, b in
             zip(staged["K_history"], run["K_history"])]
    krel = max(krels)
    check(rel <= step_tol,
          f"{what}: staged smoother first step differs: {rel}")
    check(krels[0] <= 1e-10 and krel <= later_k_tol,
          f"{what}: staged smoother K differs: {krels}: "
          f"{staged['K_history']} {run['K_history']}")
    check(staged["linear_iters"] == run["linear_iters"][:n],
          f"{what}: Krylov counts {run['linear_iters']} vs staged "
          f"{staged['linear_iters']}")
    return {"staged_first_step": staged["history"][0],
            "staged_rel_diff": rel, "staged_K_rel_diff": krel,
            "staged_linear_iters": staged["linear_iters"],
            "staged_s_per_iteration": staged["s_per_iteration"]}


def periodic_plan_table() -> dict:
    """The rung and the tower's first depth for the periodic box's depth
    chain (256^3 down to 4^3), f32 on the card: the top depth takes the
    multisweep rung, the tower starts at 128^3."""
    spec = chain_spec((256, 256, 256), (0, 0, 0), ALL_P, dx0=0.0625)
    coefs = {"b": (None,) * spec.ndepths}
    table = {}
    for d, box in enumerate(spec.boxes):
        table["x".join(map(str, box.shape))] = {
            "plan": mg.plan_for(spec, box.shape, torch.float32, "cuda", 4),
            "tower_starts_here": ct.tower_supported(spec, coefs, d)}
    first = table["256x256x256"]
    check(first["plan"] == [("multisweep", 2)] * 2
          and not first["tower_starts_here"],
          f"256^3 periodic: {first}")
    check(table["128x128x128"]["tower_starts_here"],
          "the tower does not start at 128^3")
    return table


def phase_periodic() -> dict:
    keep: dict = {}
    kernel_counts.reset()
    run = run_solve(PERIODIC_BASE, "periodic", keep, params=PERIODIC)
    counts = kernel_counts.snapshot()  # the periodic box, nothing else
    check(run["levels"] == [[256, 256, 256]],
          f"unexpected hierarchy {run['levels']}")
    check_periodic_run(run, counts, "periodic")
    check_residual_calls(run, "periodic")
    # the 256^3 depth never went to the per-pass kernel: every gsrb pass of
    # this path runs inside the tower, from 128^3 down
    check(counts["launches"]["gsrb_relax"] == 0
          and counts["launches"]["wavefront_relax"] == 0,
          f"periodic: the top depth took another rung: {counts}")
    ham256 = hamiltonian_rms(keep)
    keep.clear()
    torch.cuda.empty_cache()
    staged = run_solve(PERIODIC_BASE + ["smoother = xla",
                                        "max_NL_iterations = 2"],
                       "periodic_staged", params=PERIODIC)
    agree = check_against_staged(run, staged, "periodic")
    # A sanity check, not an order of convergence: with the punctures on
    # cell corners the terms next to them are not resolved, and the residual
    # away from them falls by about 2.2x per doubling (2.8x between 64^3 and
    # 128^3), not by 4x. The order is held on the smooth box below.
    half = run_solve(PERIODIC_BASE + ["N = 128 128 128"], "periodic_128",
                     keep, params=PERIODIC)
    ham128 = hamiltonian_rms(keep)
    keep.clear()
    check(ham256 <= 0.6 * ham128,
          f"periodic: hamiltonian residual {ham256} at 256^3 against "
          f"{ham128} at 128^3")
    krel = abs(half["constant_K"] - run["constant_K"]) / abs(
        run["constant_K"])
    # K moves by a few 1e-3 between resolutions (the punctures sit on cell
    # corners and the terms next to them are not resolved): a sanity check
    check(krel <= 1e-2, f"periodic: K at 128^3 differs by {krel}")

    # the smooth box (no punctures) through the same path: second order in
    # the Hamiltonian constraint over every cell, a first step that does not
    # move with the resolution, and the staged smoother within 1e-5 / 1e-10
    kernel_counts.reset()
    smooth = run_solve(PERIODIC_BASE + PERIODIC_SMOOTH, "periodic_smooth",
                       keep, params=PERIODIC)
    counts_s = kernel_counts.snapshot()
    check_periodic_run(smooth, counts_s, "smooth")
    ham256s = hamiltonian_rms(keep, rmin=None)
    keep.clear()
    torch.cuda.empty_cache()
    staged_s = run_solve(PERIODIC_BASE + PERIODIC_SMOOTH
                         + ["smoother = xla", "max_NL_iterations = 2"],
                         "periodic_smooth_staged", params=PERIODIC)
    agree_s = check_against_staged(smooth, staged_s, "smooth")
    half_s = run_solve(PERIODIC_BASE + PERIODIC_SMOOTH + ["N = 128 128 128"],
                       "periodic_smooth_128", keep, params=PERIODIC)
    ham128s = hamiltonian_rms(keep, rmin=None)
    keep.clear()
    order_ratio = ham256s / ham128s
    check(0.2 <= order_ratio <= 0.3,
          f"smooth: hamiltonian residual {ham256s} at 256^3 against "
          f"{ham128s} at 128^3 is not second order")
    step_rel = abs(half_s["history"][0] - smooth["history"][0]) / smooth[
        "history"][0]
    check(step_rel <= 1e-5,
          f"smooth: first step moves with the resolution: {step_rel}")

    # two levels: level 1 touches a periodic face without spanning the box
    kernel_counts.reset()
    two = run_solve(PERIODIC_BASE + PERIODIC_TWO_LEVEL, "periodic_two_level",
                    keep, params=PERIODIC)
    counts2 = kernel_counts.snapshot()
    geom = keep["geom"]
    check(geom.num_levels == 2, f"two-level: {two['levels']}")
    fine, dom = geom.boxes[1], geom.domain_boxes[1]
    touches = [d for d in range(3) if (fine.lo[d] == dom.lo[d])
               != (fine.hi[d] == dom.hi[d])]
    check(bool(touches), f"two-level: level 1 {fine} touches no periodic "
          f"face of {dom} on one side only")
    keep.clear()
    check_periodic_run(two, counts2, "two-level")
    staged2 = run_solve(PERIODIC_BASE + PERIODIC_TWO_LEVEL
                        + ["smoother = xla"], "periodic_two_level_staged",
                        params=PERIODIC)
    # Two levels: the composite solve stops after 2 Krylov iterations at a
    # residual of a few 1e-10, where the iterate of a system of condition
    # ~1e5 still carries the preconditioner's rounding (read on an H100:
    # step 1 1.8e-5 apart, the later K 1.2e-6; with one level, 3e-8 and
    # 2e-14). Hence 1e-4 and 1e-5 here against 1e-5 and 1e-10 above.
    agree2 = check_against_staged(two, staged2, "two-level", step_tol=1e-4,
                                  later_k_tol=1e-5)
    torch.cuda.empty_cache()
    n_iter = len(run["history"])
    out = {
        "phase": "periodic", "params": os.path.relpath(PERIODIC, ROOT),
        "launches": counts["launches"],
        "device_launches": counts["device_launches"],
        "plain_calls": counts["plain_calls"],
        "launches_per_picard_iteration": {
            k: v / n_iter for k, v in counts["launches"].items()},
        "plan_by_depth": periodic_plan_table(),
        "hamiltonian_rms_256": ham256, "hamiltonian_rms_128": ham128,
        "hamiltonian_ratio": ham256 / ham128, "hamiltonian_rmin": HAM_RMIN,
        "K_128_rel_diff": krel, **agree, **run,
        "smooth": {"overrides": PERIODIC_SMOOTH,
                   "hamiltonian_rms_256": ham256s,
                   "hamiltonian_rms_128": ham128s,
                   "hamiltonian_ratio": order_ratio,
                   "first_step_128_rel_diff": step_rel,
                   "K_128": half_s["constant_K"],
                   "launches": counts_s["launches"],
                   "plain_calls": counts_s["plain_calls"], **agree_s,
                   **smooth},
        "two_level": {"touches_face_on_axes": touches,
                      "launches": counts2["launches"],
                      "plain_calls": counts2["plain_calls"], **agree2,
                      **two},
    }
    emit(out)
    return out


# ----------------------------------------------------------- periodic_odd

# the periodic box at N = 240 (params/periodic.txt with N alone changed):
# 240 = 15 * 2^4, so its depth chain ends on a periodic 15^3 bottom, odd
# on every axis: the top depth takes the multisweep rung, the tower runs
# 120^3 -> 15^3 and pre-smooths that bottom in place, and the bottom's
# BiCGStab (3375 cells, above mg.DIRECT_BOTTOM_MAX_CELLS) is preconditioned
# by gsrb_relax at 15^3. On 4 x-slabs the depths the mesh cuts stop at 60^3
# (15 planes a shard), and 30^3 and 15^3 are too few for the tower:
# gsrb_relax smooths both.
PERIODIC_ODD = PERIODIC_BASE + ["N = 240 240 240"]
ODD_COUNTS: dict = {}
# the kernels-phase cases of a level kernel, which hold it at the shapes a
# run of the box gives it (held_at)
ODD_HELD_BY = {"gsrb_relax": "LEVEL_CASES", "residual": "LEVEL_CASES",
               "residual_restrict": "LEVEL_CASES",
               "multisweep_relax": "MULTI_CASES"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def odd_plan_table(level_spec) -> dict:
    """Per depth of the box's level: its shape, the shards the mesh cuts it
    into, and what smooths it on the card at f32: the shard march (a cut
    depth), the tower (the uncut chain from the depth the tower starts at),
    else relax's plan (multisweep or resident: gsrb_relax)."""
    coefs = {"b": (None,) * level_spec.ndepths}
    table, tower_from = {}, None
    for d, box in enumerate(level_spec.boxes):
        cut = mg._shard_counts(level_spec, d)
        uncut_below = all(mg._shard_counts(level_spec, dd) == (1, 1, 1)
                          for dd in range(d, level_spec.ndepths))
        if (tower_from is None and uncut_below
                and ct.tower_supported(level_spec, coefs, d)):
            tower_from = d
        if cut != (1, 1, 1):
            kernel = "multisweep_relax_halo"
        elif tower_from is not None:
            kernel = "tower_down/tower_up"
        else:
            plan = mg.plan_for(level_spec, box.shape, torch.float32, "cuda",
                               level_spec.nsmooth)
            kernel = {"multisweep": "multisweep_relax",
                      "resident": "gsrb_relax"}[plan[0][0]]
        table["x".join(map(str, box.shape))] = {"shards": list(cut),
                                                "kernel": kernel}
    bottom = level_spec.boxes[-1]
    table["bottom_precond"] = {
        "shape": list(bottom.shape),
        "direct": mg._use_direct_bottom(level_spec),
        "plan": mg.plan_for(level_spec, bottom.shape, torch.float32, "cuda",
                            2)}
    return table


def held_at(seen: dict, path: str) -> dict:
    """For each kernel and level shape a run of the box gave it (seen, from
    calls_by_shape), the kernels-phase case that holds the kernel against
    its plain version there (every axis periodic, the same shape); fails
    where none does, or where the kernels line's case for the path
    (PATH_CASES) is not one of them."""
    out = {}
    for name, shapes in seen.items():
        cases = globals()[ODD_HELD_BY[name]]
        for key in shapes:
            shape = tuple(int(n) for n in key.split("x"))
            cid = next((c[0] for c in cases
                        if tuple(c[1]) == shape and c[2] == ALL_P), None)
            check(cid is not None,
                  f"{path}: {name} at {key} P is held by no case of "
                  f"{ODD_HELD_BY[name]}")
            out.setdefault(name, {})[key] = cid
        if shapes:
            check(PATH_CASES[path].get(name) in out[name].values(),
                  f"{path}: the kernels line reads {name} at "
                  f"{PATH_CASES[path].get(name)}, not a shape of the run: "
                  f"{out[name]}")
    return out


def phase_periodic_odd() -> dict:
    """The periodic box at N = 240 end to end (PERIODIC_ODD): every kernel of
    its route launched (the multisweep rung at 240^3, the tower down to the
    15^3 bottom, gsrb_relax at 15^3 in the bottom's BiCGStab), one launch a
    call, no plain version; the same solve under `smoother = xla` on the
    card within the periodic phase's limits (step 1 1e-5, K 1e-10, Krylov
    counts equal); a second kernel solve bit for bit the first (a colour pass
    that read a cell its pass writes would differ between runs); the box on
    4 x-slabs of cuda:0 within 1e-5 of the unsharded step 1, with the
    kernel of each depth; s/iteration and peak memory beside the card."""
    card = card_line()
    runs = []
    for label in ("periodic_odd", "periodic_odd_again"):
        keep: dict = {}
        kernel_counts.reset()
        with calls_by_shape(("gsrb_relax", "multisweep_relax", "residual",
                             "residual_restrict")) as seen:
            run = run_solve(PERIODIC_ODD, label, keep, params=PERIODIC)
        counts = kernel_counts.snapshot()
        run["calls_by_shape"] = {k: dict(v) for k, v in seen.items()}
        runs.append((run, counts, keep))
        torch.cuda.empty_cache()
    (run, counts, keep), (again, _, _) = runs
    ODD_COUNTS["periodic_odd"] = counts
    check(run["levels"] == [[240, 240, 240]],
          f"periodic_odd: hierarchy {run['levels']}")
    spec = comp.make_amr_spec(keep["geom"], keep["cfg"])
    table = odd_plan_table(spec.level_specs[0])
    check(table["240x240x240"]["kernel"] == "multisweep_relax"
          and table["120x120x120"]["kernel"] == "tower_down/tower_up"
          and table["15x15x15"]["kernel"] == "tower_down/tower_up"
          and not table["bottom_precond"]["direct"]
          and table["bottom_precond"]["plan"] == [("resident", 2)],
          f"periodic_odd: route {table}")
    on_path = ("multisweep_relax", "residual", "residual_restrict",
               "tower_down", "tower_up", "gsrb_relax")
    check(all(counts["launches"][k] > 0 for k in on_path),
          f"periodic_odd: a kernel of the route was never launched: "
          f"{ {k: counts['launches'][k] for k in on_path} }")
    check(set(run["calls_by_shape"]["gsrb_relax"]) == {"15x15x15"}
          and set(run["calls_by_shape"]["multisweep_relax"])
          == {"240x240x240"},
          f"periodic_odd: relax calls by shape {run['calls_by_shape']}")
    held = held_at(run["calls_by_shape"], "periodic_odd")
    check_one_launch(counts, "periodic_odd")
    check(counts["device_launches"]["multisweep_relax"]
          == counts["launches"]["multisweep_relax"],
          "periodic_odd: multisweep_relax is not one launch per call")
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"periodic_odd: a plain version ran on the card's path: {counts}")
    k, h = run["constant_K"], run["history"]
    check(math.isfinite(k) and k < 0.0, f"periodic_odd: constant_K {k}")
    check(len(h) >= 2 and all(b < a for a, b in zip(h, h[1:])),
          f"periodic_odd: history not contracting: {h}")
    # the race would show as run-to-run differences
    check(again["history"] == h
          and again["linear_residuals"] == run["linear_residuals"]
          and again["K_history"] == run["K_history"],
          f"periodic_odd: two kernel solves differ: {h} {again['history']}")
    torch.cuda.empty_cache()
    staged = run_solve(PERIODIC_ODD + ["smoother = xla",
                                       "max_NL_iterations = 2"],
                       "periodic_odd_staged", params=PERIODIC)
    agree = check_against_staged(run, staged, "periodic_odd")
    torch.cuda.empty_cache()
    # 4 x-slabs of cuda:0: which kernel took each depth, step 1 against the
    # unsharded solve
    with calls_by_shape(("gsrb_relax", "residual",
                         "residual_restrict")) as seen_x:
        slabs, counts_x = sharded_solve(PERIODIC_ODD, "periodic_odd_x",
                                        SHARD_X, PERIODIC)
    torch.cuda.empty_cache()
    ODD_COUNTS["periodic_odd_x"] = counts_x
    seen_x = {k: dict(v) for k, v in seen_x.items()}
    held_x = held_at(seen_x, "periodic_odd_x")
    mesh = one_card_mesh(SHARD_X)
    spec_x = comp.make_amr_spec(keep["geom"], keep["cfg"], mesh.home, mesh)
    table_x = odd_plan_table(spec_x.level_specs[0])
    step_x = abs(slabs["history"][0] - h[0]) / h[0]
    check(step_x <= 1e-5, f"periodic_odd_x: step 1 {slabs['history'][0]} "
          f"vs unsharded {h[0]}: {step_x}")
    check(counts_x["launches"]["multisweep_relax_halo"] > 0
          and counts_x["launches"]["gsrb_relax"] > 0
          and "15x15x15" in seen_x["gsrb_relax"],
          f"periodic_odd_x: launches {counts_x['launches']} by shape "
          f"{seen_x}")
    check_one_launch(counts_x, "periodic_odd_x")
    check(all(v == 0 for v in counts_x["plain_calls"].values()),
          f"periodic_odd_x: a plain version ran: {counts_x}")
    n_iter = len(h)
    out = {
        "phase": "periodic_odd", "params": os.path.relpath(PERIODIC, ROOT),
        "overrides": PERIODIC_ODD, "card": card,
        "plan_by_depth": table, "held_by": held,
        "launches": counts["launches"],
        "device_launches": counts["device_launches"],
        "plain_calls": counts["plain_calls"],
        "launches_per_picard_iteration": {
            n: c / n_iter for n, c in counts["launches"].items() if c},
        "repeat_bitwise": True, "repeat_s_per_iteration":
            again["s_per_iteration"], **agree, **run,
        "x_slabs": {"mesh": list(SHARD_X), "step1_rel_diff": step_x,
                    "plan_by_depth": table_x,
                    "calls_by_shape": seen_x, "held_by": held_x,
                    "launches": counts_x["launches"],
                    "plain_calls": counts_x["plain_calls"],
                    "history": slabs["history"],
                    "linear_iters": slabs["linear_iters"],
                    "constant_K": slabs["constant_K"],
                    "s_per_iteration": slabs["s_per_iteration"],
                    "max_memory_allocated": slabs["max_memory_allocated"]},
    }
    emit(out)
    print(f"periodic_odd: {card}: s/iteration {run['s_per_iteration']}, "
          f"peak memory {run['max_memory_allocated']} B; launches "
          f"{ {n: counts['launches'][n] for n in on_path} }", flush=True)
    return out


# ------------------------------------------------------------------- cli

CLI_OVERRIDES = ["max_level = 6", "max_NL_iterations = 2",
                 "precond_precision = single", "verbosity = 0"]


def stack_sums(stack) -> tuple:
    """(components, itemsize, nx * ny, per-component sums, per-component
    absolute sums, values) of one box's component stack: a tensor, or a
    cut level's stack held as its shards (summed shard by shard)."""
    if not isinstance(stack, shards.ShardSet):
        return (stack.shape[0], stack.element_size(),
                stack.shape[1] * stack.shape[2],
                stack.sum(dim=(1, 2, 3)).cpu(),
                stack.abs().sum(dim=(1, 2, 3)).cpu(), stack.numel())
    parts = [stack.shards[k] for k in sorted(stack.shards)]
    sums = sum(p.sum(dim=(1, 2, 3)).cpu() for p in parts)
    abss = sum(p.abs().sum(dim=(1, 2, 3)).cpu() for p in parts)
    return (parts[0].shape[0], parts[0].element_size(),
            stack.shape[0] * stack.shape[1], sums, abss,
            sum(p.numel() for p in parts))


def check_pieces(pieces, base_off: int, cells: int, stack, what: str):
    """The (offset, size, sum) of the pieces the writers stream for one
    box: every tile within the byte limit, each component's pieces contiguous from its offset to
    its end, and each component's sum equal to the device's (1e-10 of the
    component's absolute sum: the tiles are added in another order)."""
    ncomp, isz, nxy, dev, scale, _ = stack_sums(stack)
    limit = max(chio._STREAM_MAX_BYTES, ncomp * nxy * isz)
    by_comp = [[] for _ in range(ncomp)]
    for off, size, total in pieces:
        c = (off - base_off) // cells
        check(0 <= c < ncomp, f"{what}: piece offset {off} outside the box")
        by_comp[c].append((off, size, total))
    ntiles = len(by_comp[0])
    for c, plist in enumerate(by_comp):
        pos = base_off + c * cells
        for off, size, _ in plist:
            check(off == pos, f"{what}: component {c} has a gap at {off}")
            pos += size
        check(pos == base_off + (c + 1) * cells,
              f"{what}: component {c} ends at {pos}")
        check(len(plist) == ntiles, f"{what}: tiles differ by component")
    for t in range(ntiles):
        tile_bytes = sum(by_comp[c][t][1] for c in range(ncomp)) * isz
        check(tile_bytes <= limit, f"{what}: tile of {tile_bytes} bytes")
    host = torch.tensor([sum(x[2] for x in pl) for pl in by_comp],
                        dtype=torch.float64)
    worst = float(((host - dev).abs() / scale.clamp_min(1e-300)).max())
    check(worst <= 1e-10, f"{what}: checksum off by {worst}")
    return ntiles, worst


CLI_PERIODIC_OVERRIDES = ["max_NL_iterations = 2",
                          "precond_precision = single", "verbosity = 0"]


def cli_streamed(overrides, params: str = CANONICAL, mesh=None) -> dict:
    """What main.run does, with the writers' streaming run against no file:
    load_params -> generate_hierarchy -> the mesh (main.choose_mesh, which
    prints the sharding line) -> poisson_solve with the snapshot hook -> the
    final 29-variable stacks."""
    cfg = mgt.load_params(params, overrides=list(overrides))
    set_verbosity(cfg.verbosity)
    geom = generate_hierarchy(cfg)
    mesh = cli_main.choose_mesh(cfg, torch.device("cuda"), mesh)
    stats = {"boxes": 0, "tiles": 0, "values": 0, "worst_checksum": 0.0}

    def stream(stacks, what):
        off = 0
        for e, stack in stacks:
            cells = geom.boxes[e].num_cells
            pieces = [(o, flat.size, float(flat.sum()))
                      for o, flat in chio._fab_pieces(off, cells, stack)]
            nt, worst = check_pieces(pieces, off, cells, stack,
                                     f"{what} entry {e}")
            ncomp, _, _, _, _, values = stack_sums(stack)
            off += ncomp * cells
            stats["boxes"] += 1
            stats["tiles"] += nt
            stats["values"] += values
            stats["worst_checksum"] = max(stats["worst_checksum"], worst)

    def snapshot(nl_iter, state):
        _, rhs_list, _ = nl.prepare_iteration(geom, cfg, state["fields"],
                                              state["psi"])
        for d in range(geom.max_depth + 1):
            stream(((e, chio.solver_data_stack(
                state["dpsi"][e], rhs_list[e], state["psi"][e],
                state["fields"][e])) for e in geom.entries_at_depth(d)),
                f"plotfile {nl_iter} level {d}")

    res = poisson_solve(cfg, geom=geom, output_hook=snapshot, mesh=mesh)
    k_index = ld.GRCHOMBO_INDEX["K"]
    for d in range(geom.max_depth + 1):
        stacks = [(e, ld.grchombo_output_stack(
            res.psi[e], res.fields[e], cfg, res.constant_K))
            for e in geom.entries_at_depth(d)]
        # the checkpoint carries the solve's constant K in every cell
        for _, stack in stacks:
            check(float(stack[k_index].min()) == float(stack[k_index].max())
                  == res.constant_K, "checkpoint: K is not the solve's")
        stream(stacks, f"checkpoint level {d}")
    return {"history": res.dpsi_norm_history, "constant_K": res.constant_K,
            "linear_iters": res.linear_iters,
            # what write_solver_data puts into is_periodic_<d> (the
            # checkpoint's is 1 by GRChombo's convention)
            "plotfile_is_periodic": int(geom.bc.periodic),
            "levels": [list(b.shape) for b in geom.boxes], **stats}


def cli_files(overrides, params: str = CANONICAL,
              ndepths: int = len(SCALE7_SHAPES), mesh=None) -> dict:
    """main.run itself in a temporary directory; the files are read back."""
    import h5py

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            rc = cli_main.run(["main", params, *overrides], mesh=mesh)
            check(rc == 0, f"main.run returned {rc}")
            plots = sorted(f for f in os.listdir(tmp)
                           if f.startswith("vcPoissonOut.3d_"))
            check(plots == ["vcPoissonOut.3d_0.hdf5",
                            "vcPoissonOut.3d_1.hdf5"], f"plotfiles {plots}")
            levels, nbytes = [], 0
            for d in range(ndepths):
                box, _, _, named = chio.read_level_data(
                    "vcPoissonFinal.3d.hdf5", d)
                levels.append(list(box.shape))
                chi = named["chi"]
                check(float(chi.min()) > 0.0 and bool(
                    (chi == chi).all()), f"checkpoint level {d}: bad chi")
                _, _, _, pl = chio.read_level_data(plots[0], d)
                check(float(abs(pl["dpsi"]).max()) == 0.0
                      and float(abs(pl["rhs"]).max()) > 0.0,
                      f"plotfile 0 level {d}: dpsi/rhs")
            k = named["K"]
            check(float(k.min()) == float(k.max()), "checkpoint: K varies")
            with h5py.File(plots[0], "r") as f:
                per = int(f["level_0"].attrs["is_periodic_0"])
            with h5py.File("vcPoissonFinal.3d.hdf5", "r") as f:
                check(int(f["level_0"].attrs["is_periodic_0"]) == 1,
                      "checkpoint: is_periodic_0 is not 1")
            for f in os.listdir(tmp):
                nbytes += os.path.getsize(f)
        finally:
            os.chdir(here)
    return {"levels": levels, "bytes_written": nbytes,
            "constant_K": float(k.min()), "plotfile_is_periodic": per}


def phase_cli() -> dict:
    have = chio.HAVE_H5PY
    torch.cuda.synchronize()
    kernel_counts.reset()
    t0 = time.perf_counter()
    body = cli_files(CLI_OVERRIDES) if have else cli_streamed(CLI_OVERRIDES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts.snapshot()
    check(body["levels"] == [list(s) for s in SCALE7_SHAPES],
          f"cli: unexpected hierarchy {body['levels']}")
    check(all(counts["launches"][k] > 0 for k in CANONICAL_KERNELS),
          f"cli: a kernel was never launched: {counts}")
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"cli: a plain version ran on the card's path: {counts}")
    if not have:
        h = body["history"]
        check(abs(h[0] - SCALE7[0]) / SCALE7[0] <= 1e-5
              and abs(h[1] - SCALE7[1]) / SCALE7[1] <= 2e-2,
              f"cli: history {h}")
        # without h5py main.run itself must refuse before any solve
        t1 = time.perf_counter()
        rc = cli_main.run(["main", CANONICAL, *CLI_OVERRIDES])
        check(rc == 2 and time.perf_counter() - t1 < 5.0,
              f"main.run without h5py returned {rc}")
    check(body["plotfile_is_periodic"] == 0 and body["constant_K"] == 0.0,
          f"cli: canonical run is periodic: {body}")

    # once more on the periodic box: is_periodic reaches the plotfile's
    # header, K the checkpoint, and the 256^3 depth the multisweep kernel
    kernel_counts.reset()
    t0 = time.perf_counter()
    per = (cli_files(CLI_PERIODIC_OVERRIDES, PERIODIC, 1) if have
           else cli_streamed(CLI_PERIODIC_OVERRIDES, PERIODIC))
    torch.cuda.synchronize()
    per_seconds = time.perf_counter() - t0
    pcounts = kernel_counts.snapshot()
    check(per["levels"] == [[256, 256, 256]],
          f"cli periodic: unexpected hierarchy {per['levels']}")
    check(per["plotfile_is_periodic"] == 1,
          "cli periodic: is_periodic did not reach the plotfile")
    check(per["constant_K"] < 0.0, f"cli periodic: K {per['constant_K']}")
    check(all(pcounts["launches"][k] > 0 for k in PERIODIC_KERNELS),
          f"cli periodic: a kernel was never launched: {pcounts}")
    check(all(v == 0 for v in pcounts["plain_calls"].values()),
          f"cli periodic: a plain version ran: {pcounts}")
    out = {"phase": "cli", "h5py": have, "files_written": have,
           "form": "main.run, files read back" if have else
           "main.run's calls, the writers' pieces summed and not written",
           "overrides": CLI_OVERRIDES, "seconds": seconds,
           "stream_max_bytes": chio._STREAM_MAX_BYTES,
           "launches": counts["launches"],
           "plain_calls": counts["plain_calls"], **body,
           "periodic": {"overrides": CLI_PERIODIC_OVERRIDES,
                        "seconds": per_seconds,
                        "launches": pcounts["launches"],
                        "plain_calls": pcounts["plain_calls"], **per}}
    emit(out)
    return out


# --------------------------------------------------------------- sharded

# one card standing in for four: the mesh names cuda:0 four times, so every
# seam, exchange and global offset of a 4-card run is there
SHARD_X = (4,)
SHARD_PENCIL = (2, 2)
# the 7-level lock's step 1 limit on the sharded run: the unsharded lock's
# 1e-5. Sharding changes the f32 preconditioner's arithmetic: every depth
# the mesh cuts is smoothed by the shard march (the whole-level march's
# update, not gsrb_relax's or the tower's) and the tower moves down to 16^3.
# Step 1 reads 9.54e-6 from the lock, bit for bit in every run, and the
# unsharded solve with those depths on the whole-level march reads the same
# to 1.5e-9; with the f64 preconditioner both paths reach the lock to 3e-15
# (scripts/sharded7_lock.py, PERF.md).
SHARDED7_STEP1 = 1e-5


def one_card_mesh(shape):
    return pmesh.make_mesh(["cuda:0"] * math.prod(shape), shape)


def check_sharded_run(run, ref, counts, what: str, kernel: str,
                      step_tol: float, k_tol: float | None) -> dict:
    """A sharded run against the unsharded run of the same configuration:
    step 1 within step_tol relative, every K within k_tol, Krylov counts
    equal while the history contracts (+-1 on a step that does not: there
    the last BiCGStab iteration is decided by roundoff); its halo kernel
    launched in every iteration, the same number of times wherever the
    Krylov count is the same, one launch per call; no plain version."""
    h, hr = run["history"], ref["history"]
    rel = abs(h[0] - hr[0]) / hr[0]
    check(rel <= step_tol, f"{what}: step 1 {h[0]} vs unsharded {hr[0]}: "
          f"{rel} > {step_tol}")
    krels = [abs(a - b) / abs(b) if b else abs(a - b)
             for a, b in zip(run["K_history"], ref["K_history"])]
    if k_tol is not None:
        check(max(krels) <= k_tol, f"{what}: K {krels} > {k_tol}")
    for i, (a, b) in enumerate(zip(run["linear_iters"], ref["linear_iters"])):
        plateau = i > 0 and hr[i] > 0.5 * hr[i - 1]
        check(a == b or (plateau and abs(a - b) <= 1),
              f"{what}: Krylov {run['linear_iters']} vs unsharded "
              f"{ref['linear_iters']}")
    check(all(b < a for a, b in zip(h, h[1:])),
          f"{what}: history not contracting: {h}")
    m = kernel_counts.KERNELS.index(kernel)
    per_iter = [c[m] for c in run["kernel_calls_per_iteration"]]
    check(all(n > 0 for n in per_iter),
          f"{what}: an iteration made no {kernel} call: {per_iter}")
    by_iters: dict = {}
    for calls, n_it in zip(run["kernel_calls_per_iteration"],
                           run["linear_iters"]):
        by_iters.setdefault(n_it, set()).add(tuple(calls))
    check(all(len(v) == 1 for v in by_iters.values()),
          f"{what}: kernel calls differ between iterations of equal Krylov "
          f"count: {run['kernel_calls_per_iteration']}")
    check(counts["device_launches"][kernel] == counts["launches"][kernel],
          f"{what}: {kernel} is not one launch per call")
    check_one_launch(counts, what)
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"{what}: a plain version ran on the card's path: {counts}")
    return {"step1_rel_diff": rel, "K_rel_diff": max(krels),
            "unsharded_history": hr, "unsharded_linear_iters":
            ref["linear_iters"], "unsharded_K": ref["constant_K"],
            "unsharded_s_per_iteration": ref["s_per_iteration"],
            "unsharded_max_memory_allocated": ref["max_memory_allocated"]}


def sharded_solve(overrides, label, mesh_shape, params: str) -> tuple:
    """run_solve with a mesh of one card; the counts of that run alone,
    its splits and joins held to what its hierarchy implies
    (check_halo_counts)."""
    kernel_counts.reset()
    keep: dict = {}
    mesh = one_card_mesh(mesh_shape)
    run = run_solve(overrides, label, keep=keep, params=params, mesh=mesh)
    counts = kernel_counts.snapshot()
    spec = comp.make_amr_spec(keep["geom"], keep["cfg"], mesh.home, mesh)
    run["halo_counts"] = check_halo_counts(run, spec, label)
    return run, counts


def precond_application(overrides, params: str, mesh, reps: int = 5) -> dict:
    """One preconditioner application (composite.precond) of the run's
    first Picard iteration, from the initial psi, with `mesh` or without
    (None): what it split, joined, exchanged and moved (kernel_counts.HALO,
    held to shard_traffic_of with a mesh) and its wall time to completion
    on the card (median of `reps`, after one warm application)."""
    cfg = mgt.load_params(params, overrides=list(overrides))
    geom = generate_hierarchy(cfg)
    dev = torch.device("cuda") if mesh is None else mesh.home
    spec = comp.make_amr_spec(geom, cfg, dev, mesh)
    fields = [ld.problem_fields(geom, cfg, l, torch.float64, dev)
              for l in range(geom.num_levels)]
    psi = ld.initial_state(geom, cfg, torch.float64, dev)["psi"]
    if mesh is not None:  # placed as poisson_solve places them
        fields = pmesh.shard_fields(fields, mesh, geom)
        psi = pmesh.shard_level_list(psi, mesh, geom)
    a, rhs, _ = nl.prepare_iteration(geom, cfg, fields, psi)
    coefs = comp.build_coefs(spec, a)
    comp.precond(spec, coefs, rhs)
    torch.cuda.synchronize()
    kernel_counts.reset()
    comp.precond(spec, coefs, rhs)
    torch.cuda.synchronize()
    moved = dict(kernel_counts.HALO)
    if mesh is not None:
        want = shard_traffic_of(spec)
        check({k: moved[k] for k in want} == want,
              f"precond application {mesh.shape}: {moved}, the hierarchy "
              f"implies {want}")
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp.precond(spec, coefs, rhs)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    del coefs, a, rhs, fields, psi
    torch.cuda.empty_cache()
    return {"halo": moved, "wall_ms": sorted(times)[reps // 2],
            "wall_ms_runs": times}


SHARDED7 = ["max_level = 6", "max_NL_iterations = 3",
            "precond_precision = single", "verbosity = 0"]
# the sharded phase's one-process runs (periodic x-slabs, 7 levels), which
# the processes phase holds its runs over two processes to
SHARDED_REFERENCE: dict = {}
# bytes moved between mesh positions per Picard iteration when only the
# preconditioner kept the cut depths on their shards and the Krylov
# vectors, the f64 operator and the Picard state were whole on the home:
# this phase's reading of that placement (PERF.md §6; NVIDIA H100 80GB
# HBM3, 700.00 W)
HOME_PLACEMENT_BYTES_PER_ITERATION = {
    "sharded_x": 2.27e9, "sharded_pencil": 2.30e9, "sharded7": 4.09e9}


def bytes_per_iteration(run: dict, label: str) -> dict:
    """The bytes moved between mesh positions in each Picard iteration of
    a sharded run (the last one with the result's joins), beside the
    preconditioner-only placement's per iteration."""
    per = [h["bytes_moved"] for h in run["halo_per_iteration"]]
    return {"bytes_moved_per_iteration": per,
            "bytes_moved_first_iteration": per[0],
            "home_placement_bytes_moved_per_iteration":
            HOME_PLACEMENT_BYTES_PER_ITERATION[label],
            "ratio_to_home_placement":
            per[0] / HOME_PLACEMENT_BYTES_PER_ITERATION[label]}


# the JAX package's test forest on a mesh (tests/test_forest.py
# two_patch_geom(n=16), forest_cfg): a 16^3 base and two sibling
# (8, 12, 12) patches that no mesh here cuts (8 / 4 and 12 / 2 cells fall
# below MIN_LOCAL_NX), so forest_batching = auto batches them and spreads
# the pair over the mesh's patch axis
FOREST_CFG = dict(alpha=1.0, beta=-1.0, max_level=1, n_cells=(16, 16, 16),
                  L=1.0, num_mg_smooth=4, num_mg_iterations=2,
                  max_iterations=60, tolerance=1e-11, is_periodic=False)
# the forest's solve with a mesh against the one without, f64 throughout
# (the JAX test's tolerance)
FOREST_RTOL, FOREST_ATOL = 1e-9, 1e-11


def two_patch_forest(n: int = 16):
    """The JAX package's two_patch_geom: a base of n^3 and two sibling
    patches of (n/2, 3n/4, 3n/4) at depth 1, separated in x, every domain
    face Dirichlet, L = 1."""
    from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom

    dom0 = Box.from_shape((n, n, n))
    a = Box((n // 4, 5 * n // 8, 5 * n // 8),
            (3 * n // 4 - 1, 11 * n // 8 - 1, 11 * n // 8 - 1))
    b = Box((5 * n // 4, 5 * n // 8, 5 * n // 8),
            (7 * n // 4 - 1, 11 * n // 8 - 1, 11 * n // 8 - 1))
    return HierarchyGeom(
        boxes=(dom0, a, b), domain_boxes=(dom0, dom0.refine(2),
                                          dom0.refine(2)),
        dx=(1.0 / n, 0.5 / n, 0.5 / n), domain_length=(1.0, 1.0, 1.0),
        bc=BCSpec(), parent=(-1, 0, 0))


def forest_solve(mesh, seed: int = 7, device: str = "cuda", **over) -> dict:
    """composite.solve_linear on two_patch_forest (aCoef in [0.5, 2] and
    rhs from `seed`, zero start) with `mesh` (None: one `device`): its
    spec, the solution joined, Krylov count, the counts of the coefficient
    build and of the solve, its wall time and where each batched patch was
    computed (its placed aCoef's device)."""
    from mg_ic_code_tpu_torch.config import SolverConfig

    geom = two_patch_forest()
    cfg = SolverConfig(**{**FOREST_CFG, **over})
    dev = torch.device(device) if mesh is None else mesh.home
    spec = comp.make_amr_spec(geom, cfg, dev, mesh)
    g = torch.Generator().manual_seed(seed)
    a = [(0.5 + 1.5 * torch.rand(geom.shape(l), generator=g,
                                 dtype=torch.float64)).to(dev)
         for l in range(geom.num_levels)]
    rhs = [torch.randn(geom.shape(l), generator=g,
                       dtype=torch.float64).to(dev)
           for l in range(geom.num_levels)]
    a, rhs = comp.place(spec, a), comp.place(spec, rhs)
    kernel_counts.reset()
    coefs = comp.build_coefs(spec, a)
    build = kernel_counts.snapshot()
    kernel_counts.reset()
    sync = lambda: [torch.cuda.synchronize(i)  # noqa: E731
                    for i in range(torch.cuda.device_count())]
    sync()
    t0 = time.perf_counter()
    out = comp.solve_linear(spec, coefs, rhs)
    sync()
    wall = time.perf_counter() - t0
    solve = kernel_counts.snapshot()  # the solve's, not the joins below
    x = [v.join() if isinstance(v, shards.ShardSet) else v for v in out.x]
    at = {x_: str(coefs[x_]["at"]["a"][0].device) for g_ in spec.batch_groups
          for x_ in g_ if "at" in coefs[x_] and coefs[x_]["at"]["a"][0]
          is not None}
    return {"spec": spec, "x": x, "iters": int(out.iters),
            "converged": bool(out.converged), "build": build,
            "solve": solve, "wall_s": wall, "patch_devices": at}


def forest_halo_want(spec, iters: int,
                     device_type: str = "cuda") -> tuple[dict, dict]:
    """(build, solve): the HALO counts (HALO_DERIVED) one build_coefs and
    one solve_linear of `iters` Krylov iterations imply on the forest's
    mesh: shard_coef_builds_of, then two preconditioner applications an
    iteration (shard_traffic_of) and the coarse-fine windows of the
    operator in the initial residual and its two applications an
    iteration (as picard_windows_of)."""
    build = shard_coef_builds_of(spec, device_type)
    app = shard_traffic_of(spec)
    apps = 2 * iters
    solve = {k: apps * app.get(k, 0) for k in HALO_DERIVED}
    solve["level_windows"] += (1 + apps) * sum(
        cf for _, cf in _cut_pairs(spec))
    return {k: build.get(k, 0) for k in HALO_DERIVED}, solve


def check_forest_halo(run: dict, what: str) -> dict:
    """The forest run's HALO counts against forest_halo_want."""
    spec = run["spec"]
    build, solve = forest_halo_want(spec, run["iters"],
                                    spec.level_specs[0].mesh.home.type)
    for want, got, part in ((build, run["build"]["halo"], "build"),
                            (solve, run["solve"]["halo"], "solve")):
        check({k: got[k] for k in want} == want,
              f"{what}: {part} halo {got}, the forest implies {want}")
    return {"build": run["build"]["halo"], "solve": run["solve"]["halo"]}


def forest_on_mesh(mesh, ref: dict | None, what: str) -> dict:
    """The forest on `mesh` (forest_batching = auto): its batch group
    ((1, 2)) at positions (0, 0) and (0, 1) of the mesh, the f64 solve
    against the one without a mesh (`ref`, or solved here) to FOREST_RTOL /
    FOREST_ATOL, and its HALO counts what the placement implies
    (check_forest_halo); then the card's f32 preconditioner through the
    batched kernels, bit for bit the same mesh with forest_batching = off
    (the pair one after the other on the home), its batched calls what
    the placement implies, no plain version. On a mesh of CPU positions
    (the tests) the f32 run takes the kernels' plain versions
    (smoother = pallas), and their calls are held instead."""
    cpu = mesh.home.type == "cpu"
    f32 = dict(precond_precision="single", smoother="pallas") if cpu else {}
    calls_of = "plain_calls" if cpu else "launches"
    if ref is None:
        ref = forest_solve(None, device=mesh.home.type,
                           precond_precision="double")
    f64 = forest_solve(mesh, precond_precision="double")
    spec = f64["spec"]
    want_pos = (mesh.position_at({"x": 0, "y": 0}),
                mesh.position_at({"y": 1}))
    check(spec.batch_groups == ((1, 2),)
          and comp.batch_positions(spec, (1, 2)) == want_pos,
          f"{what}: batch groups {spec.batch_groups} at "
          f"{comp.batch_positions(spec, (1, 2))}, not ((1, 2),) at "
          f"{want_pos}")
    worst = 0.0
    for l, (xs, xr) in enumerate(zip(f64["x"], ref["x"])):
        xs = xs.to(xr.device)
        excess = ((xs - xr).abs() - FOREST_RTOL * xr.abs()).max()
        worst = max(worst, float((xs - xr).abs().max()))
        check(f64["converged"] and float(excess) <= FOREST_ATOL,
              f"{what}: level {l} differs from the solve without a mesh "
              f"beyond rtol {FOREST_RTOL} / atol {FOREST_ATOL}")
    halo64 = check_forest_halo(f64, f"{what} f64")
    run32 = forest_solve(mesh, **f32)
    off = forest_solve(mesh, forest_batching="off", **f32)
    check(all(torch.equal(a, b) for a, b in zip(run32["x"], off["x"]))
          and run32["iters"] == off["iters"],
          f"{what} f32: the batched solve is not bit for bit the "
          f"sequential one on the same mesh")
    halo32 = check_forest_halo(run32, f"{what} f32")
    calls = run32["solve"][calls_of]
    apps = 2 * run32["iters"]
    per = residual_calls_of(spec)["residual_restrict_batch"]
    check(calls["gsrb_relax_batch"] + calls["gsrb_relax_batch_march"]
          == apps * sum(relax_calls_of(run32["spec"])["gsrb_relax_batch"]
                        .values()) > 0
          and calls["residual_restrict_batch"] == apps * per
          and off["solve"][calls_of]["gsrb_relax_batch"] == 0,
          f"{what} f32: batched calls {calls}")
    check(cpu or all(v == 0 for v in run32["solve"]["plain_calls"].values()),
          f"{what} f32: a plain version ran {run32['solve']['plain_calls']}")
    return {"mesh": mesh.shape, "devices": [str(d) for d in mesh.devices],
            "batch_groups": [list(g) for g in spec.batch_groups],
            "positions": list(want_pos),
            "patch_devices": run32["patch_devices"],
            "f64": {"iters": f64["iters"], "unsharded_iters": ref["iters"],
                    "max_abs_diff": worst, "rtol": FOREST_RTOL,
                    "atol": FOREST_ATOL, "halo": halo64,
                    "wall_s": f64["wall_s"],
                    "unsharded_wall_s": ref["wall_s"]},
            "f32": {"iters": run32["iters"], "bit_for_bit_off": True,
                    "halo": halo32, calls_of: calls,
                    "wall_s": run32["wall_s"], "off_wall_s": off["wall_s"]}}


def phase_sharded() -> dict:
    out = {"phase": "sharded", "mesh_device": "cuda:0",
           "note": "one card named once per mesh position"}
    runs = {}
    # the periodic box at 256^3: unsharded, 4 x-slabs, (2, 2) pencils
    ref = run_solve(PERIODIC_BASE, "periodic_unsharded", params=PERIODIC)
    app_ref = precond_application(PERIODIC_BASE, PERIODIC, None)
    for path, mshape, kernel, other in (
            ("sharded_x", SHARD_X, "multisweep_relax_halo",
             "multisweep_relax_tiled_pre"),
            ("sharded_pencil", SHARD_PENCIL, "multisweep_relax_tiled_pre",
             "multisweep_relax_halo")):
        run, counts = sharded_solve(PERIODIC_BASE, path, mshape, PERIODIC)
        torch.cuda.empty_cache()
        check(run["levels"] == [[256, 256, 256]], f"{path}: {run['levels']}")
        agree = check_sharded_run(run, ref, counts, path, kernel,
                                  step_tol=1e-5, k_tol=1e-10)
        # the 256^3 depth went through the shards, not the whole-level rung
        check(counts["launches"]["multisweep_relax"] == 0
              and counts["launches"][other] == 0,
              f"{path}: another rung ran: {counts}")
        check(run["constant_K"] < 0.0, f"{path}: K {run['constant_K']}")
        runs[path] = counts
        SHARDED_REFERENCE[path] = run
        n_iter = len(run["history"])
        out[path] = {"mesh": list(mshape), **agree, **run,
                     **bytes_per_iteration(run, path),
                     "launches": counts["launches"],
                     "device_launches": counts["device_launches"],
                     "plain_calls": counts["plain_calls"],
                     "halo": counts["halo"],
                     "precond_application": {
                         "sharded": precond_application(
                             PERIODIC_BASE, PERIODIC, one_card_mesh(mshape)),
                         "unsharded": app_ref},
                     "launches_per_picard_iteration": {
                         k: v / n_iter for k, v in counts["launches"].items()}}

    # the canonical 7-level hierarchy: unsharded, then 4 x-slabs
    ref7 = run_solve(SHARDED7, "scale7_unsharded")
    torch.cuda.empty_cache()
    run7, counts7 = sharded_solve(SHARDED7, "sharded7", SHARD_X, CANONICAL)
    torch.cuda.empty_cache()
    check(run7["levels"] == [list(s) for s in SCALE7_SHAPES],
          f"sharded7: {run7['levels']}")
    agree7 = check_sharded_run(run7, ref7, counts7, "sharded7",
                               "multisweep_relax_halo",
                               step_tol=SHARDED7_STEP1, k_tol=None)
    h = run7["history"]
    lock = {"step1_rel_diff_lock": abs(h[0] - SCALE7[0]) / SCALE7[0],
            "step1_limit": SHARDED7_STEP1,
            "step2_rel_diff_lock": abs(h[1] - SCALE7[1]) / SCALE7[1],
            "step3": h[2]}
    check(lock["step1_rel_diff_lock"] <= SHARDED7_STEP1,
          f"sharded7: step 1 {h[0]} vs {SCALE7[0]}")
    check(lock["step2_rel_diff_lock"] <= 2e-2,
          f"sharded7: step 2 {h[1]} vs {SCALE7[1]}")
    check(h[2] < 1e-6, f"sharded7: step 3 {h[2]}")
    check(all(i <= 3 for i in run7["linear_iters"]),
          f"sharded7: Krylov {run7['linear_iters']}")
    runs["sharded7"] = counts7
    SHARDED_REFERENCE["sharded7"] = run7
    n7 = len(h)
    out["sharded7"] = {"mesh": list(SHARD_X), **lock, **agree7, **run7,
                       **bytes_per_iteration(run7, "sharded7"),
                       "launches": counts7["launches"],
                       "device_launches": counts7["device_launches"],
                       "plain_calls": counts7["plain_calls"],
                       "halo": counts7["halo"],
                       "precond_application": {
                           "sharded": precond_application(
                               SHARDED7, CANONICAL, one_card_mesh(SHARD_X)),
                           "unsharded": precond_application(
                               SHARDED7, CANONICAL, None)},
                       "launches_per_picard_iteration": {
                           k: v / n7 for k, v in counts7["launches"].items()}}

    # the command line on the periodic box with the mesh, beside the same
    # without one (files written and read back where h5py is, else the
    # writers' pieces streamed and summed, as the cli phase)
    over = CLI_PERIODIC_OVERRIDES[:-1] + ["verbosity = 1"]
    cli = {}
    for label, mesh in (("mesh", one_card_mesh(SHARD_X)), ("none", None)):
        buf = io.StringIO()
        kernel_counts.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            body = (cli_files(over, PERIODIC, 1, mesh=mesh)
                    if chio.HAVE_H5PY
                    else cli_streamed(over, PERIODIC, mesh=mesh))
        torch.cuda.synchronize()
        said = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("sharding over")]
        cli[label] = {"seconds": time.perf_counter() - t0,
                      "sharding_line": said,
                      "launches": kernel_counts.snapshot()["launches"],
                      **body}
    want = "sharding over 4 devices (host-major mesh, shape {'x': 4})"
    check(cli["mesh"]["sharding_line"] == [want]
          and cli["none"]["sharding_line"] == [],
          f"cli: sharding line {cli['mesh']['sharding_line']}")
    if "history" in cli["mesh"]:
        hm, hn = cli["mesh"]["history"], cli["none"]["history"]
        krel = abs(cli["mesh"]["constant_K"] - cli["none"]["constant_K"]) / \
            abs(cli["none"]["constant_K"])
        cli["step1_rel_diff"] = abs(hm[0] - hn[0]) / hn[0]
        cli["K_rel_diff"] = krel
        check(cli["step1_rel_diff"] <= 1e-5 and krel <= 1e-10
              and cli["mesh"]["linear_iters"] == cli["none"]["linear_iters"],
              f"cli with a mesh: {hm} K {cli['mesh']['constant_K']} vs "
              f"{hn} K {cli['none']['constant_K']}")
    else:
        krel = abs(cli["mesh"]["constant_K"] - cli["none"]["constant_K"]) / \
            abs(cli["none"]["constant_K"])
        cli["K_rel_diff"] = krel
        check(krel <= 1e-10, f"cli with a mesh: K differs by {krel}")
    check(cli["mesh"]["launches"]["multisweep_relax_halo"] > 0,
          f"cli with a mesh: no halo kernel launch {cli['mesh']['launches']}")
    out["cli"] = {"overrides": over, "form": (
        "main.run, files read back" if chio.HAVE_H5PY else
        "main.run's calls, the writers' pieces summed and not written"),
        **cli}
    # the port's dry run: one full step of three small hierarchies on a
    # mesh naming cuda:0 four times against the same step without one
    from mg_ic_code_tpu_torch import entry

    t0 = time.perf_counter()
    out["dryrun_multichip"] = {"n": 4, **entry.dryrun_multichip(4, "cuda:0"),
                               "seconds": time.perf_counter() - t0}
    # the JAX package's forest test on a (4, 2) mesh of cuda:0 named eight
    # times: its sibling pair batched, one patch at (0, 0), one at (0, 1)
    out["forest"] = forest_on_mesh(one_card_mesh((4, 2)), None,
                                   "sharded forest")
    out["runs"] = runs
    emit(out)
    return out


def phase_cards() -> dict:
    """The sharded solve over every visible card: the mesh main.run builds
    by itself where it sees more than one (main.choose_mesh ->
    distributed.host_mesh), beside one card named as often and the run
    without a mesh, each sharded run's splits, joins and windows held to
    its hierarchy (check_halo_counts). Every level the mesh cuts stays on
    its cards from placement to the end of the solve (parallel/mesh.py):
    only pads, ghost planes, level windows and the depth chain's reshards
    cross between cards, and the result is joined on cuda:0 once at the
    end. The phase reads each card's peak memory over the four-card run
    and checks that every card past cuda:0 held its share (at least a
    fifth of the unsharded run's peak), and times one relax of the
    periodic box's 256^3 level in its per-call and its resident form."""
    n = torch.cuda.device_count()
    check(n >= 2, f"cards: needs more than one card, found {n}")
    out = {"phase": "cards", "device_count": n,
           "names": [torch.cuda.get_device_name(i) for i in range(n)]}
    keys = ("levels", "history", "linear_iters", "constant_K",
            "s_per_iteration", "total_s", "max_memory_allocated")
    for what, over, params, step_tol, k_tol in (
            ("periodic", PERIODIC_BASE, PERIODIC, 1e-5, 1e-10),
            ("scale7", SHARDED7, CANONICAL, SHARDED7_STEP1, None)):
        ref = run_solve(over, f"{what}_unsharded", params=params)
        torch.cuda.empty_cache()
        cfg = mgt.load_params(params, overrides=list(over))
        cards = cli_main.choose_mesh(cfg, torch.device("cuda"))
        check(cards is not None and cards.size == n
              and len(set(cards.devices)) == n,
              f"cards: main.choose_mesh gave {cards}")
        rec = {"unsharded": {k: ref[k] for k in keys}}
        for label, mesh in (
                ("cards", cards),
                ("one_card", one_card_mesh(tuple(cards.sizes)))):
            kernel_counts.reset()
            keep: dict = {}
            for i in range(n):
                torch.cuda.synchronize(i)
                torch.cuda.reset_peak_memory_stats(i)
            run = run_solve(over, f"{what}_{label}", keep=keep,
                            params=params, mesh=mesh)
            peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
            counts = kernel_counts.snapshot()
            check_halo_counts(run, comp.make_amr_spec(
                keep["geom"], keep["cfg"], torch.device("cuda"), mesh),
                f"cards {what} {label}")
            del keep
            torch.cuda.empty_cache()
            agree = check_sharded_run(run, ref, counts, f"cards {what} "
                                      f"{label}", "multisweep_relax_halo",
                                      step_tol=step_tol, k_tol=k_tol)
            rec[label] = {"mesh": mesh.shape,
                          "devices": [str(d) for d in mesh.devices],
                          **{k: run[k] for k in keys},
                          "step1_rel_diff": agree["step1_rel_diff"],
                          "K_rel_diff": agree["K_rel_diff"],
                          "launches": counts["launches"],
                          "halo": counts["halo"],
                          "bytes_moved_per_iteration": [
                              h["bytes_moved"]
                              for h in run["halo_per_iteration"]],
                          "max_memory_allocated_per_card": peaks}
        rec["cards_equal_one_card"] = all(
            rec["cards"][k] == rec["one_card"][k]
            for k in ("history", "constant_K", "linear_iters"))
        peaks = rec["cards"]["max_memory_allocated_per_card"]
        floor = ref["max_memory_allocated"] / 5
        check(all(p >= floor for p in peaks[1:]),
              f"cards {what}: cards past cuda:0 peak at {peaks[1:]} bytes, "
              f"below a fifth of the unsharded run's "
              f"{ref['max_memory_allocated']}: they do not hold their "
              f"shards")
        rec["peak_floor_per_card"] = floor
        out[what] = rec
        if what == "periodic":
            # one relax of its 256^3 level (4 sweeps) on each mesh
            shape = tuple(ref["levels"][0])
            f = level_fields(shape, torch.float32, seed=4)
            coefs = {"a": (f["a"],), "b": (None,), "lam": (None,)}
            relax_ms = {}
            for label, mesh in (("cards", cards),
                                ("one_card", one_card_mesh(
                                    tuple(cards.sizes))),
                                ("unsharded", None)):
                spec = mg.LevelMGSpec(
                    kinds=ALL_P, boxes=(Box.from_shape(shape, (0, 0, 0)),),
                    dx=(0.37,), rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4,
                    smoother="auto", mesh=mesh)
                relax_ms[label] = time_ms(
                    lambda: mg.relax(spec, coefs, 0, f["u"], f["rhs"], 4),
                    reps=6, warmup=1)
                if mesh is not None:
                    # wall times with every card synchronised: the
                    # resident form leaves its shards on their cards
                    rcoefs = mg.build_level_coefs(spec, f["a"])
                    u_s, r_s = (halo.split_level(spec, 0, f[k])
                                for k in ("u", "rhs"))
                    relax_ms[f"{label}_per_call_wall"] = wall_ms(
                        lambda: mg.relax(spec, coefs, 0, f["u"], f["rhs"],
                                         4))
                    relax_ms[f"{label}_resident_wall"] = wall_ms(
                        lambda: mg.relax(spec, rcoefs, 0, u_s, r_s, 4))
                    del rcoefs, u_s, r_s
            rec["whole_level_relax_ms"] = relax_ms
            del f
            torch.cuda.empty_cache()

    # the forest on (2, 2) over cuda:0-3: its two patches computed on two
    # cards, beside cuda:0 named four times
    if n >= 4:
        four = pmesh.make_mesh([f"cuda:{i}" for i in range(4)], (2, 2))
        ref = forest_solve(None, precond_precision="double")
        rec = {"cards": forest_on_mesh(four, ref, "cards forest"),
               "one_card": forest_on_mesh(one_card_mesh((2, 2)), ref,
                                          "cards forest one card")}
        devs = sorted(set(rec["cards"]["patch_devices"].values()))
        check(len(devs) == 2, f"cards forest: the patches computed on "
              f"{devs}, not on two cards")
        out["forest"] = rec

    # main.run's calls with no mesh given: it shards by itself
    buf = io.StringIO()
    kernel_counts.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        body = cli_streamed(CLI_PERIODIC_OVERRIDES[:-1] + ["verbosity = 1"],
                            PERIODIC)
    torch.cuda.synchronize()
    said = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("sharding over")]
    shape = dist.choose_mesh_shape(tuple(body["levels"][0]), n)
    want = (f"sharding over {n} devices (host-major mesh, shape "
            f"{dict(zip(pmesh.AXES, shape))})")
    launches = kernel_counts.snapshot()["launches"]
    check(said == [want], f"cards cli: sharding line {said}, not {want}")
    check(launches["multisweep_relax_halo"] > 0
          or launches["multisweep_relax_tiled_pre"] > 0,
          f"cards cli: no halo kernel launch {launches}")
    check(all(b < a for a, b in zip(body["history"], body["history"][1:])),
          f"cards cli: history not contracting: {body['history']}")
    out["cli"] = {"seconds": time.perf_counter() - t0, "sharding_line": said,
                  "launches": launches, **body}
    emit(out)
    return out


# ------------------------------------------------------------- processes

# the 7 levels stop at 2 Picard iterations over processes (the contract's
# time budget); their first two entries are the 3-iteration run's
PROCESSES7 = [o if not o.startswith("max_NL") else "max_NL_iterations = 2"
              for o in SHARDED7]
# the configurations the workers solve: (name, overrides, parameters, the
# sharded phase's reference run)
PROCESS_RUNS = (("periodic", PERIODIC_BASE, PERIODIC, "sharded_x"),
                ("sharded7", PROCESSES7, CANONICAL, "sharded7"),
                # the box's x-slabs in the bf16 tier (phase bf16_tier's run)
                ("periodic_bf16", PERIODIC_BASE + BF16_OVERRIDE, PERIODIC,
                 "bf16_sharded_x"))
# the kernels that run on the shards of a cut level (each process its own
# shards' calls); every other kernel runs on the depths the mesh does not
# cut, which every process holds whole and computes
SHARD_KERNELS = ("multisweep_relax_halo", "multisweep_relax_tiled_pre",
                 "multisweep_relax_halo_bf16",
                 "multisweep_relax_tiled_pre_bf16")
PROCESS_KEYS = ("levels", "history", "linear_iters", "K_history",
                "constant_K", "s_per_iteration", "total_s",
                "kernel_calls_per_iteration", "halo_per_iteration",
                "max_memory_allocated")


def process_worker(args) -> int:
    """One process of the run over several processes (`--worker`), started
    by torchrun (RANK, WORLD_SIZE, LOCAL_RANK in its environment): with
    `--shared-card-check`, first NCCL from that environment with every
    process on cuda:0, which must raise the port's error before NCCL is
    built (the group is then left, and started again); then `--backend`
    from torchrun's environment as the command line's entry brings it up
    (NCCL: card LOCAL_RANK; gloo: every process on cuda:0), and the
    PROCESS_RUNS solves on the mesh over every process's positions:
    `--positions` of them on this process's card, or with 0 the mesh the
    command line builds (main.choose_mesh: this process's card); one line
    PROCESS_RESULT {...} with each run and its counts."""
    rank, nprocs = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out: dict = {"rank": rank, "nprocs": nprocs, "backend": args.backend}
    if args.shared_card_check:
        try:
            dist.initialize(backend="nccl", local_rank=0)
            dist.finalize()
            out["shared_card_error"] = None
        except dist.SharedCardError as e:
            out["shared_card_error"] = str(e)
    t0 = time.perf_counter()
    dist.initialize(backend=args.backend)
    out["initialize_s"] = time.perf_counter() - t0
    devices = [f"cuda:{torch.cuda.current_device()}"] * args.positions
    try:
        with torch.no_grad():
            for name, over, params, _ in PROCESS_RUNS:
                cfg = mgt.load_params(params, overrides=list(over))
                mesh = (dist.host_mesh(cfg.n_cells, devices) if devices
                        else cli_main.choose_mesh(cfg, torch.device("cuda")))
                check(mesh is not None and mesh.size == nprocs * max(
                    1, args.positions), f"process {rank}: mesh {mesh}")
                kernel_counts.reset()
                run = run_solve(over, name, params=params, mesh=mesh)
                counts = kernel_counts.snapshot()
                out[name] = {**{k: run[k] for k in PROCESS_KEYS},
                             "mesh": mesh.shape,
                             "owners": list(mesh.owners),
                             "devices": [str(d) for d in mesh.devices],
                             "launches": counts["launches"],
                             "device_launches": counts["device_launches"],
                             "plain_calls": counts["plain_calls"],
                             "halo": counts["halo"]}
                torch.cuda.empty_cache()
            if devices and nprocs * args.positions == 4:
                out["forest"] = forest_record(forest_solve(
                    forest_process_mesh(dist.host_mesh(devices=devices))))
    except SmokeFailure as e:
        print(f"process {rank} FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    # the line in ONE write: the workers share one log file, and print()
    # writes a line longer than the stream's buffer and its newline apart,
    # so the other worker's line could land between them
    sys.stdout.flush()
    os.write(sys.stdout.fileno(),
             ("PROCESS_RESULT " + json.dumps(out) + "\n").encode())
    dist.finalize()
    return 0


def forest_process_mesh(mesh):
    """The forest's mesh over four positions (2, 1, 2): its pair on the x
    axis, at positions 0 and 2, which over two processes of two positions
    each are different processes'."""
    return pmesh.make_mesh(mesh.devices, (2, 1, 2), mesh.owners, mesh.rank)


def forest_record(run: dict) -> dict:
    """What a process reports of a forest_solve: a digest of every level
    of the solution, the Krylov count, the counts of the build and the
    solve, where its batched patches were computed."""
    import hashlib

    return {"x": [hashlib.sha256(v.cpu().contiguous().numpy().tobytes())
                  .hexdigest()[:16] for v in run["x"]],
            "iters": run["iters"], "build": run["build"],
            "solve": run["solve"], "patch_devices": run["patch_devices"],
            "positions": comp.batch_positions(run["spec"], (1, 2)),
            "owners": list(run["spec"].level_specs[0].mesh.owners)}


def check_process_forest(workers: list, ref: dict) -> dict:
    """The forest over the processes against one process over the same
    positions (`ref`, a forest_record): the solution bit for bit, the
    pair's chunks on different processes, each process's batched calls its
    own chunk's (summed: the one process's), HALO summed over the
    processes the one process's (bytes and messages between processes
    apart), no plain version."""
    pos = ref["positions"]
    owners = workers[0]["owners"]
    check(pos is not None and all(tuple(w["positions"]) == tuple(pos)
                                  for w in workers)
          and owners[pos[0]] != owners[pos[1]],
          f"processes forest: the pair at {pos} of owners {owners}")
    for w in workers:
        check(w["x"] == ref["x"] and w["iters"] == ref["iters"],
              f"processes forest: process {workers.index(w)} solution "
              f"{w['x']} ({w['iters']} Krylov), one process {ref['x']} "
              f"({ref['iters']})")
        check(all(v == 0 for v in w["solve"]["plain_calls"].values()),
              f"processes forest: a plain version ran {w['solve']}")
        check(w["solve"]["launches"]["gsrb_relax_batch"] > 0,
              f"processes forest: process {workers.index(w)} launched no "
              f"batch")
    local = ("bytes_between_processes", "messages")
    for part in ("build", "solve"):
        got = {k: sum(w[part]["halo"][k] for w in workers)
               for k in ref[part]["halo"] if k not in local}
        want = {k: v for k, v in ref[part]["halo"].items() if k not in local}
        check(got == want, f"processes forest: {part} halo summed {got}, "
              f"one process {want}")
    for k in ("gsrb_relax_batch", "gsrb_relax_batch_march",
              "residual_restrict_batch"):
        got = sum(w["solve"]["launches"][k] for w in workers)
        check(got == ref["solve"]["launches"][k],
              f"processes forest: {k} calls {got} over the processes, "
              f"{ref['solve']['launches'][k]} on one")
    between = sum(w["solve"]["halo"]["bytes_between_processes"]
                  for w in workers)
    check(between > 0, "processes forest: nothing crossed between the "
          "processes")
    return {"positions": list(pos), "owners": owners, "bit_for_bit": True,
            "iters": ref["iters"],
            "batch_calls_per_process": [w["solve"]["launches"][
                "gsrb_relax_batch"] for w in workers],
            "bytes_between_processes": between,
            "halo_solve_summed": {k: sum(w["solve"]["halo"][k]
                                         for w in workers)
                                  for k in ref["solve"]["halo"]}}


def spawn_workers(nprocs: int, backend: str, positions: int,
                  shared_card_check: bool, timeout_s: float) -> list:
    """Start `nprocs` workers of this script (process_worker) under
    torchrun (`torch.distributed.run --standalone`), in a temporary
    directory (their pout.<n> logs), wait for them at most `timeout_s`
    seconds, and return their results; a worker that fails, times out or
    says nothing fails the phase (every worker is stopped first)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nprocs}", os.path.abspath(__file__),
           "--worker", "--backend", backend, "--positions", str(positions)]
    if shared_card_check:
        cmd.append("--shared-card-check")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mg_ic_workers_") as tmp, \
            open(os.path.join(tmp, "workers.log"), "w+") as log:
        # a session of its own: torchrun and its workers are stopped
        # together
        p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                             cwd=tmp, start_new_session=True)
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            pass
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        log.seek(0)
        text = log.read()
    results = sorted((json.loads(ln.split("PROCESS_RESULT ", 1)[1])
                      for ln in text.splitlines()
                      if "PROCESS_RESULT {" in ln), key=lambda w: w["rank"])
    check(p.returncode == 0 and [w["rank"] for w in results]
          == list(range(nprocs)),
          f"{nprocs} workers ({backend}) exited {p.returncode} after "
          f"{time.perf_counter() - t0:.1f} s with results of ranks "
          f"{[w['rank'] for w in results]}:\n{text[-3000:]}")
    return results


def check_process_runs(workers: list, ref: dict, spec, what: str) -> dict:
    """Runs of the same configuration over several processes against one
    process driving the same mesh positions: history, Krylov counts and
    K bit for bit (for as many Picard iterations as the workers ran);
    HALO per iteration summed over the workers exactly what the hierarchy
    implies (check_halo_counts); each iteration's calls of the shard
    kernels summed over the workers, and of every other kernel on each
    worker, those of the one process. Returns what the phase prints."""
    n = len(workers[0]["history"])
    for w in workers:
        for k in ("history", "linear_iters", "K_history"):
            check(w[k] == ref[k][:n],
                  f"{what}: process {workers.index(w)} {k} {w[k]}, one "
                  f"process {ref[k][:n]}")
    halo = [{k: sum(w["halo_per_iteration"][i][k] for w in workers)
             for k in workers[0]["halo_per_iteration"][i]}
            for i in range(n)]
    check_halo_counts({"halo_per_iteration": halo,
                       "linear_iters": workers[0]["linear_iters"]}, spec,
                      what)
    order = list(kernel_counts.KERNELS)
    for i in range(n):
        want = ref["kernel_calls_per_iteration"][i]
        for j, name in enumerate(order):
            got = [w["kernel_calls_per_iteration"][i][j] for w in workers]
            ok = (sum(got) == want[j] if name in SHARD_KERNELS
                  else all(g == want[j] for g in got))
            check(ok, f"{what}: iteration {i} {name} calls {got} over the "
                  f"processes, {want[j]} on one")
    halo_kernels = [order.index(k) for k in ("multisweep_relax_halo",
                                             "multisweep_relax_halo_bf16")]
    check(all(sum(w["kernel_calls_per_iteration"][i][k]
                  for k in halo_kernels) > 0
              for w in workers for i in range(n)),
          f"{what}: a process made no halo kernel call in an iteration")
    for w in workers:
        check(all(v == 0 for v in w["plain_calls"].values()),
              f"{what}: a plain version ran: {w['plain_calls']}")
        check_one_launch(w, what)
    between = [h["bytes_between_processes"] for h in halo]
    check(all(b > 0 for b in between),
          f"{what}: no bytes between processes: {between}")
    return {"history": workers[0]["history"],
            "linear_iters": workers[0]["linear_iters"],
            "constant_K": workers[0]["constant_K"],
            "one_process_history": ref["history"][:n],
            "bit_for_bit": True,
            "bytes_between_processes_per_iteration": between,
            "messages_per_iteration": [h["messages"] for h in halo],
            "bytes_moved_per_iteration": [h["bytes_moved"] for h in halo],
            "s_per_iteration": [w["s_per_iteration"] for w in workers],
            "one_process_s_per_iteration": ref["s_per_iteration"][:n],
            "max_memory_allocated": [w["max_memory_allocated"]
                                     for w in workers],
            "one_process_max_memory_allocated": ref["max_memory_allocated"],
            "launches": {k: sum(w["launches"][k] for w in workers)
                         for k in order},
            "device_launches": {k: sum(w["device_launches"][k]
                                       for w in workers) for k in order},
            "launches_per_process": [w["launches"] for w in workers]}


def _process_spec(over, params: str, mesh):
    cfg = mgt.load_params(params, overrides=list(over))
    geom = generate_hierarchy(cfg)
    return comp.make_amr_spec(geom, cfg, mesh.home, mesh)


def phase_processes() -> dict:
    """The sharded solve over two processes on one card (gloo, tensors
    staged through host memory, each process two positions of a mesh of
    four on cuda:0): the periodic box on 4 x-slabs, the 7 levels (2
    Picard iterations) and the box's x-slabs in the bf16 tier held bit for
    bit to the runs of one process over cuda:0 named four times (the
    sharded and bf16_tier phases'; check_process_runs); and NCCL asked for
    with both processes on cuda:0 raises the port's error."""
    out = {"phase": "processes", "backend": "gloo, staged through host "
           "memory (both processes on cuda:0)", "processes": 2,
           "positions_per_process": 2}
    t0 = time.perf_counter()
    workers = spawn_workers(2, "gloo", 2, shared_card_check=True,
                            timeout_s=400)
    out["workers_s"] = time.perf_counter() - t0
    out["shared_card_errors"] = [w["shared_card_error"] for w in workers]
    check(all(e and "one card" in e for e in out["shared_card_errors"]),
          f"processes: NCCL on one shared card did not raise the port's "
          f"error: {out['shared_card_errors']}")
    out["initialize_s"] = [w["initialize_s"] for w in workers]
    for name, over, params, label in PROCESS_RUNS:
        mesh = one_card_mesh(SHARD_X)
        ref = SHARDED_REFERENCE.get(label)
        if ref is None:  # the sharded phase did not run: one process here
            ref, _ = sharded_solve(SHARDED7 if label == "sharded7" else over,
                                   label, SHARD_X, params)
            torch.cuda.empty_cache()
        spec = _process_spec(over, params, mesh)
        rec = check_process_runs([w[name] for w in workers], ref, spec,
                                 f"processes {name}")
        out[name] = {"mesh": workers[0][name]["mesh"],
                     "owners": workers[0][name]["owners"], **rec}
    PROCESS_COUNTS["processes"] = {
        k: out["periodic"][k] for k in ("launches", "device_launches")}
    PROCESS_COUNTS["bf16_processes"] = {
        k: out["periodic_bf16"][k] for k in ("launches", "device_launches")}
    # the forest's pair batched with one chunk on each process
    ref = forest_record(forest_solve(forest_process_mesh(one_card_mesh(
        (4,)))))
    out["forest"] = check_process_forest([w["forest"] for w in workers],
                                         ref)
    emit(out)
    return out


def phase_processes_cards() -> dict:
    """The sharded solve over one process per visible card (NCCL, at least
    two, started by torchrun), each process one position of the mesh the
    command line builds (main.choose_mesh): the periodic box and the 7
    levels (2 Picard iterations) held bit for bit, as in the processes
    phase, to one process driving the same cards (the mesh main.run builds
    by itself on such a host, as the cards phase), with s/iteration beside
    that run's and the unsharded run's, and each process's peak memory on
    its card."""
    n = torch.cuda.device_count()
    check(n >= 2, f"processes_cards: needs more than one card, found {n}")
    out = {"phase": "processes_cards", "backend": "nccl", "processes": n,
           "names": [torch.cuda.get_device_name(i) for i in range(n)]}
    refs = {}
    for name, over, params, _ in PROCESS_RUNS:
        cfg = mgt.load_params(params, overrides=list(over))
        cards = cli_main.choose_mesh(cfg, torch.device("cuda"))
        check(cards is not None and cards.size == n,
              f"processes_cards: main.choose_mesh gave {cards}")
        un = run_solve(over, f"{name}_unsharded", params=params)
        torch.cuda.empty_cache()
        kernel_counts.reset()
        one = run_solve(over, f"{name}_cards", params=params, mesh=cards)
        torch.cuda.empty_cache()
        refs[name] = (one, un, cards)
    t0 = time.perf_counter()
    workers = spawn_workers(n, "nccl", 0, shared_card_check=False,
                            timeout_s=600)
    out["workers_s"] = time.perf_counter() - t0
    out["initialize_s"] = [w["initialize_s"] for w in workers]
    for name, over, params, _ in PROCESS_RUNS:
        one, un, cards = refs[name]
        spec = _process_spec(over, params, cards)
        rec = check_process_runs([w[name] for w in workers], one, spec,
                                 f"processes_cards {name}")
        out[name] = {"mesh": workers[0][name]["mesh"],
                     "devices": workers[0][name]["devices"], **rec,
                     "unsharded_s_per_iteration": un["s_per_iteration"],
                     "unsharded_max_memory_allocated":
                     un["max_memory_allocated"]}
    emit(out)
    return out


# ---------------------------------------------------------------- lowdim


def phase_lowdim() -> dict:
    """ops/lowdim's 3-D V-cycle solve (the dimension-generic operators, no
    kernel) on the card against the same solve on the CPU: f64, the
    history's length, convergence below 1e-10 and the solution to 1e-12
    of its largest value."""
    from mg_ic_code_tpu_torch.ops import lowdim

    n = 32
    gen = torch.Generator().manual_seed(5)
    a = 0.5 + 1.5 * torch.rand((n, n, n), generator=gen,
                               dtype=torch.float64)
    rhs = torch.randn((n, n, n), generator=gen, dtype=torch.float64)
    kw = dict(alpha=1.0, beta=1.0, dx=1.0 / n, tol=1e-10,
              kinds=((D, D), (N, D), (P, P)))
    t0 = time.perf_counter()
    u, hist = lowdim.mg_solve(rhs, a, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    u_cpu, hist_cpu = lowdim.mg_solve(rhs, a, device="cpu", **kw)
    err = float((u.cpu() - u_cpu).abs().max() / u_cpu.abs().max())
    check(u.is_cuda and len(hist) == len(hist_cpu) and hist[-1] < 1e-10
          and err <= 1e-12,
          f"lowdim: card {hist} vs CPU {hist_cpu}, rel err {err}")
    out = {"phase": "lowdim", "shape": [n] * 3, "history": hist,
           "history_cpu": hist_cpu, "rel_err": err, "tolerance": 1e-12,
           "seconds": seconds}
    emit(out)
    return out


# --------------------------------------------------------------- summary


# the f32 kernels-phase case that holds a kernel at the shape each path
# gives it: the canonical 7-level path (scale7: the finest level for the
# wavefront, the residual and its restricted form, the largest level below
# the wavefront rung for gsrb_relax, the 64^3 depth chain for the towers)
# and the periodic box (its 256^3 top depth for the multisweep, the residual
# and the restricted residual, the depth chain from 128^3 for the towers;
# gsrb_relax and the wavefront are not on it). On the sharded paths every
# cut depth smooths through the halo kernels and takes the plain sharded
# residual, so the other kernels run only below the last cut depth: the
# towers from 16^3 (x-slabs), gsrb_relax and the restricted residual at 8^3
# (pencils), and the residual at the 4^3 bottom.
PATH_CASES = {
    "scale7": {"gsrb_relax": "path_l3_176x64x64",
               "residual": "big_960x144x144",
               "residual_restrict": "big_960x144x144",
               "tower_down": "path_l0_64",
               "tower_up": "path_l0_64",
               "wavefront_relax": "path_l6_960x144x144"},
    "periodic": {"multisweep_relax": "periodic_256",
                 "residual": "periodic_path_256",
                 "residual_restrict": "periodic_path_256",
                 "tower_down": "periodic_path_128",
                 "tower_up": "periodic_path_128"},
    # the sharded solves (phase sharded): the periodic box on 4 x-slabs and
    # on (2, 2) pencils, the 7-level hierarchy on 4 x-slabs (its finest
    # level's slab); the row-12 level shape rides with the whole-level kernel
    "sharded_x": {"multisweep_relax_halo": "slab_64x256x256_P",
                  "residual": "periodic_path_bottom_4",
                  "tower_down": "sharded_path_16_P",
                  "tower_up": "sharded_path_16_P"},
    "sharded_pencil": {"multisweep_relax_tiled_pre": "pencil_128x128x256_P",
                       "gsrb_relax": "sharded_pencil_8_P",
                       "residual_restrict": "sharded_pencil_8_P",
                       "residual": "periodic_path_bottom_4"},
    "sharded7": {"multisweep_relax_halo": "slab_240x144x144_edge",
                 "residual": "path_bottom_4", "tower_down": "sharded_path_16",
                 "tower_up": "sharded_path_16"},
    # the patches hierarchy with average_down (phase records): its largest
    # patch for gsrb_relax and the residual's two forms, the base chain for
    # the towers (no level of it takes the wavefront)
    "patches": {"gsrb_relax": "patch_d6_144", "residual": "patch_d6_144",
                "residual_restrict": "patch_d6_144",
                "tower_down": "path_l0_64", "tower_up": "path_l0_64"},
    # the same forest with its pairs batched (phase forest_batching): the
    # batched residual and the batch march at its largest pair, the batched
    # gsrb_relax at the largest pair that takes it, the single ones at its
    # largest single patch
    "forest_batching": {"gsrb_relax_batch": "batch_d5_104x96x96_pair",
                        "gsrb_relax_batch_march": "batch_d6_144_pair",
                        "residual_restrict_batch": "batch_d6_144_pair",
                        "gsrb_relax": "patch_d6_112",
                        "residual_restrict": "patch_d6_112",
                        "residual": "patch_d6_144",
                        "tower_down": "path_l0_64", "tower_up": "path_l0_64"},
}
# the bf16 tier (phase bf16_tier): the 4-level solve with average_down
# (its largest level, its base chain)
PATH_CASES["bf16_tier"] = {"gsrb_relax_bf16": "path_l3_176x64x64",
                           "tower_down_bf16": "path_l0_64",
                           "tower_up_bf16": "path_l0_64"}
# the tier on the march rungs (phase bf16_tier): scale7's finest level on
# the wave rung, the box's 256^3 on the multisweep rung, its x-slabs and
# pencils, each with the tier's kernels below the march (the towers, the
# pencils' 8^3 gsrb_relax)
PATH_CASES["bf16_scale7"] = {"wavefront_relax_bf16": "path_l6_960x144x144",
                             "gsrb_relax_bf16": "path_l3_176x64x64",
                             "tower_down_bf16": "path_l0_64",
                             "tower_up_bf16": "path_l0_64"}
PATH_CASES["bf16_periodic"] = {"multisweep_relax_bf16": "periodic_256",
                               "tower_down_bf16": "periodic_path_128",
                               "tower_up_bf16": "periodic_path_128"}
PATH_CASES["bf16_sharded_x"] = {
    "multisweep_relax_halo_bf16": "slab_64x256x256_P",
    "tower_down_bf16": "sharded_path_16_P",
    "tower_up_bf16": "sharded_path_16_P"}
PATH_CASES["bf16_sharded_pencil"] = {
    "multisweep_relax_tiled_pre_bf16": "pencil_128x128x256_P",
    "gsrb_relax_bf16": "sharded_pencil_8_P"}
# the periodic box on 4 x-slabs over two processes (phase processes): the
# kernels of the sharded x-slabs at the same shapes, launched by both; the
# same in the tier
PATH_CASES["processes"] = dict(PATH_CASES["sharded_x"])
PATH_CASES["bf16_processes"] = dict(PATH_CASES["bf16_sharded_x"])
# the processes phase's launches, summed over its processes
PROCESS_COUNTS: dict = {}
# the one-sweep and one-pass entry points, which no solver path calls: the
# kernels phase drives them (check_sweep_entry_points, SWEEP_COUNTS)
PATH_CASES["sweep_entry_points"] = {
    "gsrb_full_sweep": SWEEP_RUN_CASE, "gsrb_half_sweep": SWEEP_RUN_CASE}
# the periodic box at N = 240 (phase periodic_odd): the multisweep rung and
# the residual's two forms at its 240^3 top depth (the residual also at the
# 15^3 bottom, held by odd_periodic_15_P), its 15^3 bottom in gsrb_relax
# (the bottom's BiCGStab), the tower down to it
PATH_CASES["periodic_odd"] = {"multisweep_relax": "odd_path_240_P",
                              "residual": "odd_path_240_P",
                              "residual_restrict": "odd_path_240_P",
                              "gsrb_relax": "odd_periodic_15_P",
                              "tower_down": "odd_bottom_120_P",
                              "tower_up": "odd_bottom_120_P"}
# the same box on 4 x-slabs (phase periodic_odd): the shard march at its
# top depth's slab, gsrb_relax at 15^3 (and 30^3), the residual at the
# bottom, the restricted residual at 30^3 (the phase's held_at checks each
# shape the run gives a level kernel against the kernels-phase cases)
PATH_CASES["periodic_odd_x"] = {
    "multisweep_relax_halo": "slab_60x240x240_P",
    "gsrb_relax": "odd_periodic_15_P", "residual": "odd_periodic_15_P",
    "residual_restrict": "odd_path_30_P"}
# the path whose run gives a kernel's top-level launches
MAIN_PATH = {"multisweep_relax": "periodic",
             "multisweep_relax_halo": "sharded_x",
             "multisweep_relax_tiled_pre": "sharded_pencil",
             "gsrb_relax_batch": "forest_batching",
             "gsrb_relax_batch_march": "forest_batching",
             "residual_restrict_batch": "forest_batching",
             "gsrb_relax_bf16": "bf16_tier", "tower_down_bf16": "bf16_tier",
             "tower_up_bf16": "bf16_tier",
             "wavefront_relax_bf16": "bf16_scale7",
             "multisweep_relax_bf16": "bf16_periodic",
             "multisweep_relax_halo_bf16": "bf16_sharded_x",
             "multisweep_relax_tiled_pre_bf16": "bf16_sharded_pencil",
             "gsrb_full_sweep": "sweep_entry_points",
             "gsrb_half_sweep": "sweep_entry_points"}
MEASURED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "device_ms", "host_us")


def kernels_line(kernels: dict | None, solve: dict | None,
                 scale7: dict | None, periodic: dict | None,
                 sharded: dict | None = None,
                 records: dict | None = None) -> dict:
    """The per-kernel summary. The top-level numbers of a row are those of
    the kernel's main path: the scale7 run (the canonical full-depth path)
    or, for the multisweep kernel, which only a periodic x reaches, the
    periodic box. `paths` repeats them for EACH path the kernel is on: the
    shape that path gives it, error, time, plain time and bound at that
    shape (PATH_CASES), and the wrapper calls (launches) and kernel launches
    (device_launches) of that path's run, which was driven with the counters
    set to 0 just before; for the patches path also its wrapper calls by
    level shape). *_solve are the counts of the 4-level solve."""
    runs = {"scale7": scale7, "periodic": periodic,
            **{p: (sharded["runs"][p] if sharded else None)
               for p in ("sharded_x", "sharded_pencil", "sharded7")},
            "patches": records["runs"]["patches"] if records else None,
            "forest_batching": FOREST_COUNTS.get("forest_batching"),
            **{p: BF16_COUNTS.get(p) for p in (
                "bf16_tier", "bf16_scale7", "bf16_periodic",
                "bf16_sharded_x", "bf16_sharded_pencil")},
            "processes": PROCESS_COUNTS.get("processes"),
            "bf16_processes": PROCESS_COUNTS.get("bf16_processes"),
            "sweep_entry_points": SWEEP_COUNTS.get("sweep_entry_points"),
            "periodic_odd": ODD_COUNTS.get("periodic_odd"),
            "periodic_odd_x": ODD_COUNTS.get("periodic_odd_x")}

    def measured(name: str, path: str) -> dict:
        if kernels is None:
            return {}
        for c in kernels["checks"]:
            if (c["case"] == PATH_CASES[path].get(name)
                    and c["dtype"] == "float32" and "ms" in c.get(name, {})):
                return dict(c[name], shape=c["shape"])
        return {}

    rows = []
    for name in kernel_counts.KERNELS:
        main = MAIN_PATH.get(name, "scale7")
        paths = {}
        for path, cases in PATH_CASES.items():
            if name not in cases:
                continue
            rec, run = measured(name, path), runs[path]
            paths[path] = {
                "shape": rec.get("shape"),
                "launches": run["launches"][name] if run else None,
                "device_launches": (run["device_launches"][name] if run
                                    else None),
                **{k: rec.get(k) for k in MEASURED},
                # sweeps per timed call, where the kernel takes a count; the
                # launch's form and blocks, where the kernel has forms; the
                # f32 form's times beside the bf16 tier's
                **{k: rec[k] for k in ("nsweeps", "form", "blocks", "f32_ms",
                                       "f32_device_ms", "f32_host_us",
                                       "wall_ms", "reached")
                   if k in rec}}
            if run and name in run.get("by_shape", {}):
                paths[path]["calls_by_shape"] = run["by_shape"][name]
        top = paths[main]
        forms = ENTRY_POINTS.get(name, {})
        rows.append({
            "name": name, "route": "cuda",
            # where the kernel has forms in several sources: the source of
            # the form its main path's case takes
            "source": forms.get(top.get("form"), SOURCES[name])[0],
            "replaces": SOURCES[name][1], "tpu_kernel": TPU_KERNELS[name],
            "launches": top["launches"],
            "device_launches": top["device_launches"], "launches_of": main,
            "launches_solve": solve["launches"][name] if solve else None,
            "device_launches_solve": (solve["device_launches"][name]
                                      if solve else None),
            **{k: top[k] for k in MEASURED}, "library_ms": None,
            "shape": top["shape"], "dtype": "float32",
            **{k: top[k] for k in ("nsweeps", "form", "blocks") if k in top},
            "paths": paths,
        })
        if forms:  # every form's source and C entry point
            rows[-1]["entry_points"] = {
                form: {"source": src, "entry": entry}
                for form, (src, entry) in forms.items()}
    return {"kernels": rows}


PHASES = ("env", "build", "kernels", "solve", "lock3", "scale7", "records",
          "forest_batching", "bf16_tier", "periodic", "periodic_odd", "cli",
          "sharded", "processes", "lowdim")
# asked for by name only: the default run needs one card
ON_REQUEST = ("cards", "processes_cards")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + ON_REQUEST))
    # one process of the processes phases (process_worker), started by them
    # under torchrun
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--positions", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--shared-card-check", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        if not torch.cuda.is_available():
            print("chip_smoke worker: no CUDA device available",
                  file=sys.stderr)
            return 1
        return process_worker(args)
    wanted = [p for p in args.phases.split(",") if p]
    unknown = [p for p in wanted if p not in PHASES + ON_REQUEST]
    if unknown:
        print(f"unknown phases {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    fns = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
           "solve": phase_solve, "lock3": phase_lock3,
           "scale7": phase_scale7, "records": phase_records,
           "forest_batching": phase_forest_batching,
           "bf16_tier": phase_bf16_tier,
           "periodic": phase_periodic,
           "periodic_odd": phase_periodic_odd,
           "cli": phase_cli, "sharded": phase_sharded,
           "processes": phase_processes,
           "lowdim": phase_lowdim, "cards": phase_cards,
           "processes_cards": phase_processes_cards}
    done: dict = {}
    try:
        with torch.no_grad():
            for name in PHASES + ON_REQUEST:
                if name in wanted:
                    done[name] = fns[name]()
        bad = [m for m in sys.modules
               if m in ("jax", "jaxlib", "mg_ic_code_tpu")
               or m.startswith(("jax.", "mg_ic_code_tpu."))]
        check(not bad, f"foreign modules were imported: {bad}")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    emit({"phase": "done", "phases": wanted,
          "seconds": round(time.perf_counter() - t_start, 1)})
    line = kernels_line(done.get("kernels"), done.get("solve"),
                        done.get("scale7"), done.get("periodic"),
                        done.get("sharded"), done.get("records"))
    if set(PHASES) <= set(wanted):
        never = [f"{r['name']} ({path})" for r in line["kernels"]
                 for path, rec in r["paths"].items() if not rec["launches"]]
        if never:
            print(f"chip_smoke FAILED: never launched on its main path: "
                  f"{never}", file=sys.stderr)
            return 1
    emit(line)
    card = done["env"]["card"] if "env" in done else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
