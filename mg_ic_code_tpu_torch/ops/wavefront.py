"""Time-skewed (wavefront) GSRB multisweep: CUDA kernel + plain version.

Counterpart of the JAX package's ops/wavefront.py (`wavefront_relax` and
its flattened-layout twin `wavefront_relax_flat`: two memory layouts of one
function there, one kernel here). It computes exactly what
`fused_sweeps.gsrb_relax` computes — `nsweeps` red-black sweeps with the
homogeneous ghost rules folded into per-cell weights, constant bCoef — for
levels with non-periodic x, but in ONE kernel launch per call: the
2*nsweeps colour passes are carried along x in shared memory, so a level
too big to stay in the card's L2 cache between passes is read from device
memory about once instead of once per pass.

The kernel is the one of `fused_sweeps.multisweep_relax`
(csrc/multisweep.cu): with x open its march starts the skew from the x
faces, which is this function; a periodic x only opens both ends of every
x segment. On the TPU the two are different schedules and five kernels; on
the card a separate build of the march without the periodic-x code ran
within 3 % of this one, so there is one kernel behind two wrappers, each
counted under its own name.

  * `wavefront_relax`       — CUDA tensors go to the kernel or raise; CPU
                              tensors take the plain version. Both take
                              the bf16 tier (`compute_dtype`), as
                              `fused_sweeps` says.
  * `wavefront_relax_plain` — the plain PyTorch version. The function is
                              the same as `gsrb_relax`'s, so the plain
                              versions share one body
                              (`fused_sweeps.gsrb_sweeps_folded`).
  * `wavefront_supported`, `wavefront_plan` — which level takes this rung
                              and in which chunks: `fused_sweeps`'
                              multisweep predicate, for x open.
"""

from __future__ import annotations

from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops.ghosts import PERIODIC, FaceKinds

# sweeps one launch can carry, and what the solver sends per launch (4
# smooths go as two launches of 2): the kernel's own
CHUNKS = fs.MULTISWEEP_CHUNKS
PLAN_CHUNK = fs.MULTISWEEP_PLAN_CHUNK

# A level whose four arrays fit the card's L2 cache (fused_sweeps.L2_BYTES)
# stays with `gsrb_relax`; a level above that takes the wavefront rung. Of
# the canonical 7-level hierarchy that is 512x96x96 (75 MB) and 960x144x144
# (318 MB), and the 256^3 bench level (268 MB); 272x80x80 (28 MB) and
# below stay with `gsrb_relax`.


def _x_open(kinds: FaceKinds | None) -> bool:
    return kinds is not None and kinds[0][0] != PERIODIC


def wavefront_supported(shape, nsweeps: int, kinds: FaceKinds | None,
                        itemsize: int = 4) -> bool:
    """Levels the wavefront rung takes: non-periodic x, and what
    `fused_sweeps.multisweep_supported` asks of any level (even extents on
    periodic y/z axes, a chunk the kernel is built for, arrays that do not
    fit the L2 cache)."""
    return _x_open(kinds) and fs.multisweep_supported(shape, nsweeps, kinds,
                                                      itemsize)


def wavefront_plan(shape, n: int, kinds: FaceKinds | None,
                   itemsize: int = 4):
    """Sweeps per launch for n sweeps of this level, or None when the level
    does not take the wavefront rung (n odd, or not supported)."""
    if not _x_open(kinds):
        return None
    return fs.multisweep_plan(shape, n, kinds, itemsize)


def wavefront_relax_plain(
    u, rhs, a, *, nsweeps: int, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo, compute_dtype=None, _where: bool = False,
):
    """The plain PyTorch version of `wavefront_relax`: the sweeps in their
    natural order, every pass over the whole level (the skew changes where
    the data lives, not what is computed); in the bf16 tier counted under
    wavefront_relax_bf16 (`compute_dtype`, `_where` as
    fused_sweeps.gsrb_sweeps_folded's)."""
    kernel_counts.PLAIN_CALLS[fs.tier_name("wavefront_relax",
                                           compute_dtype)] += 1
    return fs.gsrb_sweeps_folded(
        u, rhs, a, None, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo, compute_dtype=compute_dtype, _where=_where,
    )


def wavefront_relax(
    u, rhs, a, *, nsweeps: int, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo, compute_dtype=None,
):
    """nsweeps (2 or 4) red-black GSRB sweeps of a whole level with
    homogeneous ghosts and constant bCoef, x not periodic, in one kernel
    launch. Returns a new tensor. CUDA tensors go to the kernel; CPU
    tensors take the plain version. `compute_dtype` "bfloat16": the bf16
    tier (f32 operands; raises otherwise), counted under
    wavefront_relax_bf16."""
    if kinds[0][0] == PERIODIC:
        raise ValueError("wavefront_relax: x must not be periodic")
    if nsweeps not in CHUNKS:
        raise ValueError(
            f"wavefront_relax: nsweeps {nsweeps} not in {CHUNKS}")
    fs.check_tier("wavefront_relax", u, None, compute_dtype)
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha, beta=beta,
              dx=dx, lo=lo, compute_dtype=compute_dtype)
    if u.device.type == "cpu":
        return wavefront_relax_plain(u, rhs, a, **kw)
    return fs.multisweep_launch("wavefront_relax", u, rhs, a, **kw)
