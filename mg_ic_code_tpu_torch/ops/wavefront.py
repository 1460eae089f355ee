"""Time-skewed (wavefront) GSRB multisweep: CUDA kernel + plain version.

Counterpart of the JAX package's ops/wavefront.py (`wavefront_relax` and
its flattened-layout twin `wavefront_relax_flat`: two memory layouts of one
function there, one kernel here). It computes exactly what
`fused_sweeps.gsrb_relax` computes — `nsweeps` red-black sweeps with the
homogeneous ghost rules folded into per-cell weights, constant bCoef — for
levels with non-periodic x, but in ONE kernel launch per call: the
2*nsweeps colour passes are carried along x in shared memory
(csrc/wavefront.cu), so a level too big to stay in the card's L2 cache
between passes is read from device memory about once instead of once per
pass.

  * `wavefront_relax`       — CUDA tensors go to the kernel or raise; CPU
                              tensors take the plain version.
  * `wavefront_relax_plain` — the plain PyTorch version. The function is
                              the same as `gsrb_relax`'s, so the two plain
                              versions share one body
                              (`fused_sweeps.gsrb_sweeps_folded`).
  * `wavefront_supported`, `wavefront_plan` — which level takes this rung
                              and in which chunks, in the card's own terms.
"""

from __future__ import annotations

import math

import torch

from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
from mg_ic_code_tpu_torch.ops.ghosts import PERIODIC, FaceKinds

# sweeps one launch can carry (csrc/wavefront.cu instantiates 4 and 8 passes)
CHUNKS = (2, 4)
# what the solver sends per launch: 4 smooths go as two launches of 2
PLAN_CHUNK = 2

# A level whose four arrays (u, rhs, a and the result) fit the card's L2
# cache (50 MB on the H100) stays there between the colour passes of
# `gsrb_relax`: its passes never reach device memory and the skew has
# nothing to save. A level above that takes the wavefront rung. Of the
# canonical 7-level hierarchy that is 512x96x96 (75 MB) and 960x144x144
# (318 MB), and the 256^3 bench level (268 MB); 272x80x80 (28 MB) and
# below stay with `gsrb_relax`.
L2_BYTES = 50 << 20

def wavefront_supported(shape, nsweeps: int, kinds: FaceKinds | None,
                        itemsize: int = 4) -> bool:
    """Levels the wavefront rung takes: non-periodic x (the front is
    sequential in x), even extents on periodic y/z axes (a tile wraps them),
    a chunk the kernel is built for, and a level whose arrays do not fit
    the L2 cache."""
    if kinds is None or kinds[0][0] == PERIODIC:
        return False
    if nsweeps not in CHUNKS:
        return False
    if any(kinds[ax][0] == PERIODIC and shape[ax] % 2 for ax in (1, 2)):
        return False
    return 4 * math.prod(shape) * itemsize > L2_BYTES


def wavefront_plan(shape, n: int, kinds: FaceKinds | None,
                   itemsize: int = 4):
    """Sweeps per launch for n sweeps of this level, or None when the level
    does not take the wavefront rung (n odd, or not supported)."""
    if n <= 0 or n % PLAN_CHUNK:
        return None
    if not wavefront_supported(shape, PLAN_CHUNK, kinds, itemsize):
        return None
    return PLAN_CHUNK


def wavefront_relax_plain(
    u, rhs, a, *, nsweeps: int, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo,
):
    """The plain PyTorch version of `wavefront_relax`: the sweeps in their
    natural order, every pass over the whole level (the skew changes where
    the data lives, not what is computed)."""
    kernel_counts.PLAIN_CALLS["wavefront_relax"] += 1
    return fs.gsrb_sweeps_folded(
        u, rhs, a, None, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo,
    )


def wavefront_relax(
    u, rhs, a, *, nsweeps: int, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo,
):
    """nsweeps (2 or 4) red-black GSRB sweeps of a whole level with
    homogeneous ghosts and constant bCoef, x not periodic, in one kernel
    launch. Returns a new tensor. CUDA tensors go to the kernel; CPU
    tensors take the plain version."""
    if kinds[0][0] == PERIODIC:
        raise ValueError("wavefront_relax: x must not be periodic")
    if nsweeps not in CHUNKS:
        raise ValueError(
            f"wavefront_relax: nsweeps {nsweeps} not in {CHUNKS}")
    if u.device.type == "cpu":
        return wavefront_relax_plain(
            u, rhs, a, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
            beta=beta, dx=dx, lo=lo,
        )
    fs.check_level_args("wavefront_relax", u, rhs, a)
    for ax in (1, 2):
        if kinds[ax][0] == PERIODIC and u.shape[ax] % 2:
            raise ValueError(
                "wavefront_relax: a periodic axis needs an even extent, "
                f"got {tuple(u.shape)}")
    lib = cuda_ext.lib()
    out = torch.empty_like(u)  # the kernel reads u and writes out
    nx, ny, nz = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_counts.count_launch("wavefront_relax", 1)
        err = lib.mgk_wavefront_relax(
            u.data_ptr(), rhs.data_ptr(), a.data_ptr(), out.data_ptr(),
            int(u.dtype == torch.float64), nx, ny, nz, fs.kinds_array(kinds),
            float(rho), float(alpha), float(beta), float(dx), int(sum(lo)),
            int(nsweeps), stream,
        )
    cuda_ext.check(err, "wavefront_relax")
    return out
