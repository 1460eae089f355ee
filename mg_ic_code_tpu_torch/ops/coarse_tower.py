"""Coarse-depth V-cycle tower: a whole chain of MG depths as a down pass,
the bottom solve, and an up pass.

  * `tower_down` — for each tower depth, nsmooth pre-smooth sweeps (the
    GSRB relaxation of ops/fused_sweeps) then the fused residual +
    full-weighting restriction to the next depth, whose state starts at
    zero; the BOTTOM depth is pre-smoothed too (the staged mg_vcycle
    relaxes every depth before bottom_solve). Returns every depth's
    pre-smoothed state and restricted rhs.
  * the bottom solve stays plain PyTorch between the two
    (multigrid.bottom_solve — the dense inverse product + one refinement
    step, or the preconditioned BiCGStab).
  * `tower_up` — from the bottom solution upward, piecewise-constant
    prolongation increment then nsmooth post-smooth sweeps per depth.

Each of the two is one C call that enqueues its whole chain of CUDA
launches (csrc/tower.cu) for CUDA tensors, and a plain PyTorch version
(`tower_down_plain` / `tower_up_plain`) that the wrappers take only for CPU
tensors. The per-depth math is the same the staged path runs, so the tower
matches the per-depth V-cycle to reorder tolerance.

Reference structure this fuses: the MG depth recursion AMRMultiGrid drives
through VariableCoeffPoissonOperator::levelGSRB / restrictResidual /
prolongIncrement.
"""

from __future__ import annotations

import ctypes

import torch

from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
from mg_ic_code_tpu_torch.ops import stencils as st


def _restrict_pairs(f: torch.Tensor) -> torch.Tensor:
    """2x full-weighting coarsening in the tower's pairing order: x pairs,
    then z pairs carrying the single 2^-3 scale, then y pairs — the same
    2^3-average values as stencils.restrict_full in another summation
    order (children indexed directly)."""
    t = f[0::2] + f[1::2]
    t = 0.125 * t[:, :, 0::2] + 0.125 * t[:, :, 1::2]
    return t[:, 0::2] + t[:, 1::2]


def _relax_kw(spec, d: int, k: int) -> dict:
    return dict(
        nsweeps=spec.nsmooth, kinds=spec.kinds, rho=spec.rho[d + k],
        alpha=spec.alpha, beta=spec.beta, dx=spec.dx[d + k],
        lo=spec.boxes[d + k].lo,
    )


def tower_down_plain(spec, d: int, u, rhs, a_list):
    """Plain PyTorch down pass over depths [d, end). Returns
    (u_list[0..ndep-2], rhs_list[1..ndep-1], u_bot)."""
    kernel_counts.PLAIN_CALLS["tower_down"] += 1
    ndep = spec.ndepths - d
    u_outs, r_outs = [], []
    for k in range(ndep - 1):
        kw = _relax_kw(spec, d, k)
        u = fs.gsrb_relax_plain(u, rhs, a_list[k], **kw)
        u_outs.append(u)
        kw.pop("nsweeps"), kw.pop("lo")
        res = fs.residual_plain(u, rhs, a_list[k], **kw)
        rhs = _restrict_pairs(res)
        r_outs.append(rhs)
        u = torch.zeros_like(rhs)
    u_bot = fs.gsrb_relax_plain(
        u, rhs, a_list[ndep - 1], **_relax_kw(spec, d, ndep - 1)
    )
    return u_outs, r_outs, u_bot


def tower_up_plain(spec, d: int, e_bot, u_list, rhs_list, a_list):
    """Plain PyTorch up pass: prolong-increment + post-smooth per depth,
    from the bottom correction to depth d. Returns the depth-d state."""
    kernel_counts.PLAIN_CALLS["tower_up"] += 1
    ndep = spec.ndepths - d
    e = e_bot
    for k in range(ndep - 2, -1, -1):
        u = st.prolong_inc(u_list[k], e)
        e = fs.gsrb_relax_plain(
            u, rhs_list[k], a_list[k], **_relax_kw(spec, d, k)
        )
    return e


def tower_supported(spec, coefs, d: int) -> bool:
    """Whether the depth sub-chain [d, end) can run as the tower: V-cycle
    shape (num_mg == 1 — a W-cycle's recursion tree interleaves bottom
    solves), constant bCoef, at least 2 depths below d, every tower shape
    even-coarsenable. (The card has no residency limit, so no size term.)"""
    if spec.num_mg != 1 or coefs["b"][d] is not None:
        return False
    ndep = spec.ndepths - d
    if ndep < 3:
        return False
    for dd in range(d, spec.ndepths - 1):
        sh = spec.boxes[dd].shape
        if any(s % 2 for s in sh) or any(s < 4 for s in sh):
            return False
    return True


def _chain_args(spec, d: int, ndep: int):
    """Static per-depth arguments of the C entry points."""
    shapes = [s for k in range(ndep) for s in spec.boxes[d + k].shape]
    return dict(
        shapes=(ctypes.c_int * (3 * ndep))(*shapes),
        kinds=fs.kinds_array(spec.kinds),
        dxs=(ctypes.c_double * ndep)(*[float(x) for x in spec.dx[d:d + ndep]]),
        rhos=(ctypes.c_double * ndep)(
            *[float(x) for x in spec.rho[d:d + ndep]]
        ),
        bases=(ctypes.c_int * ndep)(
            *[int(sum(spec.boxes[d + k].lo)) for k in range(ndep)]
        ),
    )


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_chain(name: str, spec, d: int, groups):
    """Every tensor of depth k has the depth's shape; one dtype/device."""
    ref = groups[0][0]
    for tensors in groups:
        for k, t in enumerate(tensors):
            fs.check_level_args(name, t)
            if (tuple(t.shape) != tuple(spec.boxes[d + k].shape)
                    or t.dtype != ref.dtype or t.device != ref.device):
                raise ValueError(
                    f"{name}: depth {d + k} operand {tuple(t.shape)} "
                    f"{t.dtype} {t.device} does not match the depth chain"
                )


def tower_down(spec, d: int, u, rhs, a_list):
    """Down pass over depths [d, end): (u_list[0..ndep-2],
    rhs_list[1..ndep-1], u_bot). CUDA tensors go to the kernels, CPU
    tensors take the plain version."""
    if u.device.type == "cpu":
        return tower_down_plain(spec, d, u, rhs, a_list)
    ndep = spec.ndepths - d
    a_list = list(a_list)
    _check_chain("tower_down", spec, d, [[u], [rhs], a_list])
    lib = cuda_ext.lib()
    shapes = [tuple(spec.boxes[d + k].shape) for k in range(ndep)]
    # the kernels sweep in place: depth 0 starts from a copy of the
    # caller's u, coarser depths from zero
    us = [u.clone()] + [
        torch.zeros(shapes[k], dtype=u.dtype, device=u.device)
        for k in range(1, ndep)
    ]
    rs = [rhs] + [
        torch.empty(shapes[k], dtype=u.dtype, device=u.device)
        for k in range(1, ndep)
    ]
    ca = _chain_args(spec, d, ndep)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_counts.count_launch(
            "tower_down", ndep * 2 * int(spec.nsmooth) + ndep - 1)
        err = lib.mgk_tower_down(
            _ptrs(us), _ptrs(rs), _ptrs(a_list),
            int(u.dtype == torch.float64), ndep, ca["shapes"], ca["kinds"],
            ca["dxs"], ca["rhos"], ca["bases"], float(spec.alpha),
            float(spec.beta), int(spec.nsmooth), stream,
        )
    cuda_ext.check(err, "tower_down")
    return us[:-1], rs[1:], us[-1]


def tower_up(spec, d: int, e_bot, u_list, rhs_list, a_list):
    """Up pass from the bottom correction to depth d; returns the depth-d
    state. CUDA tensors go to the kernels, CPU tensors take the plain
    version."""
    if e_bot.device.type == "cpu":
        return tower_up_plain(spec, d, e_bot, u_list, rhs_list, a_list)
    ndep = spec.ndepths - d
    u_list, rhs_list, a_list = list(u_list), list(rhs_list), list(a_list)
    if not (len(u_list) == len(rhs_list) == len(a_list) == ndep - 1):
        raise ValueError("tower_up: need ndep-1 arrays of u, rhs and a")
    _check_chain("tower_up", spec, d, [u_list, rhs_list, a_list])
    fs.check_level_args("tower_up", e_bot)
    if (tuple(e_bot.shape) != tuple(spec.boxes[spec.ndepths - 1].shape)
            or e_bot.dtype != u_list[0].dtype
            or e_bot.device != u_list[0].device):
        raise ValueError("tower_up: e_bot does not match the bottom depth")
    lib = cuda_ext.lib()
    us = [t.clone() for t in u_list]  # swept in place
    ca = _chain_args(spec, d, ndep)
    with torch.cuda.device(e_bot.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_counts.count_launch(
            "tower_up", (ndep - 1) * (1 + 2 * int(spec.nsmooth)))
        err = lib.mgk_tower_up(
            e_bot.data_ptr(), _ptrs(us), _ptrs(rhs_list), _ptrs(a_list),
            int(e_bot.dtype == torch.float64), ndep, ca["shapes"],
            ca["kinds"], ca["dxs"], ca["rhos"], ca["bases"],
            float(spec.alpha), float(spec.beta), int(spec.nsmooth), stream,
        )
    cuda_ext.check(err, "tower_up")
    return us[0]


def tower_vcycle(spec, coefs, d: int, u, rhs):
    """The V-cycle over depths [d, end) as down pass -> bottom solve -> up
    pass. Call only when tower_supported(spec, coefs, d); the result
    matches the staged per-depth mg_vcycle to reorder tolerance."""
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    ndep = spec.ndepths - d
    a_list = [coefs["a"][d + k] for k in range(ndep)]
    # the down pass smooths the caller's u against rhs first, and also
    # pre-smooths the BOTTOM depth exactly as the staged mg_vcycle does
    # before bottom_solve
    u_list, rhs_rest, u_bot = tower_down(spec, d, u, rhs, a_list)
    rhs_list = [rhs] + list(rhs_rest)
    e_bot = mg.bottom_solve(
        spec, coefs, spec.ndepths - 1, u_bot, rhs_list[-1]
    )
    return tower_up(
        spec, d, e_bot, list(u_list), rhs_list[:-1], a_list[:-1]
    )
