"""Whole-level GSRB relaxation and residual: CUDA kernels + plain versions.

The hot loop of the solver (reference: GSRBHELMHOLTZVC3D, executed
numMGsmooth smooths x 2 colours x depths x V-cycles x Krylov iterations)
and the residual that feeds restriction, each as

  * a hand-written CUDA kernel (csrc/gsrb_relax.cu: every sweep of a call
    in one cooperative launch, in the form and grid `gsrb_geometry` picks;
    csrc/residual.cu: a march along x in the tiles and segments
    `residual_geometry` picks), launched by `gsrb_relax` / `residual` for
    tensors on a CUDA device, and
  * a plain PyTorch version (`gsrb_relax_plain` / `residual_plain`) written
    from the same folded form, which the wrappers take ONLY for tensors on
    the CPU. On a CUDA tensor a wrapper launches its kernel or raises.

`residual_restrict` is the residual restricted by full weighting in the
same launch (the restriction that follows every residual the V-cycles
restrict); its plain version is `restrict_full` of `residual_plain`.

`gsrb_relax_batch` / `residual_restrict_batch` take the same-shape sibling
patches of an AMR depth (solver/composite.py's batch groups) as ONE launch
of the same kernel, each patch by its own pointers (or, where the patches
overflow the L2 cache, of the batch march, csrc/gsrb_batch_march.cu: the
march of `multisweep_relax` with `gsrb_relax`'s arithmetic); their plain
versions are the single ones patch by patch, and a batch is bit for bit
the single calls.

Beside them:

  * `multisweep_relax` (csrc/multisweep.cu): the same sweeps as
    `gsrb_relax` for constant bCoef in ONE launch per chunk of 2 or 4
    sweeps, the halo recomputed, for any face kinds including periodic x.
    It is the one counterpart of the JAX package's
    `multisweep_relax_pipelined`, `multisweep_relax_flat_pipelined` and
    `multisweep_relax_tiled` (one function in three TPU tilings), and the
    smoother of levels with periodic x that are too big for the L2 cache.
    `ops/wavefront.wavefront_relax` is the same kernel with x open.
  * `gsrb_full_sweep` / `gsrb_half_sweep` (csrc/gsrb_sweep.cu): one sweep
    / one colour pass in ONE launch, out of place (the JAX package's
    `pallas_kernels.gsrb_full_sweep` / `gsrb_half_sweep`): a half sweep one
    coalesced streaming pass, a full sweep red and black in one march along
    x (or gsrb_relax's grid form), in the form `sweep_geometry` picks.

All work on any level shape (the card has no residency limit) in f32 or
f64, with the homogeneous ghost rules of the six faces folded into per-cell
weights: because every rule is linear in the two interior planes
(ghost = c0*u0 + c1*u1), the GSRB update of a cell collapses to

    u <- K*u + T + sum_axis (PA * u_plus + PB * u_minus)

with P = lam*beta/dx^2 (times bCoef when it varies), PA/PB = P times
(0 across a non-periodic face, 1+c1 at it, 1 inside), K carrying the c0
feed-through, T = lam*rhs. A colour pass p keeps the cells with
(i+j+k+sum(lo)+p) odd and updates the others.

The bf16 tier (`compute_dtype = "bfloat16"`, the spec's smoother_compute
under `smoother_precision = bfloat16`): `gsrb_relax` and the marches
(`multisweep_relax`, its `halo=` form, `multisweep_relax_tiled_pre`,
`wavefront.wavefront_relax`) of an f32 level with constant b run their
colour passes in bf16, as the JAX package's resident_relax_values and its
fused families do: the fold (P, PA/PB, K, T) in f32 and rounded to bf16
once, the state rounded to bf16 where the call starts, every pass's
operation in bf16, the result cast back to f32. Every kernel of the tier
computes one update (csrc/gsrb_device.cuh: gsrb_update_bf16), so each is
its twin `gsrb_sweeps_folded(compute_dtype="bfloat16", _where=True)` bit
for bit; the x faces fold as the others do (the JAX slab and wavefront
bodies re-derive a bf16 x ghost row instead, within their contract of it).
Launches are counted under the kernel's name with `_bf16` (`tier_name`).
The residual, the restriction and the batched forms take no tier.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts
from mg_ic_code_tpu_torch.ops.stencils import restrict_full
from mg_ic_code_tpu_torch.ops.ghosts import (
    CF, PERIODIC, PHYS_DIRICHLET, PHYS_NEUMANN, FaceKinds, cf_homog_weights,
    ghost_plane,
)

# face kind codes shared with csrc/mg_kernels.h
_KIND_CODE = {PHYS_DIRICHLET: 0, PHYS_NEUMANN: 1, PERIODIC: 2, CF: 3}

# The card's L2 cache (50 MB on the H100). A level whose four arrays (u,
# rhs, a and the result) fit it stays there between the colour passes of
# `gsrb_relax`: its passes never reach device memory and a one-launch
# multisweep has nothing to save. The one size term of the dispatch: the
# wavefront and multisweep rungs take levels above it, and the coarse tower
# starts at the first depth below it.
L2_BYTES = 50 << 20


def exceeds_l2(shape, itemsize: int = 4) -> bool:
    """Whether the four arrays of a level do not fit the L2 cache."""
    return 4 * math.prod(shape) * itemsize > L2_BYTES


def _ghost_lin(kind: str, rho: float) -> tuple[float, float]:
    """(c0, c1) with ghost = c0*u0 + c1*u1 — the homogeneous ghost rules
    of ghosts.ghost_plane are all linear in the two interior planes."""
    if kind == PHYS_DIRICHLET:
        return -2.0, 1.0 / 3.0
    if kind == PHYS_NEUMANN:
        return 1.0, 0.0
    if kind == CF:
        return cf_homog_weights(rho)
    raise AssertionError(kind)


def _iota(shape, axis: int, device) -> torch.Tensor:
    """Index along `axis`, broadcastable against `shape`."""
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return torch.arange(
        shape[axis], dtype=torch.int32, device=device
    ).view(view)


def _fold_coefs(rv, av, *, kinds: FaceKinds, rho: float, alpha: float,
                beta: float, dx: float, bv=None):
    """Folded update coefficients (P, {axis: (PA, PB)}, K, T) of a whole
    level — see the module docstring. Periodic axes keep PA/PB None
    (wrapped rolls are exact) and pay P instead."""
    dt, dev, shape = av.dtype, av.device, av.shape
    b_inv = beta * (1.0 / (dx * dx))
    # lambda keeps the reference's bCoef~1 diagonal approximation
    diag = alpha * av + 6.0 * b_inv
    lam = 1.0 / diag
    # variable bCoef multiplies the whole Laplacian at the update point
    # (cell-centred, not flux form), so it folds into P as a field
    P = lam * b_inv if bv is None else lam * b_inv * bv
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    pab = {}
    c_sum = None
    for axis in (0, 1, 2):
        if kinds[axis][0] == PERIODIC:
            pab[axis] = (None, None)
            continue
        n_ax = shape[axis]
        c0l, c1l = _ghost_lin(kinds[axis][0], rho)
        c0h, c1h = _ghost_lin(kinds[axis][1], rho)
        idx = _iota(shape, axis, dev)
        is_lo = idx == 0
        is_hi = idx == n_ax - 1
        a_vp = torch.where(is_hi, zero, torch.where(is_lo, one + c1l, one))
        b_vm = torch.where(is_lo, zero, torch.where(is_hi, one + c1h, one))
        c_ax = (torch.where(is_lo, torch.full((), c0l, dtype=dt, device=dev),
                            zero)
                + torch.where(is_hi, torch.full((), c0h, dtype=dt, device=dev),
                              zero))
        pab[axis] = (P * a_vp, P * b_vm)
        c_sum = c_ax if c_sum is None else c_sum + c_ax
    k_uc = (1.0 - lam * (alpha * av)) + P * (
        (c_sum - 6.0) if c_sum is not None else -6.0
    )
    return P, pab, k_uc, lam * rv


def compute_type(compute_dtype):
    """The colour passes' arithmetic type of a `compute_dtype` (the spec's
    smoother_compute): None for the operands' own, torch.bfloat16 for
    "bfloat16" (or torch.bfloat16); raises on anything else."""
    if compute_dtype is None:
        return None
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"compute_dtype {compute_dtype!r} (None or bfloat16)")


def tier_name(name: str, compute_dtype) -> str:
    """The counter of a kernel's launches in the tier: `name` at the
    operands' precision, `name`_bf16 in the bf16 tier."""
    return name if compute_type(compute_dtype) is None else name + "_bf16"


def check_tier(name: str, u, b, compute_dtype) -> None:
    """The bf16 tier takes f32 levels with constant b only (the path never
    sends it another; a silent f32 sweep would hide the fault)."""
    if compute_type(compute_dtype) is None:
        return
    if u.dtype != torch.float32:
        raise TypeError(f"{name}: the bf16 tier takes float32 levels, got "
                        f"{u.dtype}")
    if b is not None:
        raise ValueError(f"{name}: the bf16 tier takes constant b only")


def _parity(shape, dtype, base: int, device) -> torch.Tensor:
    """(i+j+k+base)&1 as a float mask."""
    ii = _iota(shape, 0, device)
    jj = _iota(shape, 1, device)
    kk = _iota(shape, 2, device)
    return ((ii + jj + kk + base) & 1).to(dtype)


def gsrb_sweeps_folded(
    u, rhs, a, b=None, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, lo, colors=None,
    compute_dtype=None, _where: bool = False,
):
    """nsweeps red-black sweeps of a whole level in plain PyTorch, from the
    folded form (the arithmetic of the kernels, operation for operation).
    `colors`, when given, is the sequence of colour passes to run instead
    (colour c updates the cells with (i+j+k+sum(lo)+c) even). The body of
    every plain version of a GSRB kernel; it counts nothing.

    `compute_dtype` "bfloat16": the bf16 tier, the twin of the JAX
    package's resident_relax_values with that compute_dtype: the fold in
    f32, each folded term and the state rounded to bf16 once,
    the passes in bf16 (each torch op rounding), the colour select kept
    arithmetic as there, the result cast back to u's dtype.

    `_where`: a pass leaves the cells of the other colour as they are (a
    select, not the arithmetic s = acc + par * (s - acc), which in bf16
    moves a kept cell by an ulp of acc): the kernels' own colour select,
    against which a kernel of the tier is held bit for bit."""
    cdt = compute_type(compute_dtype)
    if cdt is not None:  # the fold in f32, as the JAX body's
        rhs, a = rhs.float(), a.float()
        b = None if b is None else b.float()
    P, pab, k_uc, t_rhs = _fold_coefs(
        rhs, a, kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx, bv=b,
    )
    s = u
    if cdt is not None:
        cast = lambda x: None if x is None else x.to(cdt)  # noqa: E731
        P, k_uc, t_rhs = cast(P), cast(k_uc), cast(t_rhs)
        pab = {ax: (cast(pa), cast(pb)) for ax, (pa, pb) in pab.items()}
        s = u.to(cdt)
    par0 = _parity(s.shape, s.dtype, sum(lo), s.device)
    pars = (par0, 1.0 - par0)
    for p in (range(2 * nsweeps) if colors is None else colors):
        acc = k_uc * s + t_rhs
        for axis in (0, 1, 2):
            pa, pb = pab[axis]
            vp = torch.roll(s, -1, axis)
            vm = torch.roll(s, 1, axis)
            acc = (acc + P * (vp + vm) if pa is None
                   else acc + pa * vp + pb * vm)
        s = (torch.where(pars[p & 1] != 0, s, acc) if _where
             else acc + pars[p & 1] * (s - acc))
    return s if cdt is None else s.to(u.dtype)


def gsrb_relax_plain(
    u, rhs, a, b=None, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, lo, compute_dtype=None,
    _where: bool = False,
):
    """The plain PyTorch version of `gsrb_relax` (and of its bf16 tier,
    counted under gsrb_relax_bf16; `_where` as gsrb_sweeps_folded's)."""
    kernel_counts.PLAIN_CALLS[tier_name("gsrb_relax", compute_dtype)] += 1
    return gsrb_sweeps_folded(
        u, rhs, a, b, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo, compute_dtype=compute_dtype, _where=_where,
    )


def gsrb_relax_batch_plain(
    us, rhss, as_, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, los,
):
    """The plain PyTorch version of `gsrb_relax_batch`: the sweeps of
    each patch (its lo `los[k]`), as gsrb_relax_plain."""
    kernel_counts.PLAIN_CALLS["gsrb_relax_batch"] += 1
    return [gsrb_sweeps_folded(
        u, rhs, a, None, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo) for u, rhs, a, lo in zip(us, rhss, as_, los)]


def multisweep_relax_plain(
    u, rhs, a, *, nsweeps: int, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo, compute_dtype=None, _where: bool = False,
):
    """The plain PyTorch version of `multisweep_relax`: the sweeps in their
    natural order, every pass over the whole level (tiling and halo
    recomputation change where the data lives, not what is computed); in
    the bf16 tier counted under multisweep_relax_bf16 (`compute_dtype`,
    `_where` as gsrb_sweeps_folded's)."""
    kernel_counts.PLAIN_CALLS[tier_name("multisweep_relax",
                                        compute_dtype)] += 1
    return gsrb_sweeps_folded(
        u, rhs, a, None, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo, compute_dtype=compute_dtype, _where=_where,
    )


def gsrb_full_sweep_plain(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo,
):
    """The plain PyTorch version of `gsrb_full_sweep`."""
    kernel_counts.PLAIN_CALLS["gsrb_full_sweep"] += 1
    return gsrb_sweeps_folded(
        u, rhs, a, b, nsweeps=1, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo,
    )


def gsrb_half_sweep_plain(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo, color: int,
):
    """The plain PyTorch version of `gsrb_half_sweep`."""
    kernel_counts.PLAIN_CALLS["gsrb_half_sweep"] += 1
    return gsrb_sweeps_folded(
        u, rhs, a, b, nsweeps=1, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo=lo, colors=(int(color),),
    )


def _axis_neighbour_sum(uc, axis: int, kinds: FaceKinds, rho: float):
    """vp + vm along one axis with the homogeneous ghost rule replacing the
    wrapped edge planes."""
    n_ax = uc.shape[axis]
    vp = torch.roll(uc, -1, axis)
    vm = torch.roll(uc, 1, axis)
    if kinds[axis][0] != PERIODIC:
        idx = _iota(uc.shape, axis, uc.device)
        ghost_hi = ghost_plane(kinds[axis][1], uc.narrow(axis, n_ax - 1, 1),
                               uc.narrow(axis, n_ax - 2, 1), rho)
        vp = torch.where(idx == n_ax - 1, ghost_hi, vp)
        ghost_lo = ghost_plane(kinds[axis][0], uc.narrow(axis, 0, 1),
                               uc.narrow(axis, 1, 1), rho)
        vm = torch.where(idx == 0, ghost_lo, vm)
    return vp + vm


def residual_plain(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float,
):
    """res = rhs - L(u) of a whole level with homogeneous ghosts, in plain
    PyTorch."""
    kernel_counts.PLAIN_CALLS["residual"] += 1
    return _residual_values(u, rhs, a, b, kinds=kinds, rho=rho, alpha=alpha,
                            beta=beta, dx=dx)


def residual_restrict_plain(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float,
):
    """The plain PyTorch version of `residual_restrict`: restrict_full of
    the residual."""
    kernel_counts.PLAIN_CALLS["residual_restrict"] += 1
    return restrict_full(_residual_values(
        u, rhs, a, b, kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx))


def residual_restrict_batch_plain(
    us, rhss, as_, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float,
):
    """The plain PyTorch version of `residual_restrict_batch`: each
    patch's restricted residual, as residual_restrict_plain."""
    kernel_counts.PLAIN_CALLS["residual_restrict_batch"] += 1
    return [restrict_full(_residual_values(
        u, rhs, a, None, kinds=kinds, rho=rho, alpha=alpha, beta=beta,
        dx=dx)) for u, rhs, a in zip(us, rhss, as_)]


def _residual_values(u, rhs, a, b, *, kinds: FaceKinds, rho: float,
                     alpha: float, beta: float, dx: float):
    """The body of both plain versions; it counts nothing."""
    inv_dx2 = 1.0 / (dx * dx)
    b_inv = beta * inv_dx2
    if b is not None:
        b_inv = b_inv * b
    lap = (_axis_neighbour_sum(u, 0, kinds, rho)
           + (_axis_neighbour_sum(u, 1, kinds, rho)
              + _axis_neighbour_sum(u, 2, kinds, rho)) - 6.0 * u)
    return rhs - (alpha * a * u - b_inv * lap)


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------


def kinds_array(kinds: FaceKinds):
    """ctypes int[6] of face kind codes, [axis*2 + side]."""
    flat = [_KIND_CODE[kinds[ax][s]] for ax in range(3) for s in range(2)]
    return (ctypes.c_int * 6)(*flat)


def check_level_args(name: str, u, *others):
    """The kernels take contiguous f32/f64 (nx, ny, nz) CUDA tensors of one
    shape, dtype and device, at least 2 cells per axis; raise otherwise.
    Its host time is part of every kernel call, so it reads cheap tensor
    queries only (the device by its index: no device objects), and the
    devices only for a message."""
    if not u.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {u.device}")
    dt, shape, dev = u.dtype, u.shape, u.get_device()
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"{name}: dtype {u.dtype} not supported (f32/f64)")
    if len(shape) != 3 or min(shape) < 2:
        raise ValueError(f"{name}: bad level shape {tuple(u.shape)}")
    for t in (u,) + tuple(o for o in others if o is not None):
        if (t.dtype is not dt or t.shape != shape
                or t.get_device() != dev):
            raise ValueError(
                f"{name}: operands disagree: {tuple(t.shape)} {t.dtype} "
                f"{t.device} vs {tuple(u.shape)} {u.dtype} {u.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


# patches of one batched launch at most (kMaxBatch of csrc/gsrb_relax.cu and
# csrc/residual.cu): a larger group goes in launches of this many
BATCH_MAX = 16


def check_batch_args(name: str, us, *others):
    """The batched kernels take P >= 1 patches, each with the operands of
    check_level_args, all of one shape, dtype and device (lists of equal
    length: patch k's at index k); raise otherwise."""
    if not us or any(len(o) != len(us) for o in others):
        raise ValueError(f"{name}: {len(us)} patches, operand lists "
                         f"{[len(o) for o in others]}")
    u0 = us[0]
    for k, u in enumerate(us):
        check_level_args(name, u, *(o[k] for o in others))
        if (u.shape != u0.shape or u.dtype is not u0.dtype
                or u.get_device() != u0.get_device()):
            raise ValueError(
                f"{name}: patch {k} is {tuple(u.shape)} {u.dtype} "
                f"{u.device}, patch 0 {tuple(us[0].shape)} {us[0].dtype} "
                f"{us[0].device}")


def _table(*lists):
    """The data pointers of every tensor of the lists, list after list (None:
    a null pointer), as a C array of 64-bit words (the C entries take its
    address: table.buffer_info()[0]), and as a list."""
    ptrs = [0 if t is None else t.data_ptr() for ts in lists for t in ts]
    return array.array("Q", ptrs), ptrs


# The one-launch gsrb_relax (csrc/gsrb_relax.cu): threads per block of
# either form (kThreads), the most blocks of the slab form
# (kMaxSlabs), the forms' codes (RelaxForm), the shared memory a slab block
# may take (the H100's 227 KB a block), the largest level that runs as one
# block (16^3, as the towers' tail), and the smallest tile (cells) for which
# the slab form is taken over the grid form when the level needs more than
# one block: on an H100 the slab form was the faster at 128x80x80 and
# 272x80x80 (tiles of 6400 and 13600 cells) and the slower at 96x80x80 and
# 176x64x64 (4800 and 5632), by 5-6 % either way (scripts/gsrb_probe.py).
GSRB_THREADS = 512
GSRB_MAX_SLABS = 256
GSRB_FORMS = {"grid": 0, "slab": 1, "serial": 2, "march": 3}
GSRB_SLAB_SMEM = 232448
GSRB_ONE_BLOCK_CELLS = 4096
GSRB_SLAB_MIN_TILE = 6144

# The batch march (csrc/gsrb_batch_march.cu, gsrb_relax_batch's "march"
# form): the one tile width it is built for (kW; 2 sweeps a chunk, f32: the
# width march_tile gives the 144^3 patches whose pairs overflow the L2),
# the sweeps a call takes (one chunk or two in the launch), and the bytes
# of shared memory a block takes (R planes of u and of the three
# coefficient arrays a, rhs and lambda, R = 4 + 2 + 1).
BATCH_MARCH_TILE = 44
BATCH_MARCH_SWEEPS = (2, 4)
BATCH_MARCH_SMEM = 232176


class GsrbGeometry(NamedTuple):
    """The launch of one gsrb_relax call (gsrb_geometry)."""
    form: str      # "grid" or "slab"; a batch also "serial" or "march"
    per: int       # 1 every axis periodic, 0 none, -1 some
    blocks: int    # the march: blocks of the launch, all patches
    xsplit: tuple  # slab forms: (first plane, planes) of each x tile
    ysplit: tuple  # slab forms: (first row, rows) of each y tile; block
                   # (ix, iy) is number ix * len(ysplit[0]) + iy
    smem: int      # slab and march forms: bytes of shared memory a block
    tile: int = 0  # the march: the y-z tile width
    xseg: int = 0  # the march: planes of an x segment (all but the last)
    faces: int = 0  # grid and serial forms: cells of a patch's wrap faces
                    # (face_cells), the scratch of its passes in place


def pair_grid_blocks(shape, threads: int, capacity: int) -> int:
    """Blocks of `threads` for a grid-wide colour pass over `shape`: enough
    for a z pair a thread, at most `capacity`, and where that fits a whole
    number of x planes of z pairs, so that a thread keeps its pair from pass
    to pass (csrc/gsrb_walk.cuh)."""
    nx, ny, nz = shape
    plane = ny * -(-nz // 2)
    need = -(-nx * plane // threads)
    q = plane // math.gcd(plane, threads)  # blocks that make whole planes
    if -(-need // q) * q <= capacity:
        return -(-need // q) * q
    if q <= capacity:
        return capacity // q * q
    return min(capacity, need)


def periodic_axes(kinds: FaceKinds) -> int:
    """1 when every axis is periodic, 0 when none is, -1 otherwise."""
    n = sum(kinds[ax][0] == PERIODIC for ax in range(3))
    return 1 if n == 3 else 0 if n == 0 else -1


def even_split(n: int, parts: int) -> tuple[tuple, tuple]:
    """(first, count): n cut in order into `parts` runs, the first
    n % parts of them one longer."""
    q, r = divmod(n, parts)
    count = tuple(q + (s < r) for s in range(parts))
    first = tuple(sum(count[:s]) for s in range(parts))
    return first, count


def tile_smem(bx: int, by: int, nz: int, itemsize: int,
              zodd: bool = False) -> int:
    """Shared memory of a slab block whose tile is bx planes of by rows: the
    window (the tile with a plane and a row more on each side) and the
    tile's a and rhs; where z is periodic of odd extent (zodd), also the two
    z wrap cells of each tile row (face_cells)."""
    return (((bx + 2) * (by + 2) + 2 * bx * by) * nz
            + (2 * bx * by if zodd else 0)) * itemsize


def odd_wrap_axes(shape, kinds: FaceKinds) -> tuple:
    """The periodic axes of odd extent: along one, cells 0 and n - 1 are
    neighbours of one colour, and a colour pass in place reads them across
    the wrap from a copy made before the pass (csrc/gsrb_walk.cuh)."""
    return tuple(ax for ax in range(3)
                 if kinds[ax][0] == PERIODIC and shape[ax] % 2)


def face_cells(shape, kinds: FaceKinds) -> int:
    """Cells of a level's wrap faces: the two faces of each periodic axis of
    odd extent (csrc/gsrb_walk.cuh's Faces); 0 without one."""
    return sum(2 * math.prod(shape) // shape[ax]
               for ax in odd_wrap_axes(shape, kinds))


def slab_tiles(shape, itemsize: int, capacity: int, zodd: bool = False):
    """(x tiles, y tiles) of the slab form, or None where no split fits: at
    most min(capacity, GSRB_MAX_SLABS) tiles whose largest fits
    GSRB_SLAB_SMEM, the one with the least rows computed and exchanged per
    pass by its largest tile (by x bx rows, and 2 bx or 2 by more along a cut
    axis: the rows it sends equal the rows it takes), then the fewest
    tiles; one tile up to GSRB_ONE_BLOCK_CELLS cells. zodd: tile_smem's."""
    nx, ny, nz = shape
    if nx * ny * nz <= GSRB_ONE_BLOCK_CELLS:
        ok = tile_smem(nx, ny, nz, itemsize, zodd) <= GSRB_SLAB_SMEM
        return (1, 1) if ok else None
    most = min(int(capacity), GSRB_MAX_SLABS)
    best = None
    for tx in range(1, min(nx, most) + 1):
        bx = -(-nx // tx)
        for ty in range(1, min(ny, most // tx) + 1):
            by = -(-ny // ty)
            if tile_smem(bx, by, nz, itemsize, zodd) > GSRB_SLAB_SMEM:
                continue
            cost = bx * by + 2 * (by * (tx > 1) + bx * (ty > 1))
            key = (cost, tx * ty, tx)
            if best is None or key < best[0]:
                best = (key, (tx, ty))
    return None if best is None else best[1]


def batch_march_supported(shape, itemsize: int, with_b: bool,
                          kinds: FaceKinds, nsweeps) -> bool:
    """Batches the march form takes: f32 with constant b, 2 or 4 sweeps
    (BATCH_MARCH_SWEEPS: one chunk of two or two chunks), no periodic axis,
    and a y-z plane whose tile width (march_tile at 2 sweeps) is the one
    built, BATCH_MARCH_TILE."""
    return (itemsize == 4 and not with_b and nsweeps in BATCH_MARCH_SWEEPS
            and periodic_axes(kinds) == 0
            and march_tile(int(shape[1]), int(shape[2]), 2, 4)
            == BATCH_MARCH_TILE)


def batch_march_geometry(shape, kinds: FaceKinds, capacity: int,
                         patches: int) -> GsrbGeometry:
    """The batch march's launch (csrc/gsrb_batch_march.cu) on `patches`
    levels of `shape` for `capacity` blocks of its form running at once
    (batch_march_capacity): the whole level's tile width (march_tile, 2
    sweeps) and the x segments of march_segments over every patch's tiles,
    the blocks as many of the work items (patch, segment, tile) as run at
    once, taking them in rounds."""
    nx, ny, nz = (int(n) for n in shape)
    inner = BATCH_MARCH_TILE - 8
    tiles = patches * -(-ny // inner) * -(-nz // inner)
    nseg, xseg = march_segments(nx, tiles, int(capacity), 2)
    return GsrbGeometry("march", periodic_axes(kinds),
                        min(int(capacity), tiles * nseg), ((), ()), ((), ()),
                        BATCH_MARCH_SMEM, BATCH_MARCH_TILE, xseg)


def batch_takes_march(shape, itemsize: int, with_b: bool, kinds: FaceKinds,
                      patches: int, nsweeps) -> bool:
    """Whether gsrb_relax_batch takes the march form for `patches` levels of
    `shape` and `nsweeps` sweeps when no form is asked for: where their four
    arrays a level overflow the L2 cache that one level's fit (exceeds_l2)
    and the march applies (batch_march_supported). On an H100 the march read
    0.185 ms for the 144^3 f32 pair's 4 sweeps against the serial form's
    0.257-0.263 (scripts/batch_probe.py --march; PERF.md)."""
    nx, ny, nz = (int(n) for n in shape)
    return (patches > 1
            and exceeds_l2((patches * nx, ny, nz), itemsize)
            and not exceeds_l2((nx, ny, nz), itemsize)
            and batch_march_supported((nx, ny, nz), itemsize, with_b, kinds,
                                      nsweeps))


def gsrb_geometry(shape, itemsize: int, with_b: bool, kinds: FaceKinds,
                  capacity: int, form: str | None = None,
                  patches: int = 1, nsweeps: int | None = None
                  ) -> GsrbGeometry:
    """The launch of gsrb_relax on a level of `shape` for `capacity` blocks
    running at once (gsrb_capacity; a cooperative launch needs all of them
    resident); for a batch of `patches` levels of the shape
    (gsrb_relax_batch, `nsweeps` sweeps) the launch of one of them at
    capacity // patches, `blocks` then a patch's, or, where the batch's four
    arrays a level overflow the L2 cache that one level's fit (exceeds_l2),
    the "march" form where it applies (batch_takes_march;
    batch_march_geometry, the blocks at `capacity`: the card's is the march
    kernel's own, batch_march_capacity), else the "serial" form: one
    level's grid form at the whole capacity, its blocks taking the patches
    in turn (side by side, their passes went to device memory: 25 % slower
    than single calls for two 144^3 f32 patches on an H100). The slab form
    where it applies, f32 with constant b and a
    split of x and y into tiles that fits (slab_tiles, each axis cut evenly
    by even_split), and where it is the faster: one block, or tiles of
    GSRB_SLAB_MIN_TILE cells or more. Else the grid form: a z pair a thread
    in whole x planes (pair_grid_blocks) unless those leave more than an
    eighth of the capacity idle, then as many blocks as run at once. `form`
    asks for one form (the measurements do); a slab or march form that does
    not apply then raises, and so does a serial or march form for one
    level. A level with a periodic axis of odd extent: the grid and serial
    forms' passes in place take `faces` cells of scratch a patch
    (face_cells), the slab form's tiles the z wrap cells where that axis is
    z (tile_smem)."""
    nx, ny, nz = (int(n) for n in shape)
    if nx * ny * nz >= 2 ** 31:
        raise ValueError(f"gsrb_relax: {nx * ny * nz} cells (below 2^31)")
    per = periodic_axes(kinds)
    zodd = 2 in odd_wrap_axes((nx, ny, nz), kinds)
    faces = face_cells((nx, ny, nz), kinds)
    overflow = (form is None and patches > 1
                and exceeds_l2((patches * nx, ny, nz), itemsize)
                and not exceeds_l2((nx, ny, nz), itemsize))
    if form == "march" or (form is None and batch_takes_march(
            (nx, ny, nz), itemsize, with_b, kinds, patches, nsweeps)):
        if patches < 2:
            raise ValueError("gsrb_relax: the march form takes a batch")
        if not batch_march_supported((nx, ny, nz), itemsize, with_b, kinds,
                                     nsweeps):
            raise ValueError(
                f"gsrb_relax: no march form for {tuple(shape)}, itemsize "
                f"{itemsize}, b {with_b}, nsweeps {nsweeps}")
        return batch_march_geometry((nx, ny, nz), kinds, capacity, patches)
    if form == "serial" or overflow:
        if patches < 2:
            raise ValueError("gsrb_relax: the serial form takes a batch")
        return gsrb_geometry(shape, itemsize, with_b, kinds, capacity,
                             "grid")._replace(form="serial")
    capacity = int(capacity) // int(patches)
    if capacity < 1:
        raise ValueError(f"gsrb_relax: {patches} patches exceed the "
                         f"capacity")
    tiles = None
    if form != "grid" and itemsize == 4 and not with_b:
        tiles = slab_tiles((nx, ny, nz), itemsize, capacity, zodd)
    if tiles is not None:
        xs, ys = even_split(nx, tiles[0]), even_split(ny, tiles[1])
        bx, by = max(xs[1]), max(ys[1])
        if (form == "slab" or tiles == (1, 1)
                or bx * by * nz >= GSRB_SLAB_MIN_TILE):
            return GsrbGeometry("slab", per, tiles[0] * tiles[1], xs, ys,
                                tile_smem(bx, by, nz, itemsize, zodd))
    if form not in (None, "grid"):
        raise ValueError(f"gsrb_relax: no {form} form for {tuple(shape)}, "
                         f"itemsize {itemsize}, b {with_b}")
    blocks = pair_grid_blocks((nx, ny, nz), GSRB_THREADS, capacity)
    need = -(-nx * ny * -(-nz // 2) // GSRB_THREADS)
    if 8 * blocks < 7 * capacity and need > blocks:
        blocks = min(capacity, need)
    return GsrbGeometry("grid", per, blocks, ((), ()), ((), ()), 0,
                        faces=faces)


def gsrb_capacity(device, itemsize: int, compute: int = 0,
                  odd: bool = False) -> int:
    """Blocks of the gsrb_relax kernels of the item size and arithmetic
    (compute 1: the bf16 tier) (the slab kernels at GSRB_SLAB_SMEM) that the
    CUDA device runs at once (mgk_gsrb_capacity), for a level with (`odd`)
    or without a periodic axis of odd extent: those launch other kernels."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_ext.lib().mgk_gsrb_capacity(
            int(itemsize == 8), int(compute), int(bool(odd)), GSRB_SLAB_SMEM,
            ctypes.byref(cap))
    cuda_ext.check(err, "gsrb_relax capacity")
    return cap.value


def batch_march_capacity(device) -> int:
    """Blocks of the batch march form that the CUDA device runs at once
    (mgk_gsrb_batch_march_capacity)."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_ext.lib().mgk_gsrb_batch_march_capacity(
            BATCH_MARCH_TILE, ctypes.byref(cap))
    cuda_ext.check(err, "gsrb_relax_batch march capacity")
    return cap.value


@functools.lru_cache(maxsize=None)
def _relax_launch(shape, itemsize: int, with_b: bool, kinds: FaceKinds,
                  index: int, form: str | None, patches: int = 1,
                  compute: int = 0, nsweeps: int | None = None):
    """(geometry, the C entry's geometry arguments) of a level (of each of
    a batch of `patches`, `nsweeps` sweeps) in the arithmetic `compute` (1:
    the bf16 tier), kept: the solver calls gsrb_relax with a few shapes many
    times, and its host time is part of every call's. The march form (a
    batch's: _batch_launch builds its arguments) at its own kernel's
    capacity."""
    device = torch.device("cuda", index)
    geom = gsrb_geometry(shape, itemsize, with_b, kinds, gsrb_capacity(
        device, itemsize, compute, bool(odd_wrap_axes(shape, kinds))), form,
        patches, nsweeps)
    if geom.form == "march":
        return batch_march_geometry(shape, kinds, batch_march_capacity(
            device), patches), ()
    starts = _starts(geom, shape)
    return geom, (kinds_array(kinds), GSRB_FORMS[geom.form], geom.per,
                  geom.blocks, len(geom.xsplit[0]),
                  (ctypes.c_int * len(starts))(*starts), geom.smem)


def _starts(geom: GsrbGeometry, shape) -> tuple:
    """The slab form's starts (the first plane of each x tile, then nx; the
    first row of each y tile, then ny); (0,) for another form."""
    if geom.form != "slab":
        return (0,)
    return geom.xsplit[0] + (shape[0],) + geom.ysplit[0] + (shape[1],)


@functools.lru_cache(maxsize=None)
def _batch_launch(shape, itemsize: int, kinds: FaceKinds, index: int,
                  form: str | None, patches: int, nsweeps: int):
    """(geometry, the geometry array of the C entry) of a gsrb_relax_batch
    launch of `patches` levels (_relax_launch's geometry), kept per shape:
    mgk_gsrb_batch_march's (npatch, nx, ny, nz, nsweeps, tile, xseg,
    blocks, the kinds) for the march form, else mgk_gsrb_relax_batch's
    (npatch, is_double, nx, ny, nz, nsweeps, form, per, blocks, xtiles,
    smem, the kinds, the starts)."""
    geom, _ = _relax_launch(shape, itemsize, False, kinds, index, form,
                            patches, 0, nsweeps)
    codes = tuple(kinds_array(kinds))
    if geom.form == "march":
        geo = (patches, *shape, nsweeps, geom.tile, geom.xseg, geom.blocks,
               *codes)
    else:
        geo = (patches, int(itemsize == 8), *shape, nsweeps,
               GSRB_FORMS[geom.form], geom.per, geom.blocks,
               len(geom.xsplit[0]), geom.smem, *codes,
               *_starts(geom, shape))
    return geom, (ctypes.c_int * len(geo))(*geo)


def gsrb_relax(
    u, rhs, a, b=None, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, lo, compute_dtype=None,
):
    """nsweeps red-black GSRB sweeps of a whole level (homogeneous ghosts,
    optional variable bCoef `b`). Returns a new tensor; the inputs are only
    read. CUDA tensors go to the kernel (one cooperative launch in the form
    gsrb_geometry picks); CPU tensors take the plain version.
    `compute_dtype` "bfloat16": the bf16 tier (f32 operands and constant b
    only; raises otherwise), counted under gsrb_relax_bf16."""
    if u.device.type == "cpu":
        check_tier("gsrb_relax", u, b, compute_dtype)
        return gsrb_relax_plain(
            u, rhs, a, b, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
            beta=beta, dx=dx, lo=lo, compute_dtype=compute_dtype,
        )
    return gsrb_launch(u, rhs, a, b, nsweeps=nsweeps, kinds=kinds, rho=rho,
                       alpha=alpha, beta=beta, dx=dx, lo=lo,
                       compute_dtype=compute_dtype)


def gsrb_launch(
    u, rhs, a, b=None, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, lo, form: str | None = None,
    compute_dtype=None,
):
    """gsrb_relax's launch on CUDA tensors, in the form gsrb_geometry picks
    or in `form` (the measurements compare the forms), in the arithmetic
    `compute_dtype` says (gsrb_relax)."""
    check_level_args("gsrb_relax", u, rhs, a, b)
    check_tier("gsrb_relax", u, b, compute_dtype)
    if nsweeps < 0:
        raise ValueError(f"gsrb_relax: nsweeps {nsweeps}")
    compute = int(compute_type(compute_dtype) is not None)
    geom, args = _relax_launch(tuple(u.shape), u.element_size(),
                               b is not None, kinds, u.device.index, form,
                               1, compute)
    out = torch.empty_like(u)
    faces = (torch.empty(geom.faces, dtype=u.dtype, device=u.device)
             if geom.faces else None)
    nx, ny, nz = u.shape
    kernel_counts.count_launch(tier_name("gsrb_relax", compute_dtype), 1)
    err = on_stream(
        cuda_ext.lib().mgk_gsrb_relax, u, u.data_ptr(), rhs.data_ptr(),
        a.data_ptr(), _ptr(b), out.data_ptr(), _ptr(faces),
        int(u.dtype == torch.float64),
        compute, nx, ny, nz, args[0], float(rho), float(alpha), float(beta),
        float(dx), int(sum(lo)), int(nsweeps), *args[1:])
    cuda_ext.check(err, "gsrb_relax")
    return out


def gsrb_relax_batch(
    us, rhss, as_, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, los,
):
    """gsrb_relax of P same-shape levels of one parity with constant
    bCoef (the sibling patches of a batch group), patch k's operands at
    index k of the lists and its lo at los[k]: a list of P new tensors.
    CUDA tensors go to the kernel, ONE cooperative launch for up to
    BATCH_MAX patches (gsrb_batch_launch); CPU tensors take the plain
    version."""
    if us[0].device.type == "cpu":
        return gsrb_relax_batch_plain(
            us, rhss, as_, nsweeps=nsweeps, kinds=kinds, rho=rho,
            alpha=alpha, beta=beta, dx=dx, los=los)
    return gsrb_batch_launch(us, rhss, as_, nsweeps=nsweeps, kinds=kinds,
                             rho=rho, alpha=alpha, beta=beta, dx=dx, los=los)


def gsrb_batch_launch(
    us, rhss, as_, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, los, form: str | None = None,
):
    """gsrb_relax_batch's launches on CUDA tensors: one per BATCH_MAX
    patches, in the form gsrb_geometry picks for that many patches and
    sweeps at the card's capacity, or in `form`: mgk_gsrb_relax_batch (grid,
    slab, serial) or mgk_gsrb_batch_march (march: the state between its two
    chunks in a scratch tensor of the group's size), counted under
    gsrb_relax_batch_march. Its host time is part of every group call: the
    operands are checked by cheap queries (check_batch_args), the pointers
    go in one table."""
    check_batch_args("gsrb_relax_batch", us, rhss, as_)
    if nsweeps < 0:
        raise ValueError(f"gsrb_relax_batch: nsweeps {nsweeps}")
    base = int(sum(los[0]))
    if len(los) != len(us) or any((sum(lo) - base) % 2 for lo in los):
        raise ValueError(f"gsrb_relax_batch: the patches' parities differ "
                         f"(lo {list(los)})")
    u0 = us[0]
    shape = tuple(u0.shape)
    index, isz = u0.get_device(), u0.element_size()
    lib = cuda_ext.lib()
    outs = []
    for c in range(0, len(us), BATCH_MAX):
        pu, pr, pa = ((us, rhss, as_) if len(us) <= BATCH_MAX else
                      (us[c:c + BATCH_MAX], rhss[c:c + BATCH_MAX],
                       as_[c:c + BATCH_MAX]))
        n = len(pu)
        geom, geo = _batch_launch(shape, isz, kinds, index, form, n,
                                  int(nsweeps))
        out = [torch.empty_like(u) for u in pu]
        if geom.form == "march":
            # the state between the two chunks: one scratch tensor, patch
            # k's at k cells-of-a-patch in
            tmp = [] if nsweeps <= 2 else [torch.empty(
                (n,) + shape, dtype=u0.dtype, device=u0.device)]
            table, ptrs = _table(pu, pr, pa, out, tmp)
            if tmp:
                step = u0.numel() * isz
                table.extend(ptrs[-1] + k * step for k in range(1, n))
            else:
                table.extend([0] * n)
            entry, name = lib.mgk_gsrb_batch_march, "gsrb_relax_batch_march"
        else:
            # the wrap faces of every patch of a grid or serial form
            faces = [torch.empty(n * geom.faces, dtype=u0.dtype,
                                 device=u0.device) if geom.faces else None]
            table, _ = _table(pu, pr, pa, out, faces)
            entry, name = lib.mgk_gsrb_relax_batch, "gsrb_relax_batch"
        kernel_counts.count_launch(name, 1)
        err = on_stream(entry, u0, table.buffer_info()[0], geo,
                         float(rho), float(alpha), float(beta), float(dx),
                         base)
        cuda_ext.check(err, "gsrb_relax_batch")
        outs += out
    return outs


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device `index` as a cudaStream_t (int),
    without the torch.cuda.Stream object that current_stream() builds."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def on_stream(fn, t, *args):
    """fn(*args, stream): a C entry point that launches on the current
    stream of t's device, made the current device only where it is not."""
    idx = t.get_device()
    if idx == torch.cuda.current_device():
        return fn(*args, _raw_stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, _raw_stream(idx))


# The one-sweep and one-pass entry points (csrc/gsrb_sweep.cu): threads per
# block of the stream form (kSweepThreads) and of the march, the forms' codes
# of mgk_gsrb_sweep (SweepForm: a half sweep's stream, a full sweep's march;
# the full sweep's "grid" form is gsrb_relax's, mgk_gsrb_relax at nsweeps =
# 1), the shared memory a march block may take (the H100's 227 KB a block),
# the tile heights the march is offered (sweep_tile), and the fewest planes
# of an x segment.
SWEEP_THREADS = 256
SWEEP_MARCH_THREADS = 512
SWEEP_FORMS = {"stream": 0, "march": 1}
SWEEP_SMEM = 232448
SWEEP_TILE_ROWS = (32, 24, 16, 8, 4, 2)
SWEEP_MIN_SEG = 4


class SweepGeometry(NamedTuple):
    """The launch of one gsrb_full_sweep / gsrb_half_sweep call
    (sweep_geometry)."""
    form: str       # "stream" (half), "march" or "grid" (full)
    ty: int = 0     # the march: rows of a y tile (the last takes the rest)
    xseg: int = 0   # the march: planes of an x segment (the last the rest)
    nseg: int = 0   # the march: x segments
    smem: int = 0   # the march: bytes of shared memory a block
    blocks: int = 0  # blocks of the launch (stream, march)
    threads: int = 0  # the march: threads a block


def sweep_smem(nz: int, ty: int, itemsize: int) -> int:
    """Shared memory of a march block of ty rows: its ring of five u
    planes (the four a step reads and one fetched ahead), each with two rows
    beyond the tile on each side."""
    return 5 * (ty + 4) * nz * itemsize


def sweep_tile(ny: int, nz: int, itemsize: int) -> int | None:
    """The march's tile height: of SWEEP_TILE_ROWS, the one whose tiles
    compute the fewest rows, ceil(ny / ty) * (ty + 2) (red runs on a row
    beyond each side; the taller on a tie), among those whose ring lets two
    blocks share a multiprocessor (at most SWEEP_SMEM / 2), else among
    those whose ring fits a block; None where none fits. On an H100 this is
    16 rows at 256^3 (0.144 ms; 24, one block a multiprocessor, was
    slower) and 24 at 960x144x144 (0.190 against 16's 0.206 and 32's
    0.204: 144 rows in tiles of 32 leave one of 16)
    (scripts/sweep_probe.py)."""
    for most in (SWEEP_SMEM // 2, SWEEP_SMEM):
        fits = [t for t in SWEEP_TILE_ROWS
                if sweep_smem(nz, t, itemsize) <= most]
        if fits:
            return min(fits, key=lambda t: (-(-ny // t) * (t + 2), -t))
    return None


def sweep_segments(nx: int, tiles: int, capacity: int) -> tuple[int, int]:
    """(nseg, xseg): the x segments of a march launch over `tiles` y tiles
    that make one wave of the `capacity` blocks the card runs at once, at
    most nx // SWEEP_MIN_SEG of them (at least one), xseg planes each but
    the last, which takes what is left."""
    want = max(1, min(max(nx // SWEEP_MIN_SEG, 1), round(capacity / tiles)))
    length = -(-nx // want)
    return -(-nx // length), length


def sweep_geometry(shape, itemsize: int, kinds: FaceKinds, full: bool,
                   capacity, form: str | None = None, ty: int | None = None,
                   nseg: int | None = None,
                   threads: int | None = None) -> SweepGeometry:
    """The launch of gsrb_full_sweep (full) or gsrb_half_sweep on a level of
    `shape`; `capacity(threads, smem)` gives the blocks of the march of
    `threads` threads with smem bytes each that the card runs at once
    (sweep_capacity). A half sweep: the "stream" form. A full sweep: the
    "grid" form (gsrb_relax's at nsweeps = 1) where the level's four arrays
    fit the L2 cache (exceeds_l2), else the "march" where a tile fits
    SWEEP_SMEM, else "grid". On an H100 the march read 0.144 ms at 256^3 P
    against the grid form's 0.232, 0.189 against 0.277 at 960x144x144, and
    0.015 against 0.0105 at 96x80x80, where the grid form's second pass
    reads each array from the L2 (scripts/sweep_probe.py; PERF.md). A full
    sweep with an odd periodic axis raises (red writes in place in either
    form, and across such a wrap a red cell reads a red neighbour: the
    plain version reads its value before the pass). The march: sweep_tile's
    tile height, SWEEP_MARCH_THREADS threads a block, the x segments of one
    wave (sweep_segments). `form`, `ty`, `nseg`, `threads` ask for one (the
    measurements do); a march that does not fit then raises."""
    nx, ny, nz = (int(n) for n in shape)
    if nx * ny * nz >= 2 ** 31:
        raise ValueError(f"gsrb sweep: {nx * ny * nz} cells (below 2^31)")
    if full and odd_wrap_axes(shape, kinds):
        raise ValueError(
            f"gsrb_full_sweep: {tuple(shape)} has an odd periodic axis: the "
            f"colours disagree across the wrap, where a kernel that writes "
            f"a colour in place reads a cell its pass writes")
    asked = form is not None
    if form is None:
        form = ("stream" if not full else
                "march" if exceeds_l2(shape, itemsize) else "grid")
    if form not in (("grid", "march") if full else ("stream",)):
        raise ValueError(f"gsrb_{'full' if full else 'half'}_sweep: no "
                         f"form {form!r}")
    if form == "grid":
        return SweepGeometry("grid")
    if form == "stream":
        items = nx * ny * -(-nz // 4)
        return SweepGeometry("stream", blocks=-(-items // SWEEP_THREADS))
    threads = SWEEP_MARCH_THREADS if threads is None else int(threads)
    if threads % 32 or not 32 <= threads <= 512:
        raise ValueError(f"gsrb_full_sweep: {threads} threads a block")
    t = sweep_tile(ny, nz, itemsize) if ty is None else int(ty)
    if t is None or sweep_smem(nz, t, itemsize) > SWEEP_SMEM:
        if not asked:
            return SweepGeometry("grid")
        raise ValueError(f"gsrb_full_sweep: no march tile fits "
                         f"{tuple(shape)}, itemsize {itemsize}")
    smem = sweep_smem(nz, t, itemsize)
    tiles = -(-ny // t)
    if nseg is None:
        segs, length = sweep_segments(nx, tiles,
                                      int(capacity(threads, smem)))
    else:
        length = -(-nx // int(nseg))
        segs = -(-nx // length)
    return SweepGeometry("march", t, length, segs, smem, tiles * segs,
                         threads)


def sweep_blocks(shape, geom: SweepGeometry, kinds: FaceKinds):
    """What each block of a march launch (block b: segment b // tiles, tile
    b % tiles) covers, as csrc/gsrb_sweep.cu computes it: a dict of the
    planes [x0, x1) and rows [y0, y1) it writes, the level rows of its u
    ring and the level planes of its u ring's fetches in order (-1 past an
    open face: not fetched), and its red planes (-1 past an open face: not
    computed)."""
    nx, ny, nz = (int(n) for n in shape)
    px, py = (kinds[ax][0] == PERIODIC for ax in (0, 1))

    def wrap(n, size, periodic):
        if 0 <= n < size:
            return n
        return n % size if periodic else -1

    tiles = -(-ny // geom.ty)
    out = []
    for blk in range(tiles * geom.nseg):
        tile, seg = blk % tiles, blk // tiles
        y0, x0 = tile * geom.ty, seg * geom.xseg
        ty, x1 = min(geom.ty, ny - y0), min(nx, x0 + geom.xseg)
        nsteps = x1 - x0 + 2
        out.append({
            "x": (x0, x1), "y": (y0, y0 + ty),
            "u_rows": [wrap(y0 - 2 + r, ny, py) for r in range(ty + 4)],
            "u_planes": [wrap(x0 - 2 + m, nx, px)
                         for m in range(nsteps + 2)],
            "red_planes": [wrap(x0 - 1 + s, nx, px)
                           for s in range(nsteps)]})
    return out


def sweep_capacity(device, itemsize: int, form: str, per: int,
                   threads: int, smem: int) -> int:
    """Blocks of the sweep form's kernel (SWEEP_FORMS) of `threads` threads
    with `smem` bytes of shared memory each that the CUDA device runs at
    once (mgk_gsrb_sweep_capacity)."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_ext.lib().mgk_gsrb_sweep_capacity(
            int(itemsize == 8), SWEEP_FORMS[form], int(per), int(threads),
            int(smem), ctypes.byref(cap))
    cuda_ext.check(err, "gsrb sweep capacity")
    return cap.value


@functools.lru_cache(maxsize=None)
def _sweep_launch(shape, itemsize: int, with_b: bool, kinds: FaceKinds,
                  index: int, full: bool, form: str | None = None,
                  ty: int | None = None, nseg: int | None = None,
                  threads: int | None = None):
    """(geometry, the C entry's geometry argument) of a gsrb_full_sweep
    (full) or gsrb_half_sweep launch, kept per shape: mgk_gsrb_sweep's int
    array (form, is_double, nx, ny, nz, the kinds, per, ty, xseg, nseg,
    smem, threads), or for the grid form gsrb_relax's arguments
    (_relax_launch)."""
    device = torch.device("cuda", index)
    per = periodic_axes(kinds)
    geom = sweep_geometry(
        shape, itemsize, kinds, full,
        lambda th, smem: sweep_capacity(device, itemsize, "march", per, th,
                                        smem),
        form, ty, nseg, threads)
    if geom.form == "grid":
        return geom, _relax_launch(shape, itemsize, with_b, kinds, index,
                                   "grid")[1]
    # lets the kernel take its shared memory (once per kernel and device)
    sweep_capacity(device, itemsize, geom.form, per,
                   geom.threads or SWEEP_THREADS, geom.smem)
    geo = (SWEEP_FORMS[geom.form], int(itemsize == 8), *shape,
           *kinds_array(kinds), per, geom.ty, geom.xseg, geom.nseg,
           geom.smem, geom.threads)
    return geom, (ctypes.c_int * len(geo))(*geo)


def sweep_launch(u, rhs, a, b=None, *, full: bool, color: int = 0,
                 kinds: FaceKinds, rho: float, alpha: float, beta: float,
                 dx: float, lo, form: str | None = None,
                 ty: int | None = None, nseg: int | None = None,
                 threads: int | None = None):
    """gsrb_full_sweep's (full) or gsrb_half_sweep's (colour `color`) ONE
    launch on CUDA tensors, in the form sweep_geometry picks or in `form`,
    `ty`, `nseg`, `threads` (the measurements compare them), counted under
    the entry point's name. Its host time is part of every call: the
    operands are checked by cheap queries, the geometry is kept per shape,
    the launch goes on the raw current stream in one ctypes call."""
    name = "gsrb_full_sweep" if full else "gsrb_half_sweep"
    check_level_args(name, u, rhs, a, b)
    geom, geo = _sweep_launch(tuple(u.shape), u.element_size(),
                              b is not None, kinds, u.get_device(), full,
                              form, ty, nseg, threads)
    out = torch.empty_like(u)
    lib = cuda_ext.lib()
    kernel_counts.count_launch(name, 1)
    if geom.form == "grid":
        nx, ny, nz = u.shape
        err = on_stream(
            lib.mgk_gsrb_relax, u, u.data_ptr(), rhs.data_ptr(),
            a.data_ptr(), _ptr(b), out.data_ptr(), None,
            int(u.dtype == torch.float64), 0, nx, ny, nz, geo[0], float(rho),
            float(alpha), float(beta), float(dx), int(sum(lo)), 1, *geo[1:])
    else:
        err = on_stream(
            lib.mgk_gsrb_sweep, u, u.data_ptr(), rhs.data_ptr(),
            a.data_ptr(), _ptr(b), out.data_ptr(), geo, float(rho),
            float(alpha), float(beta), float(dx),
            int(sum(lo)) + (0 if full else int(color)))
    cuda_ext.check(err, name)
    return out


def gsrb_full_sweep(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo,
):
    """One red + black sweep of a whole level (homogeneous ghosts): ONE
    launch (csrc/gsrb_sweep.cu's march, or gsrb_relax's grid form where the
    march does not apply). Returns a new tensor; the inputs are only read.
    CUDA tensors go to the kernel, CPU tensors take the plain version."""
    kw = dict(kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx, lo=lo)
    if u.device.type == "cpu":
        return gsrb_full_sweep_plain(u, rhs, a, b, **kw)
    return sweep_launch(u, rhs, a, b, full=True, **kw)


def gsrb_half_sweep(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo, color: int,
):
    """One colour pass of a whole level (homogeneous ghosts): the cells
    with (i + j + k + sum(lo) + color) even are updated, the others copied,
    in ONE launch (csrc/gsrb_sweep.cu). Returns a new tensor; the inputs are
    only read. CUDA tensors go to the kernel, CPU tensors take the plain
    version."""
    kw = dict(kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx, lo=lo)
    if u.device.type == "cpu":
        return gsrb_half_sweep_plain(u, rhs, a, b, color=color, **kw)
    return sweep_launch(u, rhs, a, b, full=False, color=int(color), **kw)


# sweeps one multisweep launch can carry (csrc/multisweep.cu instantiates 4
# and 8 colour passes), and what the solver sends per launch: 4 smooths go
# as two launches of 2, as on the wavefront rung
MULTISWEEP_CHUNKS = (2, 4)
MULTISWEEP_PLAN_CHUNK = 2

# The forms of the whole-level march (csrc/multisweep.cu, MARCH_FORMS): the
# tile widths built per (itemsize, nsweeps). A tile of width W computes W x W
# y-z columns and writes the (W - 4*nsweeps)^2 inside its rind.
MARCH_TILES = {(4, 2): (40, 44), (4, 4): (36,), (8, 2): (32,), (8, 4): (24,)}


def march_tile(ny: int, nz: int, nsweeps: int, itemsize: int = 4) -> int:
    """The tile width of MARCH_TILES that computes the fewest y-z columns
    for the level (the smaller width on a tie): 40 (32 written) for 64, 96,
    256 and 512, 44 (36 written) for 144."""
    def computed(w):
        inner = w - 4 * nsweeps
        return -(-ny // inner) * -(-nz // inner) * w * w
    return min(MARCH_TILES[(itemsize, nsweeps)], key=lambda w: (computed(w), w))


def march_segments(nx: int, tiles: int, capacity: int, nsweeps: int):
    """(nseg, xseg): the x segments of a launch over `tiles` y-z tiles, the
    count that needs the fewest steps in all, a block taking xseg + 3*NP
    steps (NP = 2*nsweeps: rind planes at both ends and the drain) and the
    grid running in rounds of `capacity` blocks; at most nx // (8*NP)
    segments (unless there is one), so that they average 8*NP planes or
    more. Segments are xseg long but the last, which takes what is left.
    The one rule of the whole level's march and the shards'."""
    np_ = 2 * nsweeps
    best = None
    for n in range(1, max(nx // (8 * np_), 1) + 1):
        length = -(-nx // n)
        segs = -(-nx // length)
        cost = -(-tiles * segs // capacity) * (length + 3 * np_)
        if best is None or cost < best[0]:
            best = (cost, segs, length)
    return best[1], best[2]


def march_geometry(shape, nsweeps: int, itemsize: int, capacity: int):
    """(tile, nseg, xseg) of one whole-level march launch: the tile width
    (`march_tile`) and the x segments (`march_segments`) for `capacity`
    blocks running at once on the card (`march_capacity`)."""
    nx, ny, nz = (int(n) for n in shape)
    tile = march_tile(ny, nz, nsweeps, itemsize)
    inner = tile - 4 * nsweeps
    tiles = -(-ny // inner) * -(-nz // inner)
    return (tile,) + march_segments(nx, tiles, int(capacity), nsweeps)


def march_capacity(device, itemsize: int, nsweeps: int, tile: int,
                   compute: int = 0) -> int:
    """Blocks of the march form (itemsize, nsweeps, tile; compute 1: its
    bf16 tier) that the CUDA device runs at once
    (mgk_multisweep_capacity)."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_ext.lib().mgk_multisweep_capacity(
            int(itemsize == 8), int(compute), int(nsweeps), int(tile),
            ctypes.byref(cap))
    cuda_ext.check(err, "multisweep_relax capacity")
    return cap.value


def march_geometry_on(u, nsweeps: int, compute: int = 0):
    """`march_geometry` of the level `u` (a CUDA tensor) on its device, at
    the capacity of the form launched (compute 1: the bf16 tier's), kept
    per shape: the solver calls the march with a few shapes many times,
    and its host time is part of every call's."""
    return _geometry_on(tuple(u.shape), nsweeps, u.element_size(),
                        u.device.index, compute)


@functools.lru_cache(maxsize=None)
def _geometry_on(shape, nsweeps: int, itemsize: int, index: int,
                 compute: int = 0):
    device = torch.device("cuda", index)
    tile = march_tile(shape[1], shape[2], nsweeps, itemsize)
    return march_geometry(shape, nsweeps, itemsize, march_capacity(
        device, itemsize, nsweeps, tile, compute))


def shard_capacity(device, itemsize: int, nsweeps: int, tile: int,
                   pre: bool, compute: int = 0) -> int:
    """Blocks of the shard march form (itemsize, nsweeps, tile; `pre`: the
    prepadded pencil's; compute 1: its bf16 tier) that the CUDA device runs
    at once (mgk_multisweep_shard_capacity)."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_ext.lib().mgk_multisweep_shard_capacity(
            int(itemsize == 8), int(compute), int(nsweeps), int(tile),
            int(pre), ctypes.byref(cap))
    cuda_ext.check(err, "multisweep shard capacity")
    return cap.value


@functools.lru_cache(maxsize=None)
def shard_geometry_on(local_shape, nsweeps: int, itemsize: int, index: int,
                      pre: bool, compute: int = 0):
    """(tile, nseg, xseg) of one shard march launch (csrc/multisweep_halo.cu,
    whose forms are the whole level's) on CUDA device `index`: the whole
    level's `march_geometry` on the written (nx, ny, nz) of an x-slab or of
    a pencil without its pads (a tile's rind of 2*nsweeps rows reaches into
    a pencil's y pads), for the capacity of the shard form launched
    (compute 1: the bf16 tier's). Kept per shape: the sharded solver calls
    each shard's march with a few shapes many times."""
    device = torch.device("cuda", index)
    tile = march_tile(local_shape[1], local_shape[2], nsweeps, itemsize)
    return march_geometry(
        local_shape, nsweeps, itemsize,
        shard_capacity(device, itemsize, nsweeps, tile, pre, compute))


def multisweep_supported(shape, nsweeps: int, kinds: FaceKinds | None,
                         itemsize: int = 4) -> bool:
    """Levels the one-launch kernel takes from `gsrb_relax` (the multisweep
    rung where x is periodic, the wavefront rung where it is open: one
    predicate for both): a chunk the kernel is built for,
    even extents on periodic axes (tiles and x segments wrap them, and the
    checkerboard must agree across the wrap), and a level whose arrays do
    not fit the L2 cache. The kernel itself takes any nx >= 2 (a single x
    segment then wraps onto its own planes, read from the input); the size
    term is what keeps small levels on `gsrb_relax`."""
    if kinds is None or nsweeps not in MULTISWEEP_CHUNKS:
        return False
    if odd_wrap_axes(shape, kinds):
        return False
    return exceeds_l2(shape, itemsize)


def multisweep_plan(shape, n: int, kinds: FaceKinds | None,
                    itemsize: int = 4):
    """Sweeps per launch for n sweeps of this level, or None when the level
    does not take the multisweep rung (n odd, or not supported)."""
    if n <= 0 or n % MULTISWEEP_PLAN_CHUNK:
        return None
    if not multisweep_supported(shape, MULTISWEEP_PLAN_CHUNK, kinds,
                                itemsize):
        return None
    return MULTISWEEP_PLAN_CHUNK


def multisweep_launch(name: str, u, rhs, a, *, nsweeps: int,
                      kinds: FaceKinds, rho: float, alpha: float,
                      beta: float, dx: float, lo, pads=None, meta=None,
                      ny_global: int | None = None, compute_dtype=None):
    """One launch of the multisweep kernel (csrc/multisweep_march.cuh) on
    CUDA tensors, counted under `name` (`name`_bf16 in the bf16 tier,
    `compute_dtype`: f32 operands only); raises on what it does not take.
    The wrappers have checked nsweeps. Three ways to give it the level:
      * whole (`multisweep_relax`, `wavefront_relax`, which is the same
        kernel with x open): C entry mgk_multisweep_relax (csrc/
        multisweep.cu), with the tile and x segments of `march_geometry`;
      * an x-slab with x pads `pads = (upad, rpad, apad)` and `meta`
        (`multisweep_relax_halo`): mgk_multisweep_halo (csrc/
        multisweep_halo.cu), with the tile and x segments of
        `shard_geometry_on`;
      * a prepadded pencil with `meta` and `ny_global`
        (`multisweep_relax_tiled_pre`): mgk_multisweep_pre, the same
        geometry on the pencil without its pads, which is the output."""
    H = 2 * int(nsweeps)
    pre = ny_global is not None
    check_level_args(name, u, rhs, a)
    check_tier(name, u, None, compute_dtype)
    compute = int(compute_type(compute_dtype) is not None)
    if pads is not None:
        check_level_args(name, *pads)
        if pads[0].device != u.device or pads[0].dtype != u.dtype:
            raise ValueError(f"{name}: pads and slab disagree")
    nx, ny, nz = u.shape
    if pre:
        nx, ny = nx - 2 * H, ny - 2 * H
        if min(nx, ny) < 2:
            raise ValueError(f"{name}: prepadded {tuple(u.shape)} for H={H}")
    periodic = [kinds[ax][0] == PERIODIC for ax in range(3)]
    if meta is None:
        if odd_wrap_axes(u.shape, kinds):
            raise ValueError(
                f"{name}: a periodic axis needs an even extent, got "
                f"{tuple(u.shape)}")
    else:
        lo_edge, hi_edge, x_off, y_off = meta
        # the shard's x faces: the domain's where flagged and x is open
        faces = (int(lo_edge != 0 and not periodic[0]),
                 int(hi_edge != 0 and not periodic[0]))
        # x (and, prepadded, y) wrap through the pads: the extent that must
        # be even is the level's, which the sharded plan checked; z is whole
        if periodic[2] and nz % 2:
            raise ValueError(f"{name}: odd periodic z extent {nz}")
        if pre and not 0 <= y_off <= ny_global - ny:
            raise ValueError(f"{name}: y_off {y_off} outside {ny_global}")
    lib = cuda_ext.lib()
    out = torch.empty((nx, ny, nz), dtype=u.dtype, device=u.device)
    level = (int(u.dtype == torch.float64), compute, nx, ny, nz,
             kinds_array(kinds), float(rho), float(alpha), float(beta),
             float(dx))
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_counts.count_launch(tier_name(name, compute_dtype), 1)
        if meta is None:
            tile, _, xseg = march_geometry_on(u, nsweeps, compute)
            err = lib.mgk_multisweep_relax(
                u.data_ptr(), rhs.data_ptr(), a.data_ptr(), out.data_ptr(),
                *level, int(sum(lo)), int(nsweeps), tile, xseg, stream,
            )
        else:
            tile, _, xseg = shard_geometry_on(
                (nx, ny, nz), nsweeps, u.element_size(), u.device.index,
                pre, compute)
            if not pre:
                err = lib.mgk_multisweep_halo(
                    u.data_ptr(), rhs.data_ptr(), a.data_ptr(),
                    pads[0].data_ptr(), pads[1].data_ptr(),
                    pads[2].data_ptr(), out.data_ptr(), *level,
                    int(sum(lo)) + x_off, *faces, int(nsweeps), tile, xseg,
                    stream,
                )
            else:
                err = lib.mgk_multisweep_pre(
                    u.data_ptr(), rhs.data_ptr(), a.data_ptr(),
                    out.data_ptr(), *level, int(sum(lo)) + x_off + y_off,
                    *faces, y_off, int(ny_global), int(nsweeps), tile, xseg,
                    stream,
                )
    cuda_ext.check(err, name)
    return out


def multisweep_relax(
    u, rhs, a, *, nsweeps: int, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, lo, halo=None, compute_dtype=None,
):
    """nsweeps (2 or 4) red-black GSRB sweeps of a whole level with
    homogeneous ghosts and constant bCoef, for any face kinds including
    periodic x, in one kernel launch. Returns a new tensor. CUDA tensors go
    to the kernel; CPU tensors take the plain version.

    `halo = (upad, rpad, apad, meta)` runs the kernel on one x-slab of a
    sharded level (parallel/halo.sharded_relax), the JAX package's contract:
    the (2H, ny, nz) pads (H = 2*nsweeps) hold the rows of u, rhs and a
    below the slab in rows [0, H) and above it in rows [H, 2H), and `meta`
    is four ints [lo_edge, hi_edge, x_off, y_off]. An x face whose edge flag
    is set (and x not periodic) is the domain's: the ghost rule applies
    there and its pad is never read; a face whose flag is 0 is a seam, read
    from the pad. x_off places the slab in the level, so the checkerboard
    stays global (y_off is not read: an x-slab is never cut in y). Counted
    as `multisweep_relax_halo`.

    `compute_dtype` "bfloat16": the bf16 tier (f32 operands; raises
    otherwise), counted under multisweep_relax_bf16 /
    multisweep_relax_halo_bf16."""
    if nsweeps not in MULTISWEEP_CHUNKS:
        raise ValueError(
            f"multisweep_relax: nsweeps {nsweeps} not in {MULTISWEEP_CHUNKS}")
    check_tier("multisweep_relax", u, None, compute_dtype)
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha, beta=beta,
              dx=dx, lo=lo, compute_dtype=compute_dtype)
    if halo is not None:
        upad, rpad, apad, meta = halo
        meta = _meta(meta)
        H = 2 * nsweeps
        if tuple(upad.shape) != (2 * H,) + tuple(u.shape[1:]):
            raise ValueError(
                f"multisweep_relax: pad {tuple(upad.shape)} for H = {H} and "
                f"a slab {tuple(u.shape)}")
        if u.device.type == "cpu":
            return multisweep_relax_halo_plain(u, rhs, a, upad, rpad, apad,
                                               meta, **kw)
        return multisweep_launch("multisweep_relax_halo", u, rhs, a,
                                 pads=(upad, rpad, apad), meta=meta, **kw)
    if u.device.type == "cpu":
        return multisweep_relax_plain(u, rhs, a, **kw)
    return multisweep_launch("multisweep_relax", u, rhs, a, **kw)


def multisweep_relax_tiled_pre(
    u_pre, rhs_pre, a_pre, meta, *, ny_global: int, nsweeps: int,
    kinds: FaceKinds, rho: float, alpha: float, beta: float, dx: float, lo,
    compute_dtype=None,
):
    """nsweeps (2 or 4) red-black GSRB sweeps of one (x, y) pencil of a
    sharded level (parallel/halo.sharded_relax_2d) in one kernel launch,
    from PREPADDED operands of shape (nx + 2H, ny + 2H, nz), H = 2*nsweeps:
    the pads hold the neighbour pencils' rows, columns and corners. `meta`
    = [x_lo_edge, x_hi_edge, x_off, y_off]: the x faces as in
    multisweep_relax(halo=...); y_off places the pencil in the level, whose
    y extent is `ny_global`, so the y face rule fires only at global y = 0
    and ny_global - 1 (never at a seam) and the checkerboard stays global.
    Returns the (nx, ny, nz) pencil. CUDA tensors go to the kernel; CPU
    tensors take the plain version. Counted as
    `multisweep_relax_tiled_pre` (`multisweep_relax_tiled_pre_bf16` in the
    bf16 tier, `compute_dtype` as multisweep_relax's)."""
    if nsweeps not in MULTISWEEP_CHUNKS:
        raise ValueError(
            f"multisweep_relax_tiled_pre: nsweeps {nsweeps} not in "
            f"{MULTISWEEP_CHUNKS}")
    check_tier("multisweep_relax_tiled_pre", u_pre, None, compute_dtype)
    meta = _meta(meta)
    kw = dict(nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha, beta=beta,
              dx=dx, lo=lo, compute_dtype=compute_dtype)
    if u_pre.device.type == "cpu":
        return multisweep_relax_tiled_pre_plain(
            u_pre, rhs_pre, a_pre, meta, ny_global=ny_global, **kw)
    return multisweep_launch("multisweep_relax_tiled_pre", u_pre, rhs_pre,
                             a_pre, meta=meta, ny_global=ny_global, **kw)


def _meta(meta) -> tuple[int, int, int, int]:
    """[lo_edge, hi_edge, x_off, y_off] as a tuple of Python ints."""
    meta = tuple(int(v) for v in meta)
    if len(meta) != 4:
        raise ValueError(f"meta must hold 4 ints, got {meta}")
    return meta


def _open_pads(arr, axis: int, H: int, keep_lo: bool, keep_hi: bool):
    """`arr` padded by H on `axis` with the pads dropped where a face of
    the domain is (the plain versions' form of a prepadded array)."""
    n = arr.shape[axis] - 2 * H
    start = 0 if keep_lo else H
    stop = n + 2 * H if keep_hi else n + H
    return arr.narrow(axis, start, stop - start)


def _halo_sweeps(u_ext, r_ext, a_ext, *, nsweeps: int, kinds: FaceKinds,
                 rho: float, alpha: float, beta: float, dx: float,
                 base: int, compute_dtype=None, _where: bool = False):
    """The plain sweeps of a padded block: every pass over the whole block
    with the folded form, the face rule at the block's ends (only faces of
    the domain are ends that matter: an open end is H = 2*nsweeps cells
    from the cells kept, and what it gets wrong moves inward one cell per
    pass), parity base `base` at index (0, 0, 0); `compute_dtype` and
    `_where` as gsrb_sweeps_folded's."""
    return gsrb_sweeps_folded(
        u_ext, r_ext, a_ext, None, nsweeps=nsweeps, kinds=kinds, rho=rho,
        alpha=alpha, beta=beta, dx=dx, lo=(base, 0, 0),
        compute_dtype=compute_dtype, _where=_where,
    )


def multisweep_relax_halo_plain(
    u, rhs, a, upad, rpad, apad, meta, *, nsweeps: int, kinds: FaceKinds,
    rho: float, alpha: float, beta: float, dx: float, lo,
    compute_dtype=None, _where: bool = False,
):
    """The plain PyTorch version of `multisweep_relax(halo=...)`: the slab
    with its pads (a domain face keeps none) swept pass by pass, the x face
    rule only where an edge flag is set, parity from sum(lo) + x_off (an
    x-slab is never cut in y: y_off is not read, as in the JAX kernel); in
    the bf16 tier counted under multisweep_relax_halo_bf16 (`compute_dtype`
    and `_where` as gsrb_sweeps_folded's)."""
    kernel_counts.PLAIN_CALLS[tier_name("multisweep_relax_halo",
                                        compute_dtype)] += 1
    lo_edge, hi_edge, x_off, y_off = _meta(meta)
    H = 2 * nsweeps
    periodic_x = kinds[0][0] == PERIODIC
    keep_lo = periodic_x or not lo_edge
    keep_hi = periodic_x or not hi_edge
    cat = lambda t, p: _open_pads(  # noqa: E731
        torch.cat([p[:H], t, p[H:]], dim=0), 0, H, keep_lo, keep_hi)
    out = _halo_sweeps(
        cat(u, upad), cat(rhs, rpad), cat(a, apad), nsweeps=nsweeps,
        kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx,
        base=sum(lo) + x_off - (H if keep_lo else 0),
        compute_dtype=compute_dtype, _where=_where,
    )
    return out[H if keep_lo else 0:][:u.shape[0]]


def multisweep_relax_tiled_pre_plain(
    u_pre, rhs_pre, a_pre, meta, *, ny_global: int, nsweeps: int,
    kinds: FaceKinds, rho: float, alpha: float, beta: float, dx: float, lo,
    compute_dtype=None, _where: bool = False,
):
    """The plain PyTorch version of `multisweep_relax_tiled_pre`: the
    prepadded pencil (pads dropped at the domain's faces) swept pass by
    pass, the x face rule only where an edge flag is set, the y face rule
    at global y = 0 and ny_global - 1 (y_off + j), parity from sum(lo) +
    x_off + y_off; in the bf16 tier counted under
    multisweep_relax_tiled_pre_bf16 (`compute_dtype` and `_where` as
    gsrb_sweeps_folded's)."""
    kernel_counts.PLAIN_CALLS[tier_name("multisweep_relax_tiled_pre",
                                        compute_dtype)] += 1
    lo_edge, hi_edge, x_off, y_off = _meta(meta)
    H = 2 * nsweeps
    nx, ny = u_pre.shape[0] - 2 * H, u_pre.shape[1] - 2 * H
    periodic_x = kinds[0][0] == PERIODIC
    keep_lo, keep_hi = periodic_x or not lo_edge, periodic_x or not hi_edge
    # y: padded column c is global row c - H + y_off; keep them all but
    # those beyond a y face of the domain (outside [0, ny_global))
    c0, c1 = 0, ny + 2 * H
    if kinds[1][0] != PERIODIC:
        c0, c1 = max(c0, H - y_off), min(c1, H - y_off + ny_global)

    def cut(t):
        return _open_pads(t, 0, H, keep_lo, keep_hi)[:, c0:c1]

    x0 = H if keep_lo else 0
    y0 = H - c0
    out = _halo_sweeps(
        cut(u_pre), cut(rhs_pre), cut(a_pre), nsweeps=nsweeps, kinds=kinds,
        rho=rho, alpha=alpha, beta=beta, dx=dx,
        base=sum(lo) + x_off + y_off - x0 - y0,
        compute_dtype=compute_dtype, _where=_where,
    )
    return out[x0:x0 + nx, y0:y0 + ny]


def sharded_plan(shape, n: int, kinds: FaceKinds) -> int | None:
    """Sweeps per launch of the halo kernels on a sharded level of global
    `shape`, or None where the plain sharded ops run instead: n must be a
    multiple of the chunk the solver sends (MULTISWEEP_PLAN_CHUNK) and
    every periodic axis even (the checkerboard must agree across the
    wrap). No size term: a sharded depth has no per-pass kernel to stay
    on, the alternative is the plain sharded ops."""
    if n <= 0 or n % MULTISWEEP_PLAN_CHUNK:
        return None
    if odd_wrap_axes(shape, kinds):
        return None
    return MULTISWEEP_PLAN_CHUNK


# The residual (csrc/residual.cu): planes a block holds in its ring (kRing),
# threads a block at most (kMaxThreads), shared memory a block may take
# (the H100's 227 KB). Then residual_geometry's rule, read off
# scripts/residual_probe.py's grids of tile heights and segment lengths on
# an NVIDIA H100 80GB HBM3 at 700 W (every path shape, both forms): a step
# of a block costs ~0.8 us of latency whatever its size, so small tiles of
# about RESIDUAL_WORK threads' work (ty 2-8) were among the fastest, and a
# launch lost up to 20 % where its blocks overran the blocks the card runs
# at once by part of a wave; so the segments are cut to fill one wave.
RESIDUAL_RING = 5
# the smaller ring of the restricted form: a batch whose segments of one
# plane pair fill one wave takes it (residual_geometry)
RESIDUAL_PAIR_RING = 4
RESIDUAL_MAX_THREADS = 512
RESIDUAL_SMEM = 232448
RESIDUAL_WORK = 64


class ResidualGeometry(NamedTuple):
    """The launch of one residual / residual_restrict call."""
    vz: int        # cells a thread owns along z in each of its two rows
    vec: bool      # u, rhs, a (b) and res in 16-byte accesses
    ty: int        # rows of a y tile (even)
    ntiles: int    # y tiles
    xseg: int      # planes of an x segment (all but the last)
    nseg: int      # x segments; blocks = ntiles * nseg
    threads: int
    slot: int      # elements of one ring slot
    smem: int      # bytes of shared memory a block
    ring: int = RESIDUAL_RING  # planes in a block's ring


def residual_form(nz: int, itemsize: int, aligned: bool) -> tuple[int, bool]:
    """(VZ, VEC) of csrc/residual.cu for rows of nz cells: 16 bytes a thread
    in one access where rows start on 16 bytes (every operand aligned and nz
    a multiple of the chunk), else two cells a thread where nz is even, else
    one."""
    chunk = 16 // itemsize
    if aligned and nz % chunk == 0:
        return chunk, True
    return (2, False) if nz % 2 == 0 else (1, False)


def residual_slot(ty: int, nz: int, itemsize: int, with_b: bool) -> int:
    """Elements of a ring slot: u of the tile's ty rows and of the row above
    and below, rhs and a (and b) of its rows, rounded up to 16 bytes."""
    per = 16 // itemsize
    return -(-(ty + 2 + (3 if with_b else 2) * ty) * nz // per) * per


def residual_geometry(shape, itemsize: int, vz: int, vec: bool,
                      restrict: bool, with_b: bool, sms: int, per_sm,
                      ty: int | None = None,
                      xseg: int | None = None,
                      patches: int = 1,
                      ring: int | None = None) -> ResidualGeometry:
    """The tiles and x segments of a residual launch on a card with `sms`
    multiprocessors: the lowest even tile height whose row pairs hold
    RESIDUAL_WORK groups of VZ cells (a thread each; at most the level's
    rows), then the shortest segments (even in the restricted form) whose
    blocks fit one wave: sms x per_sm(threads, smem), the blocks one
    multiprocessor runs at once (on the card, mgk_residual_capacity),
    shared by the `patches` levels of a batch (residual_restrict_batch).
    A batch's restricted residual takes segments of one plane pair, else
    of two, with a ring of RESIDUAL_PAIR_RING planes, at the lowest tile
    height whose blocks fit one wave, where one does (each block fetches
    its planes at its start: on an H100 the 72x80x80 pair read 0.0069 ms
    so against 0.0078, its segments rounded up to two pairs at the ring of
    RESIDUAL_RING filling 360 of the wave's 660 blocks; the 104x96x96 pair
    0.0102 against 0.0116).
    `ty` / `xseg` / `ring` ask for another launch (scripts/residual_probe.py
    and scripts/batch_probe.py time them); one that does not fit a block's
    threads or shared memory raises."""
    nx, ny, nz = (int(n) for n in shape)
    if ny * nz >= 2 ** 31:
        raise ValueError(f"residual: a plane of {ny * nz} cells (below 2^31)")
    qpr = nz // vz
    step = 2 if restrict else 1
    ty_asked = ty
    if ty is None:
        ty = 2 * min(-(-RESIDUAL_WORK // qpr), -(-ny // 2))
    ntiles = -(-ny // ty)
    threads = -(-(ty // 2) * qpr // 32) * 32
    slot = residual_slot(ty, nz, itemsize, with_b)
    if ty_asked is None and ring is None and xseg is None and restrict \
            and patches > 1:
        for pairs_len in (2, 4):
            for t in range(2, 2 * -(-ny // 2) + 1, 2):
                try:
                    g = residual_geometry(shape, itemsize, vz, vec, True,
                                          with_b, sms, per_sm, ty=t,
                                          xseg=pairs_len, patches=patches,
                                          ring=RESIDUAL_PAIR_RING)
                except ValueError:
                    continue
                if g.ntiles * g.nseg * patches <= sms * per_sm(g.threads,
                                                               g.smem):
                    return g
    ring = RESIDUAL_RING if ring is None else ring
    smem = ring * slot * itemsize
    if (ty % 2 or threads > RESIDUAL_MAX_THREADS or smem > RESIDUAL_SMEM
            or ring not in (RESIDUAL_RING, RESIDUAL_PAIR_RING)
            or (ring == RESIDUAL_PAIR_RING and not restrict)):
        raise ValueError(f"residual: no launch for {tuple(shape)}, itemsize "
                         f"{itemsize}, ty {ty}, ring {ring}")
    if xseg is None:
        nseg = max(1, sms * per_sm(threads, smem) // (ntiles * patches))
        xseg = -(-nx // min(nseg, nx))
        xseg += xseg % step
    if xseg % step or xseg < 1:
        raise ValueError(f"residual: x segments of {xseg} planes")
    return ResidualGeometry(vz, vec, ty, ntiles, xseg, -(-nx // xseg),
                            threads, slot, smem, ring)


def residual_capacity(index: int, itemsize: int, vz: int, vec: bool,
                      restrict: bool, threads: int, smem: int) -> int:
    """Blocks of the residual instantiation (itemsize, vz, vec, restrict;
    the ring of RESIDUAL_RING planes, whose registers the smaller ring's
    share) with `threads` and `smem` that one multiprocessor of CUDA device
    `index` runs at once (mgk_residual_capacity)."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = cuda_ext.lib().mgk_residual_capacity(
            int(itemsize == 8), vz, int(vec), int(restrict), RESIDUAL_RING,
            threads, smem, ctypes.byref(cap))
    cuda_ext.check(err, "residual capacity")
    return cap.value


def _residual_geometry(shape, itemsize: int, restrict: bool, with_b: bool,
                       aligned: bool, index: int,
                       patches: int = 1) -> ResidualGeometry:
    """residual_geometry on CUDA device `index`."""
    vz, vec = residual_form(shape[2], itemsize, aligned)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    per_sm = functools.partial(residual_capacity, index, itemsize, vz, vec,
                               restrict)
    return residual_geometry(shape, itemsize, vz, vec, restrict, with_b, sms,
                             per_sm, patches=patches)


@functools.lru_cache(maxsize=None)
def _residual_launch(shape, itemsize: int, kinds: FaceKinds, restrict: bool,
                     with_b: bool, aligned: bool, index: int,
                     patches: int = 1):
    """(geometry, kinds array, geometry array) of a residual launch (of a
    batch of `patches`), kept as gsrb_relax's are (the solver calls the
    residual with a few shapes many times); the geometry array ends with
    the patches and the kinds (mgk_residual_batch reads them) and the
    ring's planes."""
    g = _residual_geometry(shape, itemsize, restrict, with_b, aligned, index,
                           patches)
    geo = (int(itemsize == 8), *shape, g.vz, int(g.vec), int(restrict), g.ty,
           g.ntiles, g.xseg, g.nseg, shape[2] // g.vz, g.slot, g.threads,
           g.smem, patches, *kinds_array(kinds), g.ring)
    return g, kinds_array(kinds), (ctypes.c_int * len(geo))(*geo)


def _aligned(ptrs, restrict: bool) -> bool:
    """Whether every operand starts on 16 bytes (the restricted output is
    written a cell at a time: its alignment does not choose the form)."""
    return not any(p % 16 for p in ptrs[:4 if restrict else 5] if p)


def residual_geometry_on(u, rhs, a, b=None, *, out, restrict: bool):
    """The geometry a residual launch on these CUDA operands takes."""
    ptrs = (u.data_ptr(), rhs.data_ptr(), a.data_ptr(), _ptr(b),
            out.data_ptr())
    return _residual_geometry(tuple(u.shape), u.element_size(), restrict,
                              b is not None, _aligned(ptrs, restrict),
                              u.device.index)


def residual_launch(name: str, u, rhs, a, b, out, *, kinds: FaceKinds,
                    rho: float, alpha: float, beta: float, dx: float):
    """One launch of csrc/residual.cu on CUDA tensors, counted under `name`:
    the whole residual into `out` (residual) or, for name
    "residual_restrict", the restricted one into the (nx/2, ny/2, nz/2)
    view `out` (z contiguous). Returns the geometry it took."""
    check_level_args(name, u, rhs, a, b)
    restrict = name == "residual_restrict"
    ptrs = (u.data_ptr(), rhs.data_ptr(), a.data_ptr(), _ptr(b),
            out.data_ptr())
    g, kinds_c, geo = _residual_launch(
        tuple(u.shape), u.element_size(), kinds, restrict, b is not None,
        _aligned(ptrs, restrict), u.device.index)
    osx, osy = (out.stride(0), out.stride(1)) if restrict else (0, 0)
    kernel_counts.count_launch(name, 1)
    err = on_stream(cuda_ext.lib().mgk_residual, u, *ptrs, kinds_c,
                    float(rho), float(alpha), float(beta), float(dx), geo,
                    osx, osy)
    cuda_ext.check(err, name)
    return g


def residual(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float,
):
    """res = rhs - L(u) of a whole level with homogeneous ghosts (optional
    variable bCoef). Returns a new tensor. CUDA tensors go to the kernel (one
    launch), CPU tensors take the plain version."""
    kw = dict(kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx)
    if u.device.type == "cpu":
        return residual_plain(u, rhs, a, b, **kw)
    res = torch.empty_like(u)
    residual_launch("residual", u, rhs, a, b, res, **kw)
    return res


def residual_restrict(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, out=None,
):
    """The residual restricted by full weighting, restrict_full(rhs - L(u)):
    the mean of the 2^3 children of each coarse cell, written into `out` (an
    (nx/2, ny/2, nz/2) tensor or view with z contiguous, e.g. the covered
    part of a parent level; it must not overlap the inputs) or a new tensor.
    Every axis must be even. CUDA tensors go to the kernel (one launch, the
    fine residual never written: bit for bit restrict_full(residual(...))),
    CPU tensors take the plain version. Returns the restricted residual."""
    kw = dict(kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx)
    shape = u.shape
    if len(shape) != 3 or shape[0] % 2 or shape[1] % 2 or shape[2] % 2:
        raise ValueError(
            f"residual_restrict: every axis must be even, got "
            f"{tuple(shape)}")
    half = (shape[0] // 2, shape[1] // 2, shape[2] // 2)
    if out is not None and (out.shape != half or out.dtype != u.dtype
                            or out.device != u.device):
        raise ValueError(
            f"residual_restrict: out {tuple(out.shape)} {out.dtype} "
            f"{out.device} for {half} {u.dtype} {u.device}")
    if u.device.type == "cpu":
        rc = residual_restrict_plain(u, rhs, a, b, **kw)
        return rc if out is None else out.copy_(rc)
    if out is None:
        out = u.new_empty(half)
    elif out.stride(2) != 1 or min(out.stride()) < 0:
        raise ValueError(
            f"residual_restrict: out strides {out.stride()} (z contiguous)")
    residual_launch("residual_restrict", u, rhs, a, b, out, **kw)
    return out


def residual_restrict_batch(
    us, rhss, as_, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float, outs=None,
):
    """residual_restrict of P same-shape levels with constant bCoef (the
    sibling patches of a batch group), patch k's operands at index k of the
    lists, each restricted residual written into outs[k] (a view with z
    contiguous, e.g. its own parent's covered part) or a new tensor:
    returns the P restricted residuals. CUDA tensors go to the kernel, ONE
    launch for up to BATCH_MAX patches (mgk_residual_batch, blocks over the
    patches' tiles and segments; the operands checked by cheap queries,
    check_batch_args, the pointers and strides in one table each); CPU
    tensors take the plain version."""
    u0 = us[0]
    shape = tuple(u0.shape)
    if len(shape) != 3 or any(n % 2 for n in shape):
        raise ValueError(f"residual_restrict_batch: every axis must be "
                         f"even, got {shape}")
    half = tuple(n // 2 for n in shape)
    outs = [None] * len(us) if outs is None else list(outs)
    dt, dev = u0.dtype, u0.device
    for o in outs:
        if o is not None and (o.shape != half or o.dtype is not dt
                              or o.device != dev):
            raise ValueError(
                f"residual_restrict_batch: out {tuple(o.shape)} {o.dtype} "
                f"{o.device} for {half} {dt} {dev}")
    if dev.type == "cpu":
        rcs = residual_restrict_batch_plain(us, rhss, as_, kinds=kinds,
                                            rho=rho, alpha=alpha, beta=beta,
                                            dx=dx)
        return [rc if o is None else o.copy_(rc) for rc, o in zip(rcs, outs)]
    check_batch_args("residual_restrict_batch", us, rhss, as_)
    for o in outs:  # the caller's (new ones are contiguous)
        if o is not None and (o.stride(2) != 1 or min(o.stride()) < 0):
            raise ValueError(f"residual_restrict_batch: out strides "
                             f"{o.stride()} (z contiguous)")
    outs = [u0.new_empty(half) if o is None else o for o in outs]
    index, isz = u0.get_device(), u0.element_size()
    lib = cuda_ext.lib()
    for c in range(0, len(us), BATCH_MAX):
        pu, pr, pa, po = ((us, rhss, as_, outs) if len(us) <= BATCH_MAX else
                          (us[c:c + BATCH_MAX], rhss[c:c + BATCH_MAX],
                           as_[c:c + BATCH_MAX], outs[c:c + BATCH_MAX]))
        n = len(pu)
        table, ptrs = _table(pu, pr, pa, po)
        _, _, geo = _residual_launch(
            shape, isz, kinds, True, False,
            not any(p % 16 for p in ptrs[:3 * n]), index, n)
        strides = array.array("q", [o.stride(0) for o in po]
                              + [o.stride(1) for o in po])
        kernel_counts.count_launch("residual_restrict_batch", 1)
        err = on_stream(lib.mgk_residual_batch, u0,
                         table.buffer_info()[0], strides.buffer_info()[0],
                         float(rho), float(alpha), float(beta), float(dx),
                         geo)
        cuda_ext.check(err, "residual_restrict_batch")
    return outs


def _batch_aligned(us, rhss, as_) -> bool:
    """Whether every patch's operands start on 16 bytes (_aligned)."""
    return all(_aligned((u.data_ptr(), r.data_ptr(), a.data_ptr()), True)
               for u, r, a in zip(us, rhss, as_))


def residual_batch_geometry(us, rhss, as_) -> ResidualGeometry:
    """The geometry residual_restrict_batch's launch takes for these CUDA
    operands (at most BATCH_MAX patches)."""
    return _residual_geometry(tuple(us[0].shape), us[0].element_size(), True,
                              False, _batch_aligned(us, rhss, as_),
                              us[0].device.index, len(us))
