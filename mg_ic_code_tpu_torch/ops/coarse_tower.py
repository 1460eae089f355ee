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

Each of the two is ONE cooperative CUDA launch for CUDA tensors
(csrc/tower.cu; the split of the chain between grid-wide depths and the
one-block tail is `tower_geometry`, kept per chain), and a plain PyTorch
version (`tower_down_plain` / `tower_up_plain`) that the wrappers take only
for CPU tensors. The per-depth math is the same the staged path runs, so the tower
matches the per-depth V-cycle to reorder tolerance.

Under the spec's smoother_compute "bfloat16" (the bf16 tier) every depth's
colour passes run in bf16, each depth's relax rounding its starting state,
as the JAX package's towers do (their compute_dtype); the residual, the
restriction and the prolongation stay f32. Those launches are counted
under tower_down_bf16 / tower_up_bf16.

Reference structure this fuses: the MG depth recursion AMRMultiGrid drives
through VariableCoeffPoissonOperator::levelGSRB / restrictResidual /
prolongIncrement.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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


def _relax_kw(spec, d: int, k: int, _where: bool = False) -> dict:
    return dict(
        nsweeps=spec.nsmooth, kinds=spec.kinds, rho=spec.rho[d + k],
        alpha=spec.alpha, beta=spec.beta, dx=spec.dx[d + k],
        lo=spec.boxes[d + k].lo, compute_dtype=spec.smoother_compute,
        _where=_where,
    )


def tower_down_plain(spec, d: int, u, rhs, a_list, _where: bool = False):
    """Plain PyTorch down pass over depths [d, end). Returns
    (u_list[0..ndep-2], rhs_list[1..ndep-1], u_bot). `_where`: each
    depth's relaxation with the kernels' colour select
    (fused_sweeps.gsrb_sweeps_folded)."""
    kernel_counts.PLAIN_CALLS[fs.tier_name(
        "tower_down", spec.smoother_compute)] += 1
    ndep = spec.ndepths - d
    u_outs, r_outs = [], []
    for k in range(ndep - 1):
        kw = _relax_kw(spec, d, k, _where)
        u = fs.gsrb_relax_plain(u, rhs, a_list[k], **kw)
        u_outs.append(u)
        for key in ("nsweeps", "lo", "compute_dtype", "_where"):
            kw.pop(key)
        res = fs.residual_plain(u, rhs, a_list[k], **kw)
        rhs = _restrict_pairs(res)
        r_outs.append(rhs)
        u = torch.zeros_like(rhs)
    u_bot = fs.gsrb_relax_plain(
        u, rhs, a_list[ndep - 1], **_relax_kw(spec, d, ndep - 1, _where)
    )
    return u_outs, r_outs, u_bot


def tower_up_plain(spec, d: int, e_bot, u_list, rhs_list, a_list,
                   _where: bool = False):
    """Plain PyTorch up pass: prolong-increment + post-smooth per depth,
    from the bottom correction to depth d. Returns the depth-d state.
    `_where` as tower_down_plain's."""
    kernel_counts.PLAIN_CALLS[fs.tier_name(
        "tower_up", spec.smoother_compute)] += 1
    ndep = spec.ndepths - d
    e = e_bot
    for k in range(ndep - 2, -1, -1):
        u = st.prolong_inc(u_list[k], e)
        e = fs.gsrb_relax_plain(
            u, rhs_list[k], a_list[k], **_relax_kw(spec, d, k, _where)
        )
    return e


def tower_supported(spec, coefs, d: int, itemsize: int = 4) -> bool:
    """Whether the depth sub-chain [d, end) can run as the tower: V-cycle
    shape (num_mg == 1 — a W-cycle's recursion tree interleaves bottom
    solves), constant bCoef, at least 2 depths below d, every tower shape
    even-coarsenable, and a top depth whose four arrays of `itemsize` bytes
    per cell (4: the kernel path runs in f32) fit the card's L2 cache
    (fused_sweeps.L2_BYTES, the size term of the smoother rungs). The
    tower's big depths pass over their arrays once per colour pass, with a
    grid barrier between passes, which is the right smoother only for a
    depth that stays in the cache between passes: a bigger depth goes
    through mg_vcycle's staged recursion, where `relax` gives it the
    wavefront or multisweep rung, and the tower starts below it. The term
    looks at the shape alone, not at where the tensors live: CPU tensors
    under `smoother = pallas` take the same split on purpose, so that a CPU
    run walks the card's dispatch (with the plain versions in the kernels'
    places)."""
    if spec.num_mg != 1 or coefs["b"][d] is not None:
        return False
    if fs.exceeds_l2(spec.boxes[d].shape, itemsize):
        return False
    ndep = spec.ndepths - d
    if ndep < 3:
        return False
    for dd in range(d, spec.ndepths - 1):
        sh = spec.boxes[dd].shape
        if any(s % 2 for s in sh) or any(s < 4 for s in sh):
            return False
    return True


# The one-launch kernels (csrc/tower.cu): threads per block (kThreads), the
# longest chain they take (kMaxDepths), and per item size the shared memory
# of the block that runs the small depths: u, rhs and a of the tail's first
# depth and one array of the depth below, (3 * 4096 + 512) cells from a 16^3
# depth on (50 KB in f32, 100 KB in f64).
TOWER_THREADS = 512
MAX_DEPTHS = 12
TOWER_SMEM = {4: 52 << 10, 8: 104 << 10}


def tower_geometry(shapes, itemsize: int, capacity: int, faces: int = 0):
    """(blocks, tail, smem) of one tower launch over the depth chain
    `shapes` (the finest first): depths [0, tail) run grid-wide, depths
    [tail, end) in one block's `smem` bytes of shared memory. The tail
    starts at the first depth whose u, rhs and a, with one array of the
    depth below and the `faces` cells of the bottom's wrap faces
    (fused_sweeps.face_cells: 0 without a periodic axis of odd extent), fit
    TOWER_SMEM (counted in bytes, whatever the shape);
    tail = len(shapes) and smem = 0 when none does. `blocks` of
    TOWER_THREADS: 1 when the whole chain is the tail; else enough for the
    top depth's colour pass (a z pair a thread), at most `capacity` (the
    blocks the card runs at once, tower_capacity: a cooperative launch
    needs all of them resident), and where that fits a whole number of x
    planes of z pairs, so that a thread keeps its pair from step to step
    (fused_sweeps.pair_grid_blocks)."""
    cells = [math.prod(s) for s in shapes] + [0]
    ndep = len(shapes)
    need = [(3 * cells[k] + cells[k + 1] + faces) * itemsize
            for k in range(ndep)]
    tail = next((k for k in range(ndep) if need[k] <= TOWER_SMEM[itemsize]),
                ndep)
    smem = need[tail] if tail < ndep else 0
    if tail == 0:
        return 1, 0, smem
    return (fs.pair_grid_blocks(shapes[0], TOWER_THREADS, int(capacity)),
            tail, smem)


def tower_capacity(device, itemsize: int, compute: int = 0,
                   odd: bool = False) -> int:
    """Blocks of both tower kernels of the item size and arithmetic
    (compute 1: the bf16 tier) at TOWER_SMEM that the CUDA device runs at
    once (mgk_tower_capacity), for a chain whose bottom has (`odd`) or has
    not a periodic axis of odd extent: tower_down has a form for each."""
    cap = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = cuda_ext.lib().mgk_tower_capacity(
            int(itemsize == 8), int(compute), int(bool(odd)),
            TOWER_SMEM[itemsize], ctypes.byref(cap))
    cuda_ext.check(err, "tower capacity")
    return cap.value


def buffer_layout(shapes):
    """Where the outputs of one call lie in its one buffer, as the C entry
    points place them: (views, down_cells, up_cells). tower_down's buffer
    holds every depth's state (the finest first), then the restricted rhs
    of depths 1 .. end, down_cells in all; tower_up's the new state of
    every depth above the bottom, up_cells. views: (shape, stride, offset)
    of each state, then of each restricted rhs."""
    ndep = len(shapes)
    cells = [math.prod(s) for s in shapes]
    offsets = [sum(cells[:k]) for k in range(ndep + 1)]
    views = tuple((s, (s[1] * s[2], s[2], 1), o)
                  for s, o in zip(shapes, offsets))
    views += tuple((s, stride, o + offsets[ndep] - cells[0])
                   for s, stride, o in views[1:])
    return views, 2 * offsets[ndep] - cells[0], offsets[ndep - 1]


class _Chain(NamedTuple):
    """What a tower launch over one depth chain needs besides its tensors."""
    shapes: tuple       # per depth (nx, ny, nz)
    views: tuple        # per depth (shape, stride, offset) in one buffer
    down_cells: int     # every state, then every restricted rhs
    up_cells: int       # the states of every depth above the bottom
    faces: int          # tower_down's scratch for the bottom's wrap faces
                        # where the bottom is grid-wide (no tail), else 0
    args: tuple         # the C entry points' arguments after the pointers,
                        # tower_geometry's last


# chains by (id(spec), d, dtype, device index, the tier); each entry keeps
# its spec, so an id is not reused while it is cached
_CHAINS: dict = {}


def _chain(spec, d: int, ref) -> _Chain:
    """The static arguments of the chain [d, end) of `spec` for tensors like
    `ref`, kept per chain: the solver calls the tower with a few chains
    many times, and its host time is part of every call's."""
    compute = int(fs.compute_type(spec.smoother_compute) is not None)
    key = (id(spec), d, ref.dtype, ref.device.index, compute)
    hit = _CHAINS.get(key)
    if hit is not None and hit[0] is spec:
        return hit[1]
    ndep = spec.ndepths - d
    if not 2 <= ndep <= MAX_DEPTHS:
        raise ValueError(f"tower: {ndep} depths (2 to {MAX_DEPTHS})")
    if compute and ref.dtype != torch.float32:
        raise TypeError(f"tower: the bf16 tier takes float32 chains, got "
                        f"{ref.dtype}")
    shapes = tuple(tuple(int(n) for n in spec.boxes[d + k].shape)
                   for k in range(ndep))
    isz = ref.element_size()
    faces = fs.face_cells(shapes[-1], spec.kinds)
    geometry = tower_geometry(
        shapes, isz, tower_capacity(ref.device, isz, compute, faces > 0),
        faces)
    args = (
        int(isz == 8), compute, ndep,
        (ctypes.c_int * (3 * ndep))(*sum(shapes, ())),
        fs.kinds_array(spec.kinds),
        (ctypes.c_double * ndep)(*[float(x) for x in spec.dx[d:]]),
        (ctypes.c_double * ndep)(*[float(x) for x in spec.rho[d:]]),
        (ctypes.c_int * ndep)(*[int(sum(spec.boxes[d + k].lo))
                                for k in range(ndep)]),
        float(spec.alpha), float(spec.beta), int(spec.nsmooth), *geometry,
    )
    chain = _Chain(shapes, *buffer_layout(shapes),
                   faces if geometry[1] == ndep else 0, args)
    if len(_CHAINS) >= 256:
        _CHAINS.clear()
    _CHAINS[key] = (spec, chain)
    return chain


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_first(name: str, t):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype} not supported (f32/f64)")


def _check_chain(name: str, shapes, ref, groups):
    """Depth k of every group has the chain's depth-k shape, is contiguous,
    and has ref's dtype and device."""
    dt, dev = ref.dtype, ref.device
    for tensors in groups:
        for k, t in enumerate(tensors):
            if (t.shape != shapes[k] or t.dtype != dt or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name}: depth {k} operand {tuple(t.shape)} {t.dtype} "
                    f"{t.device} does not match the depth chain "
                    f"({shapes[k]}, {dt}, {dev}, contiguous)"
                )


def tower_down(spec, d: int, u, rhs, a_list):
    """Down pass over depths [d, end): (u_list[0..ndep-2],
    rhs_list[1..ndep-1], u_bot). CUDA tensors go to the kernel (one
    cooperative launch; the outputs are views of one new buffer, the
    inputs are only read), CPU tensors take the plain version."""
    if u.device.type == "cpu":
        return tower_down_plain(spec, d, u, rhs, a_list)
    _check_first("tower_down", u)
    ch = _chain(spec, d, u)
    ndep = len(ch.shapes)
    if len(a_list) != ndep:
        raise ValueError(f"tower_down: need {ndep} arrays of a")
    _check_chain("tower_down", ch.shapes, u, ((u,), (rhs,), a_list))
    out = torch.empty(ch.down_cells, dtype=u.dtype, device=u.device)
    faces = (torch.empty(ch.faces, dtype=u.dtype, device=u.device)
             if ch.faces else None)
    kernel_counts.count_launch(
        fs.tier_name("tower_down", spec.smoother_compute), 1)
    err = fs.on_stream(
        cuda_ext.lib().mgk_tower_down, u, u.data_ptr(), rhs.data_ptr(),
        out.data_ptr(), fs._ptr(faces), _ptrs(a_list), *ch.args)
    cuda_ext.check(err, "tower_down")
    views = [out.as_strided(*v) for v in ch.views]
    return views[:ndep - 1], views[ndep:], views[ndep - 1]


def tower_up(spec, d: int, e_bot, u_list, rhs_list, a_list):
    """Up pass from the bottom correction to depth d; returns the depth-d
    state. CUDA tensors go to the kernel (one cooperative launch into one
    new buffer; the inputs are only read), CPU tensors take the plain
    version."""
    if e_bot.device.type == "cpu":
        return tower_up_plain(spec, d, e_bot, u_list, rhs_list, a_list)
    _check_first("tower_up", e_bot)
    ch = _chain(spec, d, e_bot)
    ndep = len(ch.shapes)
    if not (len(u_list) == len(rhs_list) == len(a_list) == ndep - 1):
        raise ValueError("tower_up: need ndep-1 arrays of u, rhs and a")
    _check_chain("tower_up", ch.shapes, e_bot,
                 (u_list, rhs_list, a_list))
    _check_chain("tower_up", ch.shapes[ndep - 1:], e_bot, ((e_bot,),))
    out = torch.empty(ch.up_cells, dtype=e_bot.dtype, device=e_bot.device)
    kernel_counts.count_launch(
        fs.tier_name("tower_up", spec.smoother_compute), 1)
    err = fs.on_stream(
        cuda_ext.lib().mgk_tower_up, e_bot, e_bot.data_ptr(), _ptrs(u_list),
        _ptrs(rhs_list), _ptrs(a_list), out.data_ptr(), *ch.args)
    cuda_ext.check(err, "tower_up")
    return out.as_strided(*ch.views[0])


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
