"""Whole-level GSRB relaxation and residual: CUDA kernels + plain versions.

The hot loop of the solver (reference: GSRBHELMHOLTZVC3D, executed
numMGsmooth smooths x 2 colours x depths x V-cycles x Krylov iterations)
and the residual that feeds restriction, each as

  * a hand-written CUDA kernel (csrc/gsrb_relax.cu, csrc/residual.cu),
    launched by `gsrb_relax` / `residual` for tensors on a CUDA device, and
  * a plain PyTorch version (`gsrb_relax_plain` / `residual_plain`) written
    from the same folded form, which the wrappers take ONLY for tensors on
    the CPU. On a CUDA tensor a wrapper launches its kernel or raises.

Both work on any level shape (the card has no residency limit) in f32 or
f64, with the homogeneous ghost rules of the six faces folded into per-cell
weights: because every rule is linear in the two interior planes
(ghost = c0*u0 + c1*u1), the GSRB update of a cell collapses to

    u <- K*u + T + sum_axis (PA * u_plus + PB * u_minus)

with P = lam*beta/dx^2 (times bCoef when it varies), PA/PB = P times
(0 across a non-periodic face, 1+c1 at it, 1 inside), K carrying the c0
feed-through, T = lam*rhs. A colour pass p keeps the cells with
(i+j+k+sum(lo)+p) odd and updates the others.
"""

from __future__ import annotations

import ctypes

import torch

from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts
from mg_ic_code_tpu_torch.ops.ghosts import (
    CF, PERIODIC, PHYS_DIRICHLET, PHYS_NEUMANN, FaceKinds, cf_homog_weights,
    ghost_plane,
)

# face kind codes shared with csrc/mg_kernels.h
_KIND_CODE = {PHYS_DIRICHLET: 0, PHYS_NEUMANN: 1, PERIODIC: 2, CF: 3}


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


def _parity(shape, dtype, base: int, device) -> torch.Tensor:
    """(i+j+k+base)&1 as a float mask."""
    ii = _iota(shape, 0, device)
    jj = _iota(shape, 1, device)
    kk = _iota(shape, 2, device)
    return ((ii + jj + kk + base) & 1).to(dtype)


def gsrb_relax_plain(
    u, rhs, a, b=None, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, lo,
):
    """nsweeps red-black sweeps of a whole level in plain PyTorch, from the
    folded form (the arithmetic of the kernel, operation for operation)."""
    kernel_counts.PLAIN_CALLS["gsrb_relax"] += 1
    P, pab, k_uc, t_rhs = _fold_coefs(
        rhs, a, kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx, bv=b,
    )
    s = u
    par0 = _parity(s.shape, s.dtype, sum(lo), s.device)
    pars = (par0, 1.0 - par0)
    for p in range(2 * nsweeps):
        acc = k_uc * s + t_rhs
        for axis in (0, 1, 2):
            pa, pb = pab[axis]
            vp = torch.roll(s, -1, axis)
            vm = torch.roll(s, 1, axis)
            acc = (acc + P * (vp + vm) if pa is None
                   else acc + pa * vp + pb * vm)
        s = acc + pars[p & 1] * (s - acc)
    return s


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
    shape, dtype and device, at least 2 cells per axis; raise otherwise."""
    if not u.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {u.device}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {u.dtype} not supported (f32/f64)")
    if u.ndim != 3 or min(u.shape) < 2:
        raise ValueError(f"{name}: bad level shape {tuple(u.shape)}")
    for t in (u,) + tuple(o for o in others if o is not None):
        if (t.device != u.device or t.dtype != u.dtype
                or t.shape != u.shape):
            raise ValueError(
                f"{name}: operands disagree: {tuple(t.shape)} {t.dtype} "
                f"{t.device} vs {tuple(u.shape)} {u.dtype} {u.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def gsrb_relax(
    u, rhs, a, b=None, *, nsweeps: int, kinds: FaceKinds, rho: float,
    alpha: float, beta: float, dx: float, lo,
):
    """nsweeps red-black GSRB sweeps of a whole level (homogeneous ghosts,
    optional variable bCoef `b`). Returns a new tensor. CUDA tensors go to
    the kernel (one launch per colour pass, issued from one C call); CPU
    tensors take the plain version."""
    if u.device.type == "cpu":
        return gsrb_relax_plain(
            u, rhs, a, b, nsweeps=nsweeps, kinds=kinds, rho=rho, alpha=alpha,
            beta=beta, dx=dx, lo=lo,
        )
    check_level_args("gsrb_relax", u, rhs, a, b)
    lib = cuda_ext.lib()
    out = u.clone()  # the kernel sweeps in place
    nx, ny, nz = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_counts.count_launch("gsrb_relax", 2 * int(nsweeps))
        err = lib.mgk_gsrb_relax(
            out.data_ptr(), rhs.data_ptr(), a.data_ptr(), _ptr(b),
            int(u.dtype == torch.float64), nx, ny, nz, kinds_array(kinds),
            float(rho), float(alpha), float(beta), float(dx), int(sum(lo)),
            int(nsweeps), stream,
        )
    cuda_ext.check(err, "gsrb_relax")
    return out


def residual(
    u, rhs, a, b=None, *, kinds: FaceKinds, rho: float, alpha: float,
    beta: float, dx: float,
):
    """res = rhs - L(u) of a whole level with homogeneous ghosts (optional
    variable bCoef). CUDA tensors go to the kernel, CPU tensors take the
    plain version."""
    if u.device.type == "cpu":
        return residual_plain(
            u, rhs, a, b, kinds=kinds, rho=rho, alpha=alpha, beta=beta, dx=dx,
        )
    check_level_args("residual", u, rhs, a, b)
    lib = cuda_ext.lib()
    res = torch.empty_like(u)
    nx, ny, nz = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel_counts.count_launch("residual", 1)
        err = lib.mgk_residual(
            u.data_ptr(), rhs.data_ptr(), a.data_ptr(), _ptr(b),
            res.data_ptr(), int(u.dtype == torch.float64), nx, ny, nz,
            kinds_array(kinds), float(rho), float(alpha), float(beta),
            float(dx), stream,
        )
    cuda_ext.check(err, "residual")
    return res
