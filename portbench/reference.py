"""Plain reference that judges the benchmark's solves.

A solve hands back psi, the regular part of the conformal factor, on every
level of the hierarchy, with the last Picard correction dpsi, the history
of correction norms and, in a periodic box, the constant K. This module
judges those outputs by what they say, in float64 plain PyTorch, from the
params file and the drawn parameters alone. It imports nothing of the
program and takes nothing the program made:

* `hierarchy` rebuilds the chain of refined boxes from the params (the
  regrid condition on psi = 1, tags at `refine_threshold` of its maximum,
  their bounding box grown by 2 and block-aligned inside the parent's
  nesting region), so that the solve is judged on the grid users asked
  for;
* `judge` evaluates the Hamiltonian-constraint residual of the returned
  psi on every valid (uncovered) cell, with quadratic coarse-fine ghosts
  and the physical boundary values, K worked out again from psi in a
  periodic box, and scales it by the residual of psi = 1; it also works
  out again the last history entry (the composite L2 norm of dpsi) and the
  K the last iteration used (from psi - dpsi).

The formulas are those of the reference C++ code (SetLevelData.cpp,
SetBinaryBH.H, MyPhiFunction.H, QuadCFInterp, SetBCs.cpp), written as
tensor expressions; the regrid condition keeps their order of operations
so that tags at the threshold fall as the program's do.
"""

from __future__ import annotations

import math

import torch

REF_RATIO = 2
NESTING_RADIUS = 2
TAGS_GROW = 2
DIRICHLET, NEUMANN = 0, 1

# the normal-direction quadratic through the coarse centre and the first
# two fine cells, evaluated at the fine ghost (ratio 2)
W_COARSE, W_U0, W_U1 = 8.0 / 15.0, 2.0 / 3.0, -1.0 / 5.0


# ------------------------------------------------------------------ params


def read_params(path: str) -> dict:
    """`key = value ...` lines of a params file (comments after #)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if "=" in line:
                key, val = line.split("=", 1)
                out[key.strip()] = val.split()
    return out


class Params:
    """The physical and grid parameters the judge needs, from the params
    file's tokens with the drawn values over them."""

    def __init__(self, tokens: dict, draws: dict | None = None):
        t = dict(tokens)
        for k, v in (draws or {}).items():
            t[k] = [repr(float(v))]
        real = lambda k, d=None: float(t[k][0]) if k in t else d  # noqa
        self.L = real("L")
        self.n = tuple(int(x) for x in t["N"][:3])
        self.max_level = int(t["max_level"][0])
        self.refine_threshold = real("refine_threshold")
        self.block_factor = int(t["block_factor"][0])
        self.periodic = bool(int(t["is_periodic"][0]))
        self.bc_lo = tuple(int(x) for x in t["bc_lo"][:3])
        self.bc_hi = tuple(int(x) for x in t["bc_hi"][:3])
        self.bc_value = real("bc_value", 0.0)
        self.G = real("G_Newton")
        self.phi_profile = t.get("phi_profile", ["gaussian"])[0]
        self.phi_amplitude = real("phi_amplitude")
        self.phi_wavelength = real("phi_wavelength")
        self.mass = (real("bh1_bare_mass"), real("bh2_bare_mass"))
        self.spin = (real("bh1_spin"), real("bh2_spin"))
        self.momentum = (real("bh1_momentum"), real("bh2_momentum"))
        self.offset = (real("bh1_offset"), real("bh2_offset"))
        for key, plain in (("level_decomposition", "bbox"),
                           ("average_down", "0")):
            if t.get(key, [plain])[0] != plain:
                raise ValueError(f"the judge takes {key} = {plain} only")
        self.dx0 = self.L / self.n[0]
        self.length = tuple(self.dx0 * m for m in self.n)


# --------------------------------------------------------------- hierarchy


class Hier:
    """A chain of boxes, one per depth: (lo, hi) inclusive, global index
    space of its depth; entry d refines entry d - 1 by 2."""

    def __init__(self, p: Params, boxes: list):
        self.p, self.boxes = p, list(boxes)
        self.dx = [p.dx0 / REF_RATIO ** d for d in range(len(boxes))]
        self.domain = [((0, 0, 0), tuple(m * REF_RATIO ** d - 1
                                         for m in p.n))
                       for d in range(len(boxes))]

    @property
    def levels(self) -> int:
        return len(self.boxes)

    def shape(self, l: int) -> tuple:
        lo, hi = self.boxes[l]
        return tuple(h - a + 1 for a, h in zip(lo, hi))

    def coords(self, l: int, grow: int = 0, device=None):
        lo, hi = self.boxes[l]
        out = []
        for ax in range(3):
            i = torch.arange(lo[ax] - grow, hi[ax] + 1 + grow,
                             dtype=torch.float64)
            c = (i + 0.5) * self.dx[l] - self.p.length[ax] / 2.0
            shape = [1, 1, 1]
            shape[ax] = -1
            out.append(c.reshape(shape).to(device))
        return out

    def covered(self, l: int):
        """Slices of entry l covered by entry l + 1, or None."""
        if l + 1 >= self.levels:
            return None
        (clo, chi), (lo, _) = self.boxes[l + 1], self.boxes[l]
        return tuple(slice(a // 2 - o, b // 2 - o + 1)
                     for a, b, o in zip(clo, chi, lo))


def _box_cut(a, b):
    lo = tuple(max(x, y) for x, y in zip(a[0], b[0]))
    hi = tuple(min(x, y) for x, y in zip(a[1], b[1]))
    return None if any(h < l for l, h in zip(lo, hi)) else (lo, hi)


def hierarchy(p: Params, device=None) -> Hier:
    """The chain users get from these params: each depth tagged on psi = 1
    where |condition| >= refine_threshold * max|condition|; the tags'
    bounding box, aligned outward to blocks of max(block_factor / 2, 2)
    in the level's own frame, grown by 2 cells, cut to the parent shrunk
    by the nesting radius on faces off the domain, aligned outward to
    blocks of max(block_factor / 2, 1) and cut again, then refined."""
    blk_tag = max(p.block_factor // 2, 2)
    blk = max(p.block_factor // 2, 1)
    boxes = [((0, 0, 0), tuple(m - 1 for m in p.n))]
    for d in range(p.max_level):
        h = Hier(p, boxes)
        cond = regrid_condition(h, d, device)
        thresh = p.refine_threshold * float(cond.abs().max())
        mask = cond.abs() >= thresh
        if not bool(mask.any()):
            break
        lo, hi = h.boxes[d]
        n = h.shape(d)
        tlo, thi = [], []
        for ax in range(3):
            others = tuple(a for a in range(3) if a != ax)
            idx = torch.nonzero(mask.any(dim=others[1]).any(dim=others[0]))
            a, b = int(idx.min()), int(idx.max())
            a = a // blk_tag * blk_tag
            b = min(-(-(b + 1) // blk_tag) * blk_tag - 1, n[ax] - 1)
            tlo.append(lo[ax] + a - TAGS_GROW)
            thi.append(lo[ax] + b + TAGS_GROW)
        dlo, dhi = h.domain[d]
        alo = [l + (NESTING_RADIUS if l != m else 0) for l, m in zip(lo, dlo)]
        ahi = [x - (NESTING_RADIUS if x != m else 0) for x, m in zip(hi, dhi)]
        cut = _box_cut((tuple(tlo), tuple(thi)), (tuple(alo), tuple(ahi)))
        if cut is None:
            break
        clo = tuple(max(a // blk * blk, m) for a, m in zip(cut[0], alo))
        chi = tuple(min(-(-(b + 1) // blk) * blk - 1, m)
                    for b, m in zip(cut[1], ahi))
        boxes.append((tuple(a * 2 for a in clo),
                      tuple((b + 1) * 2 - 1 for b in chi)))
    return Hier(p, boxes)


# ----------------------------------------------------------------- physics


def _phi(x, y, z, p: Params):
    if p.phi_profile == "sine":
        w, two_pi = p.phi_wavelength, 2.0 * math.pi
        lx, ly, lz = p.length
        return p.phi_amplitude * (torch.sin(two_pi * x * w / lx)
                                  + torch.sin(two_pi * y * w / ly)
                                  + torch.sin(two_pi * z * w / lz))
    r2 = x * x + y * y + z * z
    return p.phi_amplitude * torch.exp(-r2 / p.phi_wavelength)


_EPS = {(0, 1, 2): 1.0, (1, 2, 0): 1.0, (2, 0, 1): 1.0,
        (0, 2, 1): -1.0, (2, 1, 0): -1.0, (1, 0, 2): -1.0}
_SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _puncture(x, y, z, offset):
    dx_, dy_, dz_ = x - offset, y, z
    r = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    return r, (dx_ / r, dy_ / r, dz_ / r)


def _aij_one(i, j, r, n, P, J):
    """One puncture's Bowen-York bar A_ij (SetBinaryBH.H)."""
    delta = 1.0 if i == j else 0.0
    p_dot_n = sum(P[k] * n[k] for k in range(3) if P[k] != 0.0)
    term_p = (1.5 / (r * r)) * (
        n[i] * P[j] + n[j] * P[i] + (n[i] * n[j] - delta) * p_dot_n)
    term_s = 0.0
    for k in range(3):
        if J[k] == 0.0:
            continue
        for l in range(3):
            e_ilk, e_jlk = _EPS.get((i, l, k), 0.0), _EPS.get((j, l, k), 0.0)
            if e_ilk == 0.0 and e_jlk == 0.0:
                continue
            term_s = term_s - (3.0 / (r * r * r)) * (
                (e_ilk * n[j] + e_jlk * n[i]) * n[l] * J[k])
    return term_p + term_s


def fields(h: Hier, l: int, device=None) -> dict:
    """A^2 = bar A_ij bar A^ij, the gradient energy of phi (central
    differences of phi over a one-cell-grown box) and the singular
    psi_bh = m1/r1 + m2/r2, on entry l."""
    p, shape = h.p, h.shape(l)
    x, y, z = h.coords(l, 0, device)
    xg, yg, zg = h.coords(l, 1, device)
    phi = torch.broadcast_to(_phi(xg, yg, zg, p), tuple(s + 2 for s in shape))
    inv2dx, c = 0.5 / h.dx[l], slice(1, -1)
    gx = (phi[2:, c, c] - phi[:-2, c, c]) * inv2dx
    gy = (phi[c, 2:, c] - phi[c, :-2, c]) * inv2dx
    gz = (phi[c, c, 2:] - phi[c, c, :-2]) * inv2dx
    rho_grad = 0.5 * (gx * gx + gy * gy + gz * gz)
    r1, n1 = _puncture(x, y, z, p.offset[0])
    r2, n2 = _puncture(x, y, z, p.offset[1])
    a2 = 0.0
    for i, j in _SYM:
        comp = _aij_one(i, j, r1, n1, (0.0, p.momentum[0], 0.0),
                        (0.0, 0.0, p.spin[0])) + _aij_one(
            i, j, r2, n2, (0.0, p.momentum[1], 0.0), (0.0, 0.0, p.spin[1]))
        comp = torch.broadcast_to(comp, shape).contiguous()
        a2 = a2 + (1.0 if i == j else 2.0) * comp * comp
    psi_bh = torch.broadcast_to(p.mass[0] / r1 + p.mass[1] / r2,
                                shape).contiguous()
    return {"aij2": a2, "rho_grad": rho_grad, "psi_bh": psi_bh}


def regrid_condition(h: Hier, l: int, device=None):
    """SetLevelData's regrid condition on psi = 1, m at K = 0."""
    f = fields(h, l, device)
    psi0 = torch.ones(h.shape(l), dtype=torch.float64,
                      device=f["psi_bh"].device) + f["psi_bh"]
    return (1.5 * abs(0.0) + 1.5 * f["aij2"] * psi0 ** -7
            + 24.0 * math.pi * h.p.G * torch.abs(f["rho_grad"]) * psi0
            + torch.log(psi0))


def _m(p: Params, k):
    return (2.0 / 3.0) * k * k


def laplacian(g, dx):
    c = slice(1, -1)
    s = (g[2:, c, c] + g[:-2, c, c] + g[c, 2:, c] + g[c, :-2, c]
         + g[c, c, 2:] + g[c, c, :-2])
    return (s - 6.0 * g[c, c, c]) / (dx * dx)


# ------------------------------------------------------------ ghost cells


def _upsample2(c, axis):
    """Cell-centred quadratic refinement by 2 of one axis (the input
    carries one extra coarse cell at each end)."""
    c = torch.movedim(c, axis, 0)
    lo, mid, hi = c[:-2], c[1:-1], c[2:]
    even = (5.0 / 32.0) * lo + (30.0 / 32.0) * mid - (3.0 / 32.0) * hi
    odd = -(3.0 / 32.0) * lo + (30.0 / 32.0) * mid + (5.0 / 32.0) * hi
    out = torch.stack([even, odd], 1).reshape((-1,) + tuple(mid.shape[1:]))
    return torch.movedim(out, 0, axis)


def _coarse_plane(h: Hier, l: int, coarse, axis: int, side: int, wrap: bool):
    """The parent's values under the (axis, side) ghost plane of entry l,
    interpolated tangentially onto the fine plane (edge-replicated where
    the parent box ends)."""
    (flo, fhi), (clo, chi) = h.boxes[l], h.boxes[l - 1]
    g = flo[axis] - 1 if side == 0 else fhi[axis] + 1
    cg = g // 2
    if wrap:
        m = h.domain[l - 1][1][axis] + 1
        cg %= m
    idx, pads = [None] * 3, []
    idx[axis] = cg - clo[axis]
    for t in range(3):
        if t == axis:
            continue
        want_lo, want_hi = flo[t] // 2 - 1, fhi[t] // 2 + 1
        a, b = max(want_lo, clo[t]), min(want_hi, chi[t])
        idx[t] = slice(a - clo[t], b - clo[t] + 1)
        pads.append((a - want_lo, want_hi - b))
    plane = coarse[tuple(idx)]
    if any(q != (0, 0) for q in pads):
        flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
        plane = torch.nn.functional.pad(plane[None, None], flat,
                                        mode="replicate")[0, 0]
    return _upsample2(_upsample2(plane, 0), 1)


def ghosted(h: Hier, l: int, u, coarse):
    """u with one ring of ghosts: periodic wrap where the level spans a
    periodic axis, the quadratic coarse-fine interpolation from `coarse`
    on every other face off the domain (a periodic face at the domain
    edge included: its parent wraps), the Dirichlet or Neumann value fill
    on physical faces (psi's boundary value is 1 + bc_value)."""
    p = h.p
    (lo, hi), (dlo, dhi) = h.boxes[l], h.domain[l]
    g, grown = u, [False] * 3
    for axis in range(3):
        spans = lo[axis] == dlo[axis] and hi[axis] == dhi[axis]
        n = g.shape[axis]
        planes = []
        for side in (0, 1):
            at_dom = (lo[axis] == dlo[axis]) if side == 0 else (
                hi[axis] == dhi[axis])
            i0, i1 = (0, 1) if side == 0 else (n - 1, n - 2)
            u0, u1 = g.narrow(axis, i0, 1), g.narrow(axis, i1, 1)
            if p.periodic and spans:
                planes.append(g.narrow(axis, n - 1 if side == 0 else 0, 1))
                continue
            if p.periodic or not at_dom:
                plane = _coarse_plane(h, l, coarse, axis, side,
                                      p.periodic and at_dom).unsqueeze(axis)
                pad = [(1, 1) if grown[t] and t != axis else (0, 0)
                       for t in range(3)]
                if any(q != (0, 0) for q in pad):
                    flat = []
                    for a, b in reversed(pad):
                        flat += [a, b]
                    plane = torch.nn.functional.pad(
                        plane[None, None], flat, mode="replicate")[0, 0]
                planes.append(W_U0 * u0 + W_U1 * u1 + W_COARSE * plane)
                continue
            flag = p.bc_lo[axis] if side == 0 else p.bc_hi[axis]
            if flag == DIRICHLET:
                planes.append((8.0 / 3.0) * (p.bc_value + 1.0) - 2.0 * u0
                              + (1.0 / 3.0) * u1)
            elif flag == NEUMANN:
                sign = -1.0 if side == 0 else 1.0
                planes.append(u0 + sign * h.dx[l] * p.bc_value)
            else:
                raise ValueError(f"boundary flag {flag}")
        g = torch.cat([planes[0], g, planes[1]], dim=axis)
        grown[axis] = True
    return g


# --------------------------------------------------------------- the judge


def _valid(h: Hier, l: int, x, fill=0.0):
    cov = h.covered(l)
    if cov is None:
        return x
    x = x.clone()
    x[cov] = fill
    return x


def constant_k(h: Hier, psi: list, device=None):
    """K = -sqrt(|integral| / volume) of the integrand of
    SetLevelData.cpp's set_constant_K_integrand over the valid cells."""
    p, total = h.p, 0.0
    for l in range(h.levels):
        f = fields(h, l, device)
        g = ghosted(h, l, psi[l], psi[l - 1] if l else None)
        psi0 = g[1:-1, 1:-1, 1:-1] + f["psi_bh"]
        integrand = (1.5 * f["aij2"] * psi0 ** -12
                     + 24.0 * math.pi * p.G * f["rho_grad"] * psi0 ** -4
                     + 12.0 * laplacian(g, h.dx[l]) * psi0 ** -5)
        total = total + h.dx[l] ** 3 * float(_valid(h, l, integrand).sum())
    return -math.sqrt(abs(total) / math.prod(p.length))


def residual_max(h: Hier, psi: list, k: float, device=None) -> float:
    """max over valid cells of |rhs(psi)|: 1/8 m psi_0^5 - 1/8 A^2
    psi_0^-7 - 2 pi G rho_grad psi_0 - Lap(psi), psi_0 = psi + psi_bh."""
    p, worst = h.p, 0.0
    for l in range(h.levels):
        f = fields(h, l, device)
        g = ghosted(h, l, psi[l], psi[l - 1] if l else None)
        psi0 = g[1:-1, 1:-1, 1:-1] + f["psi_bh"]
        r = (0.125 * _m(p, k) * psi0 ** 5 - 0.125 * f["aij2"] * psi0 ** -7
             - 2.0 * math.pi * p.G * f["rho_grad"] * psi0
             - laplacian(g, h.dx[l]))
        worst = max(worst, float(_valid(h, l, r.abs()).max()))
    return worst


def l2_norm(h: Hier, u: list) -> float:
    """The composite L2 norm over valid cells, volume-weighted."""
    return math.sqrt(sum(h.dx[l] ** 3 * float((_valid(h, l, u[l]) ** 2).sum())
                         for l in range(h.levels)))


def judge(h: Hier, psi: list, dpsi: list, k_solved: float, history: list,
          device=None) -> dict:
    """The numbers one solve is judged by (each a gap, 0 when exact):
    `residual`, the largest constraint residual of psi over the valid
    cells as a share of that of psi = 1; `history`, the last history
    entry's relative gap to the norm of dpsi; `k` (periodic), the K the
    last iteration used against K of psi - dpsi."""
    psi = [x.to(device, torch.float64) for x in psi]
    dpsi = [x.to(device, torch.float64) for x in dpsi]
    ones = [torch.ones_like(x) for x in psi]
    k_of = (lambda u: constant_k(h, u, device)) if h.p.periodic else (
        lambda u: 0.0)
    out = {"residual": residual_max(h, psi, k_of(psi), device)
           / residual_max(h, ones, k_of(ones), device)}
    norm = l2_norm(h, dpsi)
    out["history"] = abs(history[-1] - norm) / max(norm, 1e-300)
    if h.p.periodic:
        k_prev = k_of([a - b for a, b in zip(psi, dpsi)])
        out["k"] = abs(k_solved - k_prev) / abs(k_prev)
    return out
