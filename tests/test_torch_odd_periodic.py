"""Periodic axes of odd extent against the JAX package.

Along a periodic axis of odd extent n, cells 0 and n - 1 are neighbours of
one colour across the wrap. The JAX package computes each colour pass from
the state before the pass (`resident_relax_values` rolls the pre-pass
state; its towers relax with the same body), and so do the port's plain
versions. The port's kernels update a colour in place, so a pass reads
those two cells from a copy of the wrap faces made before the pass
(csrc/gsrb_walk.cuh: `Faces`, `save_faces`, `gsrb_cell_faces`).

  (a) A numpy emulation of the kernels' walk (csrc/gsrb_walk.cuh `pass_u`:
      grid-stride z pairs, two cells a thread with both loads ahead of both
      stores), its threads run one after the other, forward and reversed.
      The in-place walk without the faces depends on the order and misses
      the plain version (the test is not vacuous); with the faces, in the
      kernels' layout and order (each pass saving the next pass's faces),
      both orders give the plain version and the JAX `resident_relax`
      (interpret mode) to 1e-12 in f64. The same for the tower's passes at
      an odd periodic bottom (the one-block tail from zero, and the
      grid-wide depth whose first pass is fused into the restriction),
      against the JAX tower (`coarse_tower._tower_down_call`, interpret).
  (b) Whole solves of the periodic box at N = 20 (the tower down to a 5^3
      bottom, dense) and N = 30 (no tower; the 15^3 bottom's BiCGStab
      preconditioned by gsrb_relax) under `smoother = pallas` and the f32
      preconditioner, the port on its plain versions, against the JAX
      package at tests/test_torch_periodic.py's mixed-precision limits:
      step 1 to 1e-7 relative (two f32 preconditioners), K to 1e-10, the
      same Krylov counts.
      The box at N = 120 on 4 x-slabs of the CPU, whose 60^3 depth is cut
      into shards of 15 planes, against the unsharded solve.
  (c) The decisions that put such a bottom on the kernels: the tower takes
      a chain that ends on it, plan_for sends it to gsrb_relax, the launch
      geometry carries the faces.
  (d) chip_smoke.py's kernels line reads the 240^3 box's kernels at cases
      of the shapes its runs give them (held_at).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import load_params as jload
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC
from mg_ic_code_tpu.grid.geometry import single_level_geom as jgeom1
from mg_ic_code_tpu.ops import coarse_tower as jct
from mg_ic_code_tpu.ops import fused_sweeps as jfs
from mg_ic_code_tpu.solver import multigrid as jmg
from mg_ic_code_tpu.solver import nonlinear as jnl

import mg_ic_code_tpu_torch as mgt
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC
from mg_ic_code_tpu_torch.grid.geometry import single_level_geom as tgeom1
from mg_ic_code_tpu_torch.ops import coarse_tower as tct
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import multigrid as tmg
from mg_ic_code_tpu_torch.solver import nonlinear as tnl

torch.set_num_threads(1)

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"
ALL_P = ((P, P),) * 3
PERIODIC = mgt.__path__[0] + "/params/periodic.txt"
KW = dict(rho=2.0, alpha=1.0, beta=-1.0, dx=0.25)

# (id, shape, kinds, lo)
SHAPES = [
    ("x_9x6x10", (9, 6, 10), ((P, P), (D, C), (C, N)), (0, 5, 0)),
    ("y_6x9x8", (6, 9, 8), ((D, N), (P, P), (C, D)), (1, 0, 0)),
    ("all_5", (5, 5, 5), ALL_P, (0, 0, 0)),
    ("all_15", (15, 15, 15), ALL_P, (0, 0, 1)),
]


def fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape), rng.standard_normal(shape),
            rng.uniform(0.5, 2.0, shape))


class Level:
    """The folded update of one cell (gsrb_update's terms, from the plain
    version's fold) and the wrap faces of a level (gsrb_walk.cuh)."""

    def __init__(self, rhs, a, kinds, rho, alpha, beta, dx):
        P_, pab, k_uc, t_rhs = tfs._fold_coefs(
            torch.from_numpy(rhs), torch.from_numpy(a), kinds=kinds, rho=rho,
            alpha=alpha, beta=beta, dx=dx)
        self.P, self.k_uc, self.t = (x.numpy() for x in (P_, k_uc, t_rhs))
        self.pab = {ax: (None, None) if w[0] is None else
                    tuple(np.broadcast_to(x.numpy(), rhs.shape) for x in w)
                    for ax, w in pab.items()}
        self.shape, self.kinds = rhs.shape, kinds
        self.odd = tfs.odd_wrap_axes(rhs.shape, kinds)

    def update(self, get, c, wrap=None):
        """Cell c's new value, its state read through get(cell); across an
        odd periodic wrap through wrap(axis, side) where given (side 0:
        the neighbour at index 0, 1: at n - 1)."""
        acc = self.k_uc[c] * get(c) + self.t[c]
        for ax in range(3):
            n, i = self.shape[ax], c[ax]
            periodic = self.kinds[ax][0] == P
            up, um = list(c), list(c)
            up[ax] = (i + 1) % n if periodic or i < n - 1 else i
            um[ax] = (i - 1) % n if periodic or i > 0 else i
            vp, vm = get(tuple(up)), get(tuple(um))
            if wrap is not None and ax in self.odd:
                if i == n - 1:
                    vp = wrap(ax, 0, c)
                if i == 0:
                    vm = wrap(ax, 1, c)
            pa, pb = self.pab[ax]
            acc = (acc + self.P[c] * (vp + vm) if pa is None
                   else acc + pa[c] * vp + pb[c] * vm)
        return acc

    # the faces in the kernels' layout: per odd axis x (side, j, k), y
    # (i, side, k), z (i, j, side), one after the other
    def face_cells(self):
        return tfs.face_cells(self.shape, self.kinds)

    def face_entries(self):
        """(index in the faces, cell) of every face entry, as save_faces
        decodes its index."""
        nx, ny, nz = self.shape
        out, base = [], 0
        for ax in self.odd:
            area = nx * ny * nz // self.shape[ax]
            for m in range(2 * area):
                if ax == 0:
                    s, r = divmod(m, area)
                    j, k = divmod(r, nz)
                    cell = (nx - 1 if s else 0, j, k)
                elif ax == 1:
                    i, r = divmod(m, 2 * nz)
                    s, k = divmod(r, nz)
                    cell = (i, ny - 1 if s else 0, k)
                else:
                    s, r = m & 1, m >> 1
                    i, j = divmod(r, ny)
                    cell = (i, j, nz - 1 if s else 0)
                out.append((base + m, cell))
            base += 2 * area
        return out

    def face_index(self, ax, side, c):
        """Where gsrb_cell_faces reads the neighbour of cell c across the
        wrap of axis ax (the cell at index 0 for side 0, n - 1 for 1)."""
        nx, ny, nz = self.shape
        base = sum(2 * nx * ny * nz // self.shape[a] for a in self.odd
                   if a < ax)
        i, j, k = c
        if ax == 0:
            return base + (side * ny + j) * nz + k
        if ax == 1:
            return base + (2 * i + side) * nz + k
        return base + 2 * (i * ny + j) + side


def pair_items(shape, par):
    """The cells of colour `par` (i + j + k + par even) in the walk's item
    order: the (nx, ny, ceil(nz/2)) z pairs in C order, None past nz."""
    nx, ny, nz = shape
    hz = (nz + 1) // 2
    cells = []
    for i in range(nx):
        for j in range(ny):
            for c in range(hz):
                k = 2 * c + ((i + j + par) & 1)
                cells.append((i, j, k) if k < nz else None)
    return cells


def walk_pass(u, lv, par, threads, order, faces):
    """One colour pass in place on u as pass_u runs it, its threads one
    after the other in `order`: a thread's items first, first + threads,
    ..., two at a time (one where no thread has two), both loads ahead of
    both stores. faces: the wrap faces (None: the wrapped neighbour read in
    place, the walk without the repair)."""
    items = pair_items(u.shape, par)
    per = 2 if len(items) > threads else 1
    get = lambda c: u[c]  # noqa: E731
    wrap = (None if faces is None else
            lambda ax, side, c: faces[lv.face_index(ax, side, c)])
    for t in order:
        mine = items[t::threads]
        for g in range(0, len(mine), per):
            group = [c for c in mine[g:g + per] if c is not None]
            vals = [lv.update(get, c, wrap) for c in group]
            for c, v in zip(group, vals):
                u[c] = v


def save_faces(faces, get, lv, par, threads, order):
    """save_faces: the face entries of the pass of parity par, a thread's
    entries first, first + threads, ..."""
    entries = lv.face_entries()
    for t in order:
        for m, cell in entries[t::threads]:
            if (sum(cell) + par) % 2 == 0:
                faces[m] = get(cell)


def colour(shape, par):
    ii, jj, kk = np.indices(shape)
    return (ii + jj + kk + par) % 2 == 0


def relax_grid_walk(u0, lv, lo, nsweeps, threads, reverse, repaired):
    """gsrb_relax's grid form (csrc/gsrb_relax.cu relax_grid_kernel): the
    first pass out of place from the caller's u (exact: its reads are all
    of u), the others in place on out; repaired: the faces of pass 1 saved
    from u with the first pass, each later pass saving the next's."""
    par0 = sum(lo) % 2
    order = range(threads)[::-1] if reverse else range(threads)
    out = u0.copy()
    own = colour(u0.shape, par0)
    for c in zip(*np.nonzero(own)):
        out[c] = lv.update(lambda q: u0[q], c)
    faces = np.full(lv.face_cells(), np.nan) if repaired else None
    npass = 2 * nsweeps
    if repaired and npass > 1:
        save_faces(faces, lambda q: u0[q], lv, (par0 + 1) % 2, threads,
                   order)
    for p in range(1, npass):
        walk_pass(out, lv, (par0 + p) % 2, threads, order, faces)
        if repaired and p + 1 < npass:
            save_faces(faces, lambda q: out[q], lv, (par0 + p + 1) % 2,
                       threads, order)
    return out


def bottom_walk(lv, lo, nsweeps, threads, reverse, repaired, fused):
    """tower_down's passes at an odd bottom from zero: the one-block tail
    (fused False: every pass in place, the faces of pass 0 saved from the
    zero state first) or a grid-wide depth (fused: the first pass made by
    the restriction, from zero, then the faces zeroed and the passes in
    place)."""
    par0 = sum(lo) % 2
    order = range(threads)[::-1] if reverse else range(threads)
    u = np.zeros(lv.shape)
    faces = np.full(lv.face_cells(), np.nan) if repaired else None
    npass = 2 * nsweeps
    first = 0
    if fused:
        zero = np.zeros(lv.shape)
        for c in zip(*np.nonzero(colour(lv.shape, par0))):
            u[c] = lv.update(lambda q: zero[q], c)
        if repaired:
            faces[:] = 0.0
        first = 1
    elif repaired:
        save_faces(faces, lambda q: 0.0, lv, par0, threads, order)
    for p in range(first, npass):
        walk_pass(u, lv, (par0 + p) % 2, threads, order, faces)
        if repaired and p + 1 < npass:
            save_faces(faces, lambda q: u[q], lv, (par0 + p + 1) % 2,
                       threads, order)
    return u


@pytest.mark.parametrize("case", SHAPES, ids=[c[0] for c in SHAPES])
def test_in_place_walk_needs_the_faces(case):
    _, shape, kinds, lo = case
    u, rhs, a = fields(shape)
    lv = Level(rhs, a, kinds, **KW)
    assert lv.odd and lv.face_cells() == tfs.face_cells(shape, kinds) > 0
    kw = dict(nsweeps=2, kinds=kinds, lo=lo, **KW)
    plain = tfs.gsrb_relax_plain(torch.from_numpy(u), torch.from_numpy(rhs),
                                 torch.from_numpy(a), **kw).numpy()
    jref = np.asarray(jfs.resident_relax(
        jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a), interpret=True,
        **kw))
    scale = float(np.abs(plain).max())
    assert np.abs(jref - plain).max() <= 1e-12 * scale
    # the kernels' twin (their colour select) reads the pre-pass state
    # across the wrap as the plain version does
    twin = tfs.gsrb_sweeps_folded(
        torch.from_numpy(u), torch.from_numpy(rhs), torch.from_numpy(a),
        _where=True, **kw).numpy()
    assert np.abs(twin - plain).max() <= 1e-12 * scale
    threads = 64  # two cells a thread on every shape here
    runs = {(rep, rev): relax_grid_walk(u, lv, lo, 2, threads, rev, rep)
            for rep in (False, True) for rev in (False, True)}
    # the walk without the faces: the order decides, and neither order is
    # the plain version
    fwd, rev = runs[(False, False)], runs[(False, True)]
    assert np.abs(fwd - rev).max() > 1e-3 * scale
    assert min(np.abs(fwd - plain).max(),
               np.abs(rev - plain).max()) > 1e-3 * scale
    for rev_ in (False, True):
        out = runs[(True, rev_)]
        assert np.abs(out - plain).max() <= 1e-12 * scale
        assert np.abs(out - jref).max() <= 1e-12 * scale


@pytest.fixture(scope="module")
def jax_odd_bottom():
    """The JAX tower's down pass on a periodic 20^3 level in f64 (depths
    20, 10, 5): the bottom's restricted rhs and its pre-smoothed state."""
    u0, rhs, a = fields((20, 20, 20), seed=3)
    jspec = jmg.make_level_spec(jgeom1(20, 1.0, JBC(periodic=True)), 0,
                                alpha=1.0, beta=-1.0, nsmooth=4,
                                smoother="pallas")
    jco = jmg.build_level_coefs(jspec, jnp.asarray(a))
    assert jct.tower_supported(jspec, jco, 0)
    _, jr, jub = jct._tower_down_call(jspec, 0, jnp.asarray(u0),
                                      jnp.asarray(rhs), list(jco["a"]), True)
    bot = jspec.ndepths - 1
    assert tuple(jspec.boxes[bot].shape) == (5, 5, 5)
    return dict(rhs=np.array(jr[-1]), a=np.array(jco["a"][bot]),
                u=np.array(jub), rho=jspec.rho[bot], dx=jspec.dx[bot],
                lo=jspec.boxes[bot].lo, nsmooth=jspec.nsmooth)


@pytest.mark.parametrize("fused", [False, True], ids=["tail", "grid_wide"])
def test_tower_bottom_walk_needs_the_faces(jax_odd_bottom, fused):
    """tower_down's passes at the odd 5^3 bottom, from the rhs the JAX
    tower restricted to it, against the JAX tower's bottom state."""
    b = jax_odd_bottom
    lv = Level(b["rhs"], b["a"], ALL_P, b["rho"], 1.0, -1.0, b["dx"])
    scale = float(np.abs(b["u"]).max())
    threads = 32
    runs = {(rep, rev): bottom_walk(lv, b["lo"], b["nsmooth"], threads, rev,
                                    rep, fused)
            for rep in (False, True) for rev in (False, True)}
    fwd, rev = runs[(False, False)], runs[(False, True)]
    assert np.abs(fwd - rev).max() > 1e-3 * scale
    assert min(np.abs(fwd - b["u"]).max(),
               np.abs(rev - b["u"]).max()) > 1e-3 * scale
    for rev_ in (False, True):
        assert np.abs(runs[(True, rev_)] - b["u"]).max() <= 1e-12 * scale


@pytest.mark.parametrize("nx,wrong", [(9, True), (10, False)],
                         ids=["odd_x", "even_x"])
def test_jax_full_sweep_kernel_misses_at_odd_periodic_x(nx, wrong):
    """Why gsrb_full_sweep keeps raising at an odd periodic axis: the JAX
    package's own kernel (pallas_kernels.gsrb_full_sweep, interpret mode)
    misses its resident_relax there (read 0.375 of max|reference| at
    (9, 8, 128), x periodic), so there is no answer to match; at an even
    extent the two agree."""
    from mg_ic_code_tpu.ops import pallas_kernels as jpk

    shape = (nx, 8, 128)
    u, rhs, a = fields(shape)
    kw = dict(kinds=SHAPES[0][2], lo=(0, 0, 0), **KW)
    args = (jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a))
    full = np.asarray(jpk.gsrb_full_sweep(*args, interpret=True, **kw))
    ref = np.asarray(jfs.resident_relax(*args, nsweeps=1, interpret=True,
                                        **kw))
    rel = np.abs(full - ref).max() / np.abs(ref).max()
    assert rel > 0.1 if wrong else rel <= 1e-12
    if wrong:  # the port's full sweep refuses the shape on the card
        with pytest.raises(ValueError, match="odd periodic axis"):
            tfs.sweep_geometry(shape, 4, SHAPES[0][2], True,
                               lambda *_: 132)


# --------------------------------------------------------------------------
# (b) whole solves


@pytest.mark.parametrize("n,tower", [(20, True), (30, False)],
                         ids=["20_tower_dense_5", "30_bicgstab_15"])
def test_odd_bottom_solve_matches_jax(n, tower, monkeypatch):
    over = [f"N = {n} {n} {n}", "max_NL_iterations = 2", "verbosity = 0",
            "precond_precision = single", "smoother = pallas"]
    jcfg, tcfg = jload(PERIODIC, over), mgt.load_params(PERIODIC, over)
    jres = jnl.poisson_solve(jcfg, verbose=False)
    kernel_counts.reset()
    relaxed = set()  # the level shapes gsrb_relax's wrapper was called at
    wrapper = tfs.gsrb_relax

    def counted(u, *args, **kw):
        relaxed.add(tuple(u.shape))
        return wrapper(u, *args, **kw)

    monkeypatch.setattr(tfs, "gsrb_relax", counted)
    tres = tnl.poisson_solve(tcfg, device="cpu", verbose=False)
    th, jh = tres.dpsi_norm_history, jres.dpsi_norm_history
    assert th[0] == pytest.approx(jh[0], rel=1e-7)
    assert th[1] < 1e-2 * th[0]
    assert tres.constant_K == pytest.approx(jres.constant_K, rel=1e-10)
    assert tres.linear_iters == jres.linear_iters
    plain = kernel_counts.PLAIN_CALLS
    assert (plain["tower_down"] > 0) == tower
    # with the tower and a dense bottom no depth reaches gsrb_relax's
    # wrapper; without it every depth does, the odd bottom's BiCGStab
    # preconditioner too
    assert relaxed == (set() if tower else {(30, 30, 30), (15, 15, 15)})
    assert all(v == 0 for v in kernel_counts.LAUNCHES.values())


def test_odd_local_extent_on_x_slabs_matches_unsharded(monkeypatch):
    """The periodic box at N = 120 on 4 x-slabs of the CPU: 120^3 and 60^3
    are cut (30 and 15 planes a shard), 30^3 and 15^3 are not. A shard of
    15 planes ends inside a coarse cell, so its coefficient, its restricted
    residual and the correction prolonged onto it go through the whole
    depth (the JAX package's arrays are global: the same values). Step 1,
    K and the Krylov counts are the unsharded solve's; the uncut depths take
    gsrb_relax (the 240^3 box's route on 4 x-slabs)."""
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh

    over = ["N = 120 120 120", "max_NL_iterations = 2", "verbosity = 0",
            "precond_precision = single", "smoother = pallas"]
    cfg = mgt.load_params(PERIODIC, over)
    ref = tnl.poisson_solve(cfg, device="cpu", verbose=False)
    relaxed = set()
    wrapper = tfs.gsrb_relax

    def counted(u, *args, **kw):
        relaxed.add(tuple(u.shape))
        return wrapper(u, *args, **kw)

    monkeypatch.setattr(tfs, "gsrb_relax", counted)
    kernel_counts.reset()
    res = tnl.poisson_solve(cfg, device="cpu", verbose=False,
                            mesh=pmesh.make_mesh(["cpu"] * 4))
    h, hr = res.dpsi_norm_history, ref.dpsi_norm_history
    assert h[0] == pytest.approx(hr[0], rel=1e-12)
    assert res.constant_K == pytest.approx(ref.constant_K, rel=1e-10)
    assert res.linear_iters == ref.linear_iters
    assert kernel_counts.PLAIN_CALLS["multisweep_relax_halo"] > 0
    assert relaxed == {(30, 30, 30), (15, 15, 15)}


# --------------------------------------------------------------------------
# (c) the decisions


def test_decisions_put_the_odd_bottom_on_the_kernels():
    """The 240^3 box: the tower from 120^3 down to its 15^3 bottom (the
    evenness is asked down to the depth above the bottom), a BiCGStab bottom
    preconditioned by gsrb_relax; the launch geometry of that bottom."""
    tspec = tmg.make_level_spec(tgeom1(240, 16.0, TBC(periodic=True)), 0,
                                alpha=1.0, beta=-1.0, nsmooth=4,
                                smoother="auto")
    assert [b.shape for b in tspec.boxes][-1] == (15, 15, 15)
    coefs = {"b": (None,) * tspec.ndepths}
    assert not tct.tower_supported(tspec, coefs, 0)  # 240^3 exceeds the L2
    assert tct.tower_supported(tspec, coefs, 1)
    assert not tmg._use_direct_bottom(tspec)
    assert tmg.plan_for(tspec, (15, 15, 15), torch.float32, "cuda",
                        2) == [("resident", 2)]
    assert tmg.plan_for(tspec, (15, 15, 15), torch.float32, "cuda",
                        4) == [("resident", 4)]
    # the multisweep rung refuses the odd level (the JAX rungs do too)
    assert not tfs.multisweep_supported((15, 15, 15), 2, ALL_P)
    assert tfs.face_cells((15, 15, 15), ALL_P) == 6 * 225
    assert tfs.face_cells((16, 16, 16), ALL_P) == 0
    assert tfs.face_cells((9, 6, 10), SHAPES[0][2]) == 2 * 60
    # f32: one slab block, the z wrap cells in its shared memory; f64: the
    # grid form with the faces' scratch
    g = tfs.gsrb_geometry((15, 15, 15), 4, False, ALL_P, 132)
    assert g.form == "slab" and g.blocks == 1 and g.faces == 0
    assert g.smem == tfs.tile_smem(15, 15, 15, 4) + 2 * 225 * 4
    g = tfs.gsrb_geometry((15, 15, 15), 8, False, ALL_P, 132)
    assert g.form == "grid" and g.faces == 1350
    assert tfs.gsrb_geometry((16, 16, 16), 8, False, ALL_P, 132).faces == 0
    # the tower's tail holds the bottom's faces beside its arrays
    shapes = [b.shape for b in tspec.boxes[1:]]
    faces = tfs.face_cells(shapes[-1], ALL_P)
    blocks, tail, smem = tct.tower_geometry(shapes, 4, 132, faces)
    assert tail == len(shapes) - 1
    assert smem == (3 * 15 ** 3 + faces) * 4 <= tct.TOWER_SMEM[4]
    assert tct.tower_geometry(shapes, 4, 132)[2] == 3 * 15 ** 3 * 4


# (d) chip_smoke.py holds the box's kernels at the shapes its runs give them

# the shapes the card's runs of the 240^3 box gave each level kernel
# (chip_smoke.py's periodic_odd phase, calls_by_shape): unsharded, and on 4
# x-slabs, where 240^3 to 60^3 are cut and 30^3 and 15^3 are not
ODD_ROUTE = {
    "periodic_odd": {"gsrb_relax": {"15x15x15": 1},
                     "multisweep_relax": {"240x240x240": 1},
                     "residual": {"240x240x240": 1, "15x15x15": 1},
                     "residual_restrict": {"240x240x240": 1}},
    "periodic_odd_x": {"gsrb_relax": {"30x30x30": 1, "15x15x15": 1},
                       "residual": {"15x15x15": 1},
                       "residual_restrict": {"30x30x30": 1}},
}


def test_chip_smoke_holds_the_box_at_its_own_shapes():
    """Every case the kernels line reads for the box's two runs exists in
    the kernels phase's lists, at every axis periodic; held_at finds a case
    of each shape the route gives a level kernel, and fails on a shape that
    no case holds."""
    import chip_smoke as cs

    lists = {"gsrb_relax": cs.LEVEL_CASES, "residual": cs.LEVEL_CASES,
             "residual_restrict": cs.LEVEL_CASES,
             "multisweep_relax": cs.MULTI_CASES,
             "tower_down": cs.TOWER_CASES, "tower_up": cs.TOWER_CASES,
             "multisweep_relax_halo": cs.SHARD_CASES}
    for path in ODD_ROUTE:
        for name, cid in cs.PATH_CASES[path].items():
            case = next(c for c in lists[name] if c[0] == cid)
            assert case[2] == ALL_P
        held = cs.held_at(ODD_ROUTE[path], path)
        assert {n: set(v) for n, v in held.items()} == {
            n: set(v) for n, v in ODD_ROUTE[path].items()}
    assert cs.held_at(ODD_ROUTE["periodic_odd"], "periodic_odd")[
        "multisweep_relax"] == {"240x240x240": "odd_path_240_P"}
    with pytest.raises(cs.SmokeFailure):
        cs.held_at({"gsrb_relax": {"17x17x17": 1}}, "periodic_odd")
    with pytest.raises(cs.SmokeFailure):  # the line reads 240^3 there
        cs.held_at({"residual_restrict": {"30x30x30": 1}}, "periodic_odd")
