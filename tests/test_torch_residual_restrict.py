"""The residual restricted by full weighting (fused_sweeps.residual_restrict,
csrc/residual.cu's second form) against the JAX package, and the two
places of the port's V-cycles that now call it.

JAX side: `stencils.restrict_full` of `fused_sweeps.resident_residual`
with interpret=True (how the JAX package's own tests run its Pallas
kernels on the CPU) and `stencils.restrict_residual` of the ghost-filled
level (the staged form the JAX package's mg_vcycle restricts with). Port
side: CPU tensors, so the wrapper takes its plain version
(`residual_restrict_plain`, restrict_full of `residual_plain`); the CUDA
kernel is held against that plain version, bit for bit, on the card
(chip_smoke.py, tests/test_torch_cuda_kernels.py).

Tolerances: relative to max|reference|, f32 2e-5 and f64 1e-12 (the two
sides evaluate the same expression, differing by XLA's fusion and FMA
choices); the preconditioner 2e-5 of max|e| (f32 rounding through ~100
colour passes, as tests/test_torch_composite_mixed.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC
from mg_ic_code_tpu.grid.geometry import single_level_geom as jgeom1
from mg_ic_code_tpu.ops import fused_sweeps as jfs
from mg_ic_code_tpu.ops import stencils as jst
from mg_ic_code_tpu.ops.ghosts import fill_ghosts_homogeneous as jghost
from mg_ic_code_tpu.solver import composite as jcomp

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC
from mg_ic_code_tpu_torch.grid.geometry import single_level_geom as tgeom1
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import composite as tcomp

from test_torch_composite import (  # noqa: F401
    J, T, close_lists, export_coefs, make,
)

torch.set_num_threads(1)

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"

# (id, shape, kinds, rho): every face kind on some axis, a periodic axis,
# all periodic, a coarse rho, non-cubic
CASES = [
    ("dirichlet", (8, 12, 10), ((D, D), (D, D), (D, D)), 2.0),
    ("neumann", (10, 8, 6), ((N, N), (N, N), (N, N)), 2.0),
    ("cf", (12, 10, 8), ((C, C), (C, C), (C, C)), 2.0),
    ("each_face_kind", (8, 12, 10), ((D, N), (C, D), (N, C)), 2.0),
    ("periodic_x", (8, 8, 12), ((P, P), (D, C), (C, N)), 1.0),
    ("all_periodic", (8, 6, 10), ((P, P), (P, P), (P, P)), 2.0),
    ("coarse_rho", (6, 4, 4), ((C, C), (C, D), (D, C)), 0.25),
]
DTYPES = {"f32": (np.float32, 2e-5), "f64": (np.float64, 1e-12)}
KW = dict(alpha=1.0, beta=-1.0, dx=0.25)


def fields(shape, npdt, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.standard_normal(shape).astype(npdt),
        "rhs": rng.standard_normal(shape).astype(npdt),
        "a": rng.uniform(0.5, 2.0, shape).astype(npdt),
        "b": rng.uniform(0.5, 2.0, shape).astype(npdt),
    }


def rel_close(t, j, rtol):
    j = np.asarray(j)
    assert t.dtype == getattr(torch, str(j.dtype))
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=rtol * float(np.max(np.abs(j))))


def port_args(f, with_b):
    return (torch.from_numpy(f["u"]), torch.from_numpy(f["rhs"]),
            torch.from_numpy(f["a"]),
            torch.from_numpy(f["b"]) if with_b else None)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_restricted_resident_residual(case, with_b, dt):
    """restrict_full of the JAX resident residual kernel."""
    _, shape, kinds, rho = case
    npdt, rtol = DTYPES[dt]
    f = fields(shape, npdt, seed=3)
    kw = dict(kinds=kinds, rho=rho, **KW)
    ref = jst.restrict_full(jfs.resident_residual(
        jnp.asarray(f["u"]), jnp.asarray(f["rhs"]), jnp.asarray(f["a"]),
        jnp.asarray(f["b"]) if with_b else None, interpret=True, **kw))
    before = kernel_counts.PLAIN_CALLS["residual_restrict"]
    out = tfs.residual_restrict(*port_args(f, with_b), **kw)
    # a CPU tensor takes the plain version, and counts it as such
    assert kernel_counts.PLAIN_CALLS["residual_restrict"] == before + 1
    assert kernel_counts.LAUNCHES["residual_restrict"] == 0
    assert tuple(out.shape) == tuple(n // 2 for n in shape)
    rel_close(out, ref, rtol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_staged_restrict_residual(case, with_b, dt):
    """The staged form the JAX package's mg_vcycle restricts with:
    restrict_residual of the level with its homogeneous ghosts filled."""
    _, shape, kinds, rho = case
    npdt, rtol = DTYPES[dt]
    f = fields(shape, npdt, seed=4)
    ref = jst.restrict_residual(
        jghost(jnp.asarray(f["u"]), kinds, rho), jnp.asarray(f["rhs"]),
        jnp.asarray(f["a"]), jnp.asarray(f["b"]) if with_b else None,
        KW["alpha"], KW["beta"], KW["dx"])
    out = tfs.residual_restrict(*port_args(f, with_b), kinds=kinds, rho=rho,
                                **KW)
    rel_close(out, ref, rtol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_into_a_strided_slice_of_a_parent(dt):
    """`out` as the covered part of a larger parent: the slice gets the
    restricted residual bit for bit, the rest of the parent is untouched."""
    npdt, _ = DTYPES[dt]
    shape, kinds = (12, 8, 10), ((D, N), (C, D), (N, C))
    f = fields(shape, npdt, seed=5)
    args = port_args(f, True)
    kw = dict(kinds=kinds, rho=2.0, **KW)
    fresh = tfs.residual_restrict(*args, **kw)
    parent = torch.full((9, 7, 8), -7.0, dtype=args[0].dtype)
    sl = (slice(2, 8), slice(1, 5), slice(3, 8))
    view = parent[sl]
    assert not view.is_contiguous()
    got = tfs.residual_restrict(*args, out=view, **kw)
    assert got.data_ptr() == view.data_ptr()
    assert torch.equal(parent[sl], fresh)
    rest = parent.clone()
    rest[sl] = -7.0
    assert bool((rest == -7.0).all())
    # the whole residual, restricted, is the same thing
    assert torch.equal(fresh, tfs.restrict_full(tfs.residual(*args, **kw)))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_an_odd_axis_raises(axis):
    shape = [8, 6, 4]
    shape[axis] += 1
    u = torch.zeros(shape)
    with pytest.raises(ValueError, match="even"):
        tfs.residual_restrict(u, u, u, kinds=((D, D),) * 3, rho=2.0, **KW)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_a_wrong_out_raises(bad):
    u = torch.zeros((8, 6, 4))
    out = (torch.zeros((4, 3, 3)) if bad == "shape"
           else torch.zeros((4, 3, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="out"):
        tfs.residual_restrict(u, u, u, kinds=((D, D),) * 3, rho=2.0,
                              out=out, **KW)


@pytest.fixture(scope="module")
def three_levels():
    # the f32 kernel path: the JAX side's Pallas kernels in interpret mode
    return make(levels=3, smoother="pallas", precond_precision="single")


def test_precond_three_levels_matches_jax(three_levels):
    """One preconditioner application (2 AMR V-cycles) on three levels: the
    downsweep restricts each refined level's residual into its parent with
    residual_restrict, 2 x (refined levels) calls."""
    jspec, tspec, jco, tco, a, rhs, u = three_levels
    ref = jcomp.precond_jit(jspec, jco, J(rhs))
    r_in = T(rhs)
    kernel_counts.reset()
    out = tcomp.precond(tspec, tco, r_in)
    close_lists(out, ref, 2e-5)
    c = kernel_counts.PLAIN_CALLS
    assert c["residual_restrict"] == spec_vcycles(tspec) * (
        tspec.num_levels - 1)
    assert kernel_counts.LAUNCHES == {k: 0 for k in kernel_counts.KERNELS}
    # the caller's residual list is only read
    for x, y in zip(r_in, T(rhs)):
        assert torch.equal(x, y)


def spec_vcycles(spec) -> int:
    return spec.num_mg_iterations


def periodic_box(n):
    base = dict(alpha=1.0, beta=-1.0, L=1.0, n_cells=(n, n, n), max_level=0,
                num_mg_smooth=4, num_mg_iterations=2, max_iterations=30,
                tolerance=1e-10, hang=1e-11,
                coefficient_average_type="arithmetic", smoother="pallas",
                precond_precision="single")
    jg = jgeom1(n, 1.0, JBC(periodic=True))
    tg = tgeom1(n, 1.0, TBC(periodic=True))
    jspec = jcomp.make_amr_spec(jg, JCfg(**base))
    tspec = tcomp.make_amr_spec(tg, TCfg(**base), device="cpu")
    rng = np.random.default_rng(6)
    a = [rng.uniform(0.5, 2.0, (n, n, n))]
    rhs = [rng.standard_normal((n, n, n))]
    jco = jcomp.build_coefs_jit(jspec, [jnp.asarray(x) for x in a])
    tco = cv.coefs_from_numpy(export_coefs(jco), "cpu")
    return jspec, tspec, jco, tco, rhs


def test_precond_periodic_staged_top_depth_matches_jax(monkeypatch):
    """The periodic box with its top depth above the tower (a lowered
    L2_BYTES stands in for the card's 50 MB: 4 x 32^3 x 4 B counts as too
    big, 16^3 fits): mg_vcycle's staged branch restricts that depth's
    residual with residual_restrict, once a V-cycle, in place of
    stencils.restrict_residual of the ghost-filled level."""
    jspec, tspec, jco, tco, rhs = periodic_box(32)
    ref = jcomp.precond_jit(jspec, jco, J(rhs))
    monkeypatch.setattr(tfs, "L2_BYTES", 256 << 10)
    kernel_counts.reset()
    out = tcomp.precond(tspec, tco, T(rhs))
    close_lists(out, ref, 2e-5)
    c = kernel_counts.PLAIN_CALLS
    assert c["residual_restrict"] == spec_vcycles(tspec)
    assert c["tower_down"] == c["tower_up"] == spec_vcycles(tspec)
    assert kernel_counts.LAUNCHES == {k: 0 for k in kernel_counts.KERNELS}


@pytest.mark.parametrize("nz,itemsize,aligned,form", [
    (144, 4, True, (4, True)), (144, 4, False, (2, False)),
    (34, 4, True, (2, False)), (33, 4, True, (1, False)),
    (144, 8, True, (2, True)), (144, 8, False, (2, False)),
    (33, 8, True, (1, False)),
])
def test_residual_form(nz, itemsize, aligned, form):
    """16 bytes a thread where every row starts on 16 bytes, else two cells
    where nz is even (what the restricted form needs), else one."""
    assert tfs.residual_form(nz, itemsize, aligned) == form


def four_blocks(threads, smem):
    """A stand-in for the card's answer (mgk_residual_capacity): blocks a
    multiprocessor runs at once."""
    return 4


GEOMETRY_SHAPES = [(960, 144, 144), (256, 256, 256), (512, 96, 96),
                   (272, 80, 80), (176, 64, 64), (96, 80, 80), (64, 64, 64),
                   (8, 8, 8), (4, 4, 4), (20, 17, 33), (2, 2, 2)]
# the restricted form takes even axes only
GEOMETRY_CASES = [(shape, restrict) for shape in GEOMETRY_SHAPES
                  for restrict in (False, True)
                  if not (restrict and any(n % 2 for n in shape))]


@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
@pytest.mark.parametrize("shape,restrict", GEOMETRY_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}"
                              f"{'_restrict' if c[1] else ''}"
                              for c in GEOMETRY_CASES])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_residual_geometry_covers_the_level(shape, restrict, itemsize,
                                            with_b):
    """Every launch the rule picks covers the level once: whole tiles of
    even height, segments even in the restricted form, within a block's
    threads and shared memory, and a thread's copies of a plane within the
    kernel's (csrc/residual.cu: kMaxChunks = 4 of u's rows, 2 of each
    other array's run)."""
    vz, vec = tfs.residual_form(shape[2], itemsize, True)
    g = tfs.residual_geometry(shape, itemsize, vz, vec, restrict, with_b,
                              132, four_blocks)
    nx, ny, nz = shape
    assert g.ty % 2 == 0 and g.ntiles == -(-ny // g.ty)
    assert (g.ntiles - 1) * g.ty < ny <= g.ntiles * g.ty
    assert (g.nseg - 1) * g.xseg < nx <= g.nseg * g.xseg
    if restrict:
        assert g.xseg % 2 == 0
    pairs_threads = g.ty // 2 * (nz // vz)
    assert pairs_threads <= g.threads <= tfs.RESIDUAL_MAX_THREADS
    assert g.threads % 32 == 0
    assert (g.ty + 2) * (nz // vz) <= 4 * g.threads
    assert g.ty * (nz // vz) <= 2 * g.threads
    arrays = 3 if with_b else 2
    assert g.slot >= (g.ty + 2 + arrays * g.ty) * nz
    assert (g.slot * itemsize) % 16 == 0
    assert g.smem == tfs.RESIDUAL_RING * g.slot * itemsize
    assert g.smem <= tfs.RESIDUAL_SMEM


def test_residual_geometry_forced_and_refused():
    """ty / xseg force a launch (the measurements); a plane too wide for a
    block raises, as does one of 2^31 cells."""
    g = tfs.residual_geometry((96, 80, 80), 4, 4, True, True, False, 132,
                              four_blocks, ty=8, xseg=12)
    assert (g.ty, g.xseg, g.nseg) == (8, 12, 8)
    with pytest.raises(ValueError):
        tfs.residual_geometry((8, 8, 8192), 4, 1, False, False, False, 132,
                              four_blocks)
    with pytest.raises(ValueError):
        tfs.residual_geometry((2, 65536, 32768), 4, 4, True, False, False,
                              132, four_blocks)
