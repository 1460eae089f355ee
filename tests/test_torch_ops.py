"""ops/ of the PyTorch port against the JAX package: ghosts, bc, cf_interp,
stencils. Same numpy inputs to both sides, f64; tolerance 1e-13 absolute on
O(1) data — the two sides evaluate the same expressions and differ only by
FMA contraction / summation order inside XLA's fused loops."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec, HierarchyGeom
from mg_ic_code_tpu.ops import bc as jbc
from mg_ic_code_tpu.ops import cf_interp as jcf
from mg_ic_code_tpu.ops import ghosts as jgh
from mg_ic_code_tpu.ops import stencils as jst

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.ops import bc as tbc
from mg_ic_code_tpu_torch.ops import cf_interp as tcf
from mg_ic_code_tpu_torch.ops import ghosts as tgh
from mg_ic_code_tpu_torch.ops import stencils as tst

torch.set_num_threads(1)

TOL = 1e-13


def port_geom(g):
    plain = lambda bs: [(b.lo, b.hi) for b in bs]
    return cv.geom_from_plain(
        plain(g.boxes), g.parent, g.dx,
        dict(bc_lo=g.bc.bc_lo, bc_hi=g.bc.bc_hi, bc_value=g.bc.bc_value,
             periodic=g.bc.periodic),
        plain(g.domain_boxes), g.domain_length, g.ref_ratio,
    )


def tt(a):
    return cv.tensor_from_numpy(np.asarray(a), "cpu")


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)


def two_level(bc):
    """16^3 base with a refined 16x12x8 patch: CF faces, one face flush
    with the domain (physical), odd-ish offsets."""
    dom0 = Box.from_shape((16, 16, 16))
    fine = Box((0, 4, 6), (7, 9, 9)).refine(2)
    return HierarchyGeom(
        boxes=(dom0, fine), domain_boxes=(dom0, dom0.refine(2)),
        dx=(1.0, 0.5), domain_length=(16.0, 16.0, 16.0), bc=bc,
        parent=(-1, 0),
    )


BCS = {
    "dirichlet": BCSpec(bc_value=0.3),
    "mixed": BCSpec(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0), bc_value=-0.2),
    "periodic": BCSpec(periodic=True),
}

KINDS = {
    "phys": (("dirichlet", "dirichlet"), ("neumann", "dirichlet"),
             ("dirichlet", "neumann")),
    "periodic": (("periodic", "periodic"),) * 3,
    "cf": (("cf", "cf"), ("cf", "dirichlet"), ("dirichlet", "cf")),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {
        "coarse": rng.standard_normal((16, 16, 16)),
        "fine": rng.standard_normal((16, 12, 8)),
        "bfine": rng.uniform(0.5, 2.0, (16, 12, 8)),
        "u": rng.standard_normal((10, 6, 8)),
        "rhs": rng.standard_normal((10, 6, 8)),
        "a": rng.uniform(0.5, 2.0, (10, 6, 8)),
        "b": rng.uniform(0.5, 2.0, (10, 6, 8)),
        "ugh": rng.standard_normal((12, 8, 10)),
    }


@pytest.mark.parametrize("kinds", list(KINDS))
@pytest.mark.parametrize("rho", [2.0, 0.5])
def test_fill_ghosts_homogeneous(data, kinds, rho):
    k = KINDS[kinds]
    close(tgh.fill_ghosts_homogeneous(tt(data["u"]), k, rho),
          jgh.fill_ghosts_homogeneous(jnp.asarray(data["u"]), k, rho))


def test_fill_ghosts_homogeneous_batched(data):
    """Leading batch axes pass through (the dense bottom-operator build)."""
    k = KINDS["cf"]
    u = np.stack([data["u"], 2.0 * data["u"]])
    out = tgh.fill_ghosts_homogeneous(tt(u), k, 1.0)
    for i in range(2):
        close(out[i], jgh.fill_ghosts_homogeneous(jnp.asarray(u[i]), k, 1.0))


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("level,with_coarse,homog", [
    (0, False, False), (1, True, False), (1, True, True), (1, False, True),
])
def test_fill_ghosts(data, bc, level, with_coarse, homog):
    g = two_level(BCS[bc])
    tg = port_geom(g)
    u = data["coarse"] if level == 0 else data["fine"]
    cu = data["coarse"] if with_coarse else None
    ref = jgh.fill_ghosts(
        jnp.asarray(u), g, level, None if cu is None else jnp.asarray(cu),
        homogeneous_phys=homog, dirichlet_shift=1.0,
    )
    out = tgh.fill_ghosts(
        tt(u), tg, level, None if cu is None else tt(cu),
        homogeneous_phys=homog, dirichlet_shift=1.0,
    )
    close(out, ref)


@pytest.mark.parametrize("bc", list(BCS))
def test_face_kinds_and_cf_faces(bc):
    g = two_level(BCS[bc])
    tg = port_geom(g)
    for l in (0, 1):
        assert tgh.face_kinds(tg, l) == jgh.face_kinds(g, l)
        assert tcf.cf_faces(tg, l) == jcf.cf_faces(g, l)


@pytest.mark.parametrize("bc", ["dirichlet", "mixed"])
@pytest.mark.parametrize("homog", [True, False])
def test_fill_physical_ghosts(data, bc, homog):
    g = two_level(BCS[bc])
    tg = port_geom(g)
    for level, u in ((0, data["coarse"]), (1, data["fine"])):
        ref = jbc.fill_physical_ghosts(
            jbc.pad1(jnp.asarray(u)), g, level, homog, dirichlet_shift=1.0)
        out = tbc.fill_physical_ghosts(
            tbc.pad1(tt(u)), tg, level, homog, dirichlet_shift=1.0)
        close(out, ref)


def test_fill_physical_ghosts_periodic(data):
    g = two_level(BCS["periodic"])
    ref = jbc.fill_physical_ghosts(
        jbc.pad1(jnp.asarray(data["coarse"])), g, 0, True)
    out = tbc.fill_physical_ghosts(
        tbc.pad1(tt(data["coarse"])), port_geom(g), 0, True)
    close(out, ref)


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("with_b", [False, True])
def test_add_cf_coarse_term(data, bc, with_b):
    g = two_level(BCS[bc])
    b = data["bfine"] if with_b else None
    ref = jcf.add_cf_coarse_term(
        jnp.asarray(data["fine"]), g, 1, jnp.asarray(data["coarse"]), -4.0,
        None if b is None else jnp.asarray(b))
    arr = tt(data["fine"])
    out = tcf.add_cf_coarse_term(
        arr, port_geom(g), 1, tt(data["coarse"]), -4.0,
        None if b is None else tt(b))
    close(out, ref)
    close(arr, data["fine"], 0.0)  # the input is not modified


@pytest.mark.parametrize("with_coarse", [True, False])
def test_fill_cf_ghosts(data, with_coarse):
    g = two_level(BCS["dirichlet"])
    ugh = np.pad(data["fine"], 1)
    cu = data["coarse"] if with_coarse else None
    ref = jcf.fill_cf_ghosts(
        jnp.asarray(ugh), g, 1, None if cu is None else jnp.asarray(cu))
    out = tcf.fill_cf_ghosts(
        tt(ugh), port_geom(g), 1, None if cu is None else tt(cu))
    close(out, ref)


@pytest.mark.parametrize("order", [1, 2])
def test_upsample2(data, order):
    c = data["coarse"][0]
    for axis in (0, 1):
        close(tcf._upsample2(tt(c), axis, order),
              jcf._upsample2(jnp.asarray(c), axis, order))


@pytest.mark.parametrize("with_b", [False, True])
def test_apply_residual_laplacian(data, with_b):
    b = data["b"] if with_b else None
    args = (1.0, -1.0, 0.25)
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else tt(b)
    close(tst.laplacian(tt(data["ugh"]), 0.25),
          jst.laplacian(jnp.asarray(data["ugh"]), 0.25), 1e-12)
    close(tst.apply_op(tt(data["ugh"]), tt(data["a"]), tb, *args),
          jst.apply_op(jnp.asarray(data["ugh"]), jnp.asarray(data["a"]), jb,
                       *args), 1e-12)
    close(tst.residual(tt(data["ugh"]), tt(data["rhs"]), tt(data["a"]), tb,
                       *args),
          jst.residual(jnp.asarray(data["ugh"]), jnp.asarray(data["rhs"]),
                       jnp.asarray(data["a"]), jb, *args), 1e-12)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("lo", [(0, 0, 0), (3, 2, 2)])
def test_gsrb_color_and_lambda(data, color, lo):
    lam_j = jst.gsrb_lambda(jnp.asarray(data["a"]), 1.0, -1.0, 0.25)
    lam_t = tst.gsrb_lambda(tt(data["a"]), 1.0, -1.0, 0.25)
    close(lam_t, lam_j)
    ref = jst.gsrb_color(
        jnp.asarray(data["ugh"]), jnp.asarray(data["rhs"]),
        jnp.asarray(data["a"]), None, lam_j, 1.0, -1.0, 0.25, lo, color)
    out = tst.gsrb_color(
        tt(data["ugh"]), tt(data["rhs"]), tt(data["a"]), None, lam_t, 1.0,
        -1.0, 0.25, lo, color)
    close(out, ref)
    np.testing.assert_array_equal(
        tst.color_mask((10, 6, 8), lo, color).numpy(),
        np.asarray(jst.color_mask((10, 6, 8), lo, color)))


def test_transfer_operators(data):
    f = data["u"]
    close(tst.restrict_full(tt(f)), jst.restrict_full(jnp.asarray(f)))
    close(tst.prolong_inc(tt(data["ugh"]), tt(f[:6, :4, :5])),
          jst.prolong_inc(jnp.asarray(data["ugh"]),
                          jnp.asarray(f[:6, :4, :5])))
    close(tst.restrict_residual(tt(data["ugh"]), tt(data["rhs"]),
                                tt(data["a"]), None, 1.0, -1.0, 0.25),
          jst.restrict_residual(jnp.asarray(data["ugh"]),
                                jnp.asarray(data["rhs"]),
                                jnp.asarray(data["a"]), None, 1.0, -1.0,
                                0.25), 1e-12)
    close(tst.grad_energy(tt(data["ugh"]), 0.25),
          jst.grad_energy(jnp.asarray(data["ugh"]), 0.25), 1e-12)


@pytest.mark.parametrize("avg", ["arithmetic", "harmonic"])
def test_coarsen_coef(data, avg):
    close(tst.coarsen_coef(tt(data["a"]), avg),
          jst.coarsen_coef(jnp.asarray(data["a"]), avg))
    with pytest.raises(ValueError):
        tst.coarsen_coef(tt(data["a"]), "bogus")
