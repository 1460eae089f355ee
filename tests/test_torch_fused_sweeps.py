"""The port's whole-level GSRB relaxation and residual against the JAX
package's resident kernels.

JAX side: `resident_relax` / `resident_residual` with interpret=True (how
the JAX package's own tests run its Pallas kernels on the CPU). Port side:
the plain PyTorch versions, which are what the wrappers run for CPU tensors
(the CUDA kernels have no interpret mode; they are held against these same
plain versions on the card).

Tolerances: f64 1e-12 and f32 1e-5, relative to max|result| after the
sweeps — both sides evaluate the same folded update in the same order, so
they differ only by XLA's fusion/FMA choices, a few ulps per colour pass."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.geometry import BCSpec as JBC, single_level_geom as jgeom1
from mg_ic_code_tpu.ops import fused_sweeps as jfs
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC, single_level_geom as tgeom1
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

D, C, N, P = "dirichlet", "cf", "neumann", "periodic"

# (id, shape, kinds, lo, rho)
CASES = [
    ("dirichlet_cube", (16, 16, 16), ((D, D), (D, D), (D, D)), (0, 0, 0), 2.0),
    ("odd_lo_noncubic", (12, 10, 8), ((C, C), (C, C), (C, C)), (3, 4, 2), 2.0),
    ("each_face_kind", (8, 12, 10), ((D, N), (C, D), (N, C)), (2, 0, 1), 2.0),
    ("periodic_axis", (8, 8, 12), ((P, P), (D, C), (C, N)), (0, 5, 0), 1.0),
    ("all_periodic", (8, 6, 10), ((P, P), (P, P), (P, P)), (0, 0, 0), 2.0),
    ("coarse_rho", (6, 4, 4), ((C, C), (C, D), (D, C)), (1, 1, 1), 0.25),
]
DTYPES = {"f32": (np.float32, 1e-5), "f64": (np.float64, 1e-12)}


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
    scale = float(np.max(np.abs(j)))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_relax_matches_jax_resident(case, with_b, dt):
    _, shape, kinds, lo, rho = case
    npdt, rtol = DTYPES[dt]
    f = fields(shape, npdt)
    kw = dict(nsweeps=4, kinds=kinds, rho=rho, alpha=1.0, beta=-1.0,
              dx=0.25, lo=lo)
    ref = jfs.resident_relax(
        jnp.asarray(f["u"]), jnp.asarray(f["rhs"]), jnp.asarray(f["a"]),
        jnp.asarray(f["b"]) if with_b else None, interpret=True, **kw)
    before = kernel_counts.PLAIN_CALLS["gsrb_relax"]
    out = tfs.gsrb_relax(
        torch.from_numpy(f["u"]), torch.from_numpy(f["rhs"]),
        torch.from_numpy(f["a"]),
        torch.from_numpy(f["b"]) if with_b else None, **kw)
    # a CPU tensor takes the plain version, and counts it as such
    assert kernel_counts.PLAIN_CALLS["gsrb_relax"] == before + 1
    assert kernel_counts.LAUNCHES["gsrb_relax"] == 0
    rel_close(out, ref, rtol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_residual_matches_jax_resident(case, with_b, dt):
    _, shape, kinds, lo, rho = case
    npdt, rtol = DTYPES[dt]
    f = fields(shape, npdt, seed=1)
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.25)
    ref = jfs.resident_residual(
        jnp.asarray(f["u"]), jnp.asarray(f["rhs"]), jnp.asarray(f["a"]),
        jnp.asarray(f["b"]) if with_b else None, interpret=True, **kw)
    out = tfs.residual(
        torch.from_numpy(f["u"]), torch.from_numpy(f["rhs"]),
        torch.from_numpy(f["a"]),
        torch.from_numpy(f["b"]) if with_b else None, **kw)
    rel_close(out, ref, rtol)


BCS = {
    "dirichlet": dict(),
    "mixed": dict(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0)),
    "periodic": dict(periodic=True),
}


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
def test_kernel_path_matches_staged_body(bc, with_b):
    """`smoother = pallas` (folded kernel form) against `smoother = xla`
    (ghost fill + one colour update per pass) inside the port, and the
    port's staged body against the JAX package's, f64: the folded form is
    an exact algebraic rewrite, so 1e-11 of max|u| covers the
    reassociation."""
    n = 12
    f = fields((n, n, n), np.float32, seed=2)
    specs = {}
    for sm in ("pallas", "xla"):
        tg = tgeom1(n, 1.0, TBC(**BCS[bc]))
        specs[sm] = tmg.make_level_spec(tg, 0, 1.0, -1.0, 4, smoother=sm)
    a, b = torch.from_numpy(f["a"]), torch.from_numpy(f["b"])
    u, rhs = torch.from_numpy(f["u"]), torch.from_numpy(f["rhs"])
    outs = {}
    for sm, spec in specs.items():
        coefs = tmg.build_level_coefs(spec, a, b if with_b else None)
        assert tmg.relax_kernel_plan(spec, u, 3) == [
            ("resident" if sm == "pallas" else "xla", 3)]
        outs[sm] = (tmg.relax(spec, coefs, 0, u, rhs, 3),
                    tmg.residual_homog(spec, coefs, 0, u, rhs))
    for k in (0, 1):
        scale = float(outs["xla"][k].abs().max())
        np.testing.assert_allclose(
            outs["pallas"][k].numpy(), outs["xla"][k].numpy(), rtol=0,
            atol=2e-5 * scale)  # f32: ~1e-6 per pass over 6 passes

    # staged body, f64, against the JAX package's staged body
    jg = jgeom1(n, 1.0, JBC(**BCS[bc]))
    jspec = jmg.make_level_spec(jg, 0, 1.0, -1.0, 4, smoother="xla")
    f64 = {k: v.astype(np.float64) for k, v in f.items()}
    jco = jmg.build_level_coefs(
        jspec, jnp.asarray(f64["a"]),
        jnp.asarray(f64["b"]) if with_b else None)
    tco = tmg.build_level_coefs(
        specs["xla"], torch.from_numpy(f64["a"]),
        torch.from_numpy(f64["b"]) if with_b else None)
    assert tmg.relax_kernel_plan(
        specs["pallas"], torch.from_numpy(f64["u"]), 2) == [("xla", 2)]
    ref = jmg.relax(jspec, jco, 0, jnp.asarray(f64["u"]),
                    jnp.asarray(f64["rhs"]), 2)
    out = tmg.relax(specs["xla"], tco, 0, torch.from_numpy(f64["u"]),
                    torch.from_numpy(f64["rhs"]), 2)
    rel_close(out, ref, 1e-12)


def test_plan_is_empty_for_zero_sweeps():
    tg = tgeom1(8, 1.0, TBC())
    spec = tmg.make_level_spec(tg, 0, 1.0, -1.0, 4, smoother="pallas")
    u = torch.zeros((8, 8, 8), dtype=torch.float32)
    assert tmg.relax_kernel_plan(spec, u, 0) == []
    coefs = tmg.build_level_coefs(spec, torch.ones_like(u))
    assert tmg.relax(spec, coefs, 0, u, u, 0) is u


def test_wrappers_reject_bad_cuda_arguments():
    """The argument checks in front of the kernels (device, dtype, shape,
    contiguity) raise instead of launching."""
    u = torch.zeros((4, 4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfs.check_level_args("gsrb_relax", u)
