"""The port's coarse-depth tower against the JAX package's.

JAX side: `mg_vcycle` with smoother="pallas", which off-TPU runs the fused
tower kernels in interpret mode (as tests/test_coarse_tower.py does). Port
side: the tower's plain PyTorch versions (what the wrappers run for CPU
tensors). Both sides get the same numpy a/rhs/u0 and the SAME coefficient
chain (the JAX one, carried across with convert.coefs_from_numpy), so the
comparison isolates the tower.

Tolerance 5e-5 absolute on O(1) data in f32 — the tolerance the JAX package
holds its own tower to against its staged V-cycle; the two towers pair the
restriction in the same order and differ by fusion-level rounding through
~40 colour passes and a dense bottom solve."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.geometry import BCSpec as JBC, single_level_geom as jgeom1
from mg_ic_code_tpu.ops import coarse_tower as jct
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC, single_level_geom as tgeom1
from mg_ic_code_tpu_torch.ops import coarse_tower as tct
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

BCS = {
    "dirichlet": dict(),
    "periodic": dict(periodic=True),
    "mixed": dict(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0)),
}
ATOL = 5e-5


def setup(bc, n=32, bottom="auto", seed=7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, (n, n, n)).astype(np.float32)
    rhs = rng.standard_normal((n, n, n)).astype(np.float32)
    u0 = rng.standard_normal((n, n, n)).astype(np.float32)
    jspec = jmg.make_level_spec(
        jgeom1(n, 1.0, JBC(**BCS[bc])), 0, alpha=1.0, beta=-1.0, nsmooth=4,
        smoother="pallas", bottom=bottom)
    tspec = tmg.make_level_spec(
        tgeom1(n, 1.0, TBC(**BCS[bc])), 0, alpha=1.0, beta=-1.0, nsmooth=4,
        smoother="pallas", bottom=bottom)
    jco = jmg.build_level_coefs(jspec, jnp.asarray(a))
    plain = {k: [None if x is None else np.asarray(x) for x in jco[k]]
             for k in ("a", "b", "lam")}
    if jco.get("binv") is not None:
        plain["binv"] = np.asarray(jco["binv"])
    (tco,) = cv.coefs_from_numpy((plain,), "cpu")
    return jspec, tspec, jco, tco, a, rhs, u0


@pytest.mark.parametrize("bc,bottom,n", [
    ("dirichlet", "auto", 32), ("periodic", "auto", 16),
    ("mixed", "auto", 16), ("dirichlet", "bicgstab", 16),
])
def test_tower_vcycle_matches_jax(bc, bottom, n):
    jspec, tspec, jco, tco, a, rhs, u0 = setup(bc, n=n, bottom=bottom)
    assert (jco.get("binv") is None) == (bottom == "bicgstab")
    assert jct.tower_supported(jspec, jco, 0)
    assert tct.tower_supported(tspec, tco, 0)
    ref = jmg.mg_vcycle_jit(jspec, jco, jnp.asarray(u0), jnp.asarray(rhs))
    kernel_counts.reset()
    out = tmg.mg_vcycle(tspec, tco, torch.from_numpy(u0),
                        torch.from_numpy(rhs))
    # the V-cycle went through the tower (plain versions on the CPU)
    assert kernel_counts.PLAIN_CALLS["tower_down"] == 1
    assert kernel_counts.PLAIN_CALLS["tower_up"] == 1
    assert kernel_counts.LAUNCHES == {k: 0 for k in kernel_counts.KERNELS}
    assert kernel_counts.DEVICE_LAUNCHES == kernel_counts.LAUNCHES
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("bc", list(BCS))
def test_tower_down_up_match_jax_kernels(bc):
    """The two halves separately, against the JAX kernel calls."""
    jspec, tspec, jco, tco, a, rhs, u0 = setup(bc, n=16)
    ndep = jspec.ndepths
    ju, jr, jub = jct._tower_down_call(
        jspec, 0, jnp.asarray(u0), jnp.asarray(rhs), list(jco["a"]), True)
    tu, tr, tub = tct.tower_down(
        tspec, 0, torch.from_numpy(u0), torch.from_numpy(rhs),
        list(tco["a"]))
    assert len(tu) == len(tr) == ndep - 1
    # states are O(1); restricted residuals are O(1/dx^2) ~ 1e3, so they
    # are held to 1e-5 of their max instead (f32: a few ulps)
    for t, j in zip(list(tu) + list(tr) + [tub], list(ju) + list(jr) + [jub]):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.numpy(), j, rtol=0,
            atol=max(ATOL, 1e-5 * float(np.max(np.abs(j)))))
    # up pass from the SAME inputs (the JAX down outputs) on both sides
    e_bot = np.asarray(jub) * 0.5
    rhs_list = [rhs] + [np.asarray(x) for x in jr]
    jout = jct._tower_up_call(
        jspec, 0, jnp.asarray(e_bot), list(ju),
        [jnp.asarray(x) for x in rhs_list[:-1]], list(jco["a"][:-1]), True)
    tout = tct.tower_up(
        tspec, 0, torch.from_numpy(e_bot),
        [cv.tensor_from_numpy(np.asarray(x), "cpu") for x in ju],
        cv.level_list_from_numpy(rhs_list[:-1], "cpu"),
        list(tco["a"][:-1]))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)


def test_tower_matches_port_staged_vcycle(monkeypatch):
    """Inside the port: tower V-cycle == staged per-depth V-cycle."""
    _, tspec, _, tco, a, rhs, u0 = setup("mixed", n=16)
    u0t, rhst = torch.from_numpy(u0), torch.from_numpy(rhs)
    out_tower = tmg.mg_vcycle(tspec, tco, u0t, rhst)
    monkeypatch.setattr(tct, "tower_supported", lambda *a_: False)
    out_staged = tmg.mg_vcycle(tspec, tco, u0t, rhst)
    np.testing.assert_allclose(out_tower.numpy(), out_staged.numpy(),
                               rtol=0, atol=ATOL)


def test_tower_supported_predicate():
    jspec, tspec, jco, tco, a, *_ = setup("dirichlet", n=16)
    assert tct.tower_supported(tspec, tco, 0)
    var_b = {"a": tco["a"], "b": (tco["a"][0],) + tco["b"][1:],
             "lam": tco["lam"]}
    assert not tct.tower_supported(tspec, var_b, 0)  # variable bCoef
    spec_w = tmg.make_level_spec(
        tgeom1(16, 1.0, TBC()), 0, alpha=1.0, beta=-1.0, nsmooth=4,
        smoother="pallas", num_mg=2)
    assert not tct.tower_supported(spec_w, tco, 0)  # W-cycle
    assert not tct.tower_supported(tspec, tco, tspec.ndepths - 2)
    # the size term: the tower starts at the first depth whose four arrays
    # fit the card's 50 MB L2 (512^3 and 256^3 in f32 do not, 128^3 does)
    big = tmg.make_level_spec(
        tgeom1(512, 1.0, TBC()), 0, alpha=1.0, beta=-1.0, nsmooth=4)
    const_b = {"b": (None,) * big.ndepths}
    assert [tct.tower_supported(big, const_b, d) for d in range(4)] == [
        False, False, True, True]
    assert [tct.tower_supported(big, const_b, d, itemsize=8)
            for d in range(4)] == [False, False, False, True]


def test_restrict_pairs_is_full_weighting():
    from mg_ic_code_tpu_torch.ops import stencils as tst

    f = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 6, 4)))
    np.testing.assert_allclose(tct._restrict_pairs(f).numpy(),
                               tst.restrict_full(f).numpy(), rtol=0,
                               atol=1e-15)
