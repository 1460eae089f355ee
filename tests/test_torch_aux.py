"""The port's multigrid.jacobi_sweep and utils/asserts against the JAX
package's (tests/test_aux.py's Jacobi and debug-check cases): the same
numpy inputs, f64, to 1e-12 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.geometry import BCSpec as JBCSpec
from mg_ic_code_tpu.grid.geometry import single_level_geom as j_single
from mg_ic_code_tpu.solver import multigrid as jmg
from mg_ic_code_tpu.utils import asserts as jasserts

from mg_ic_code_tpu_torch.grid.geometry import BCSpec, single_level_geom
from mg_ic_code_tpu_torch.solver import multigrid as tmg
from mg_ic_code_tpu_torch.utils import asserts

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("bc", [dict(), dict(periodic=True)])
def test_jacobi_sweep_matches_jax_and_converges(bc):
    """Each weighted Jacobi sweep (weight 0.5 and 0.8) against the JAX one
    on the same iterate; 50 sweeps contract the residual by 4 as in
    tests/test_aux.py."""
    rng = np.random.default_rng(13)
    n = 8
    js = jmg.make_level_spec(j_single(n, 1.0, JBCSpec(**bc)), 0, alpha=1.0,
                             beta=-1.0, nsmooth=2)
    ts = tmg.make_level_spec(single_level_geom(n, 1.0, BCSpec(**bc)), 0,
                             alpha=1.0, beta=-1.0, nsmooth=2)
    a = rng.uniform(0.5, 2.0, (n, n, n))
    rhs = rng.standard_normal((n, n, n))
    jc = jmg.build_level_coefs(js, jnp.asarray(a))
    tc = tmg.build_level_coefs(ts, _t(a))
    u = torch.zeros(n, n, n, dtype=torch.float64)
    r0 = float(tmg.residual_homog(ts, tc, 0, u, _t(rhs)).abs().max())
    for i in range(50):
        w = 0.8 if i == 0 else 0.5
        ref = jmg.jacobi_sweep(js, jc, 0, jnp.asarray(u.numpy()),
                               jnp.asarray(rhs), weight=w)
        u = tmg.jacobi_sweep(ts, tc, 0, u, _t(rhs), weight=w)
        np.testing.assert_allclose(u.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(ref).max()))
    r = float(tmg.residual_homog(ts, tc, 0, u, _t(rhs)).abs().max())
    assert r < 0.25 * r0, (r, r0)


def test_debug_checks_match_jax():
    """Off by default on both sides (a passthrough); on, a finite array
    passes and a NaN or an Inf raises FloatingPointError as the JAX
    callback does; host_assert raises AssertionError with its message."""
    x = torch.tensor([1.0, 2.0])
    assert not asserts.debug_checks_enabled()
    assert not jasserts.debug_checks_enabled()
    assert asserts.check_finite(x, "x") is x
    assert asserts.check_finite(torch.tensor([np.nan]), "x") is not None
    asserts.enable_debug_checks(True)
    jasserts.enable_debug_checks(True)
    try:
        assert asserts.debug_checks_enabled()
        assert asserts.check_finite(x, "ok") is x
        for bad in ([1.0, np.nan], [np.inf, 0.0]):
            with pytest.raises(FloatingPointError, match="bad"):
                asserts.check_finite(torch.tensor(bad), "bad")
            with pytest.raises(FloatingPointError, match="bad"):
                jasserts.check_finite(jnp.asarray(bad), "bad")
                import jax

                jax.effects_barrier()
    finally:
        asserts.enable_debug_checks(False)
        jasserts.enable_debug_checks(False)
    assert not asserts.debug_checks_enabled()
    asserts.host_assert(True, "fine")
    with pytest.raises(AssertionError, match="box not coarsenable"):
        asserts.host_assert(False, "box not coarsenable")
    with pytest.raises(AssertionError, match="box not coarsenable"):
        jasserts.host_assert(False, "box not coarsenable")
