"""The port's restart loader against the JAX package's, on a checkpoint the
JAX package wrote: same hierarchy, psi to 1e-12, and a warm-started solve of
the port that starts converged."""

import numpy as np
import pytest
import torch

from mg_ic_code_tpu.io import chombo_hdf5 as jio
from mg_ic_code_tpu.io import restart as jrestart

from mg_ic_code_tpu_torch.io import chombo_hdf5 as tio
from mg_ic_code_tpu_torch.io import restart as trestart
from mg_ic_code_tpu_torch.solver import nonlinear as tnl
from tests.test_torch_io import jax_solve_state

pytest.importorskip("h5py")
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[1, 2], ids=["2_levels", "3_levels"])
def checkpoint(request, tmp_path_factory):
    jcfg, tcfg, res, _, _ = jax_solve_state(request.param)
    path = str(tmp_path_factory.mktemp("ckpt") / "vcPoissonFinal.3d.hdf5")
    jio.write_final_data(path, res.geom, jcfg, res.psi, res.fields,
                         res.constant_K)
    return path, jcfg, tcfg, res


def test_load_geometry_matches(checkpoint):
    path, jcfg, tcfg, res = checkpoint
    jg = jrestart.load_geometry(path, jcfg)
    tg = trestart.load_geometry(path, tcfg)
    assert [(b.lo, b.hi) for b in tg.boxes] == [
        (b.lo, b.hi) for b in jg.boxes]
    assert tg.parent == jg.parent and tg.dx == jg.dx
    assert tg.num_levels == res.geom.num_levels


def test_load_state_matches(checkpoint):
    path, jcfg, tcfg, res = checkpoint
    jg, jpsi, jk = jrestart.load_state(path, jcfg)
    tg, tpsi, tk = trestart.load_state(path, tcfg, device="cpu")
    assert tk == jk == res.constant_K
    assert [(b.lo, b.hi) for b in tg.boxes] == [
        (b.lo, b.hi) for b in jg.boxes]
    for t, j, orig in zip(tpsi, jpsi, res.psi):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        assert bool(torch.isfinite(t).all())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=0)
        # and the inversion of the output transform gives back the state
        np.testing.assert_allclose(t.numpy(), np.asarray(orig), rtol=1e-9,
                                   atol=1e-11)
    t32 = trestart.load_state(path, tcfg, dtype=torch.float32,
                              device="cpu")[1]
    assert all(p.dtype == torch.float32 for p in t32)


def test_warm_start_from_jax_checkpoint(checkpoint):
    path, _, tcfg, res = checkpoint
    tg, tpsi, _ = trestart.load_state(path, tcfg, device="cpu")
    warm = tnl.poisson_solve(tcfg, geom=tg, device="cpu", verbose=False,
                             initial_psi=tpsi)
    # two Picard steps were already taken: the next correction is the third
    assert warm.dpsi_norm_history[0] < 1e-3 * res.dpsi_norm_history[0]


def test_port_checkpoint_read_by_jax(checkpoint, tmp_path):
    """The other direction: the port writes, the JAX package restarts."""
    path, jcfg, tcfg, res = checkpoint
    tg, tpsi, tk = trestart.load_state(path, tcfg, device="cpu")
    tres = tnl.poisson_solve(tcfg, geom=tg, device="cpu", verbose=False,
                             initial_psi=tpsi)
    out = str(tmp_path / "port.hdf5")
    tio.write_final_data(out, tg, tcfg, tres.psi, tres.fields,
                         tres.constant_K)
    jg, jpsi, _ = jrestart.load_state(out, jcfg)
    assert [(b.lo, b.hi) for b in jg.boxes] == [
        (b.lo, b.hi) for b in tg.boxes]
    for j, t in zip(jpsi, tres.psi):
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-9,
                                   atol=1e-11)

