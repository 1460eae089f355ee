"""The port's command-line program against the JAX package's, on the tiny
parameter file of tests/test_cli.py: same argv contract, same files, same
exit codes, and the same Picard history (first two entries to 1e-8
relative, all f64 on the CPU). The port's `run` takes `device`: None means
the CUDA device, and without one it returns 2 — it never carries on on the
CPU by itself."""

import re

import numpy as np
import pytest
import torch

from mg_ic_code_tpu import main as jcli

from mg_ic_code_tpu_torch import main as tcli
from mg_ic_code_tpu_torch.io import chombo_hdf5 as tio
from tests.test_cli import TINY_BBH

pytest.importorskip("h5py")
torch.set_num_threads(1)


@pytest.fixture()
def tiny_params(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the run writes HDF5 into CWD
    p = tmp_path / "params.txt"
    p.write_text(TINY_BBH)
    return str(p)


def norms(captured: str):
    return [float(m) for m in re.findall(
        r"norm of dpsi after step \d+ is ([0-9.eE+-]+)", captured)]


def test_cli_end_to_end(tiny_params, tmp_path):
    rc = tcli.run(["main", tiny_params], device="cpu")
    assert rc == 0

    # one plotfile per NL iteration (output_solver_data role)
    plots = sorted(tmp_path.glob("vcPoissonOut.3d_*.hdf5"))
    assert [p.name for p in plots] == [
        "vcPoissonOut.3d_0.hdf5", "vcPoissonOut.3d_1.hdf5",
    ]
    box, dom, dx, named = tio.read_level_data(str(plots[0]), 0)
    assert box.shape == (16, 16, 16)
    assert set(named) >= {"dpsi", "rhs", "psi"}
    # iteration-0 snapshot is taken before the first linear solve: dpsi = 0
    assert float(np.abs(named["dpsi"]).max()) == 0.0
    assert float(np.abs(named["rhs"]).max()) > 0.0
    _, _, _, named1 = tio.read_level_data(str(plots[1]), 1)
    assert float(np.abs(named1["dpsi"]).max()) > 0.0

    # final GRChombo checkpoint with the 29-var state
    final = tmp_path / "vcPoissonFinal.3d.hdf5"
    assert final.exists()
    fbox, _, _, fnamed = tio.read_level_data(str(final), 0)
    assert fbox.shape == (16, 16, 16)
    chi = fnamed["chi"]
    assert chi.min() > 0.0  # chi = psi^-4 must stay positive
    assert set(fnamed) >= {"chi", "K", "lapse", "A11", "phi"}


def test_cli_override_and_nonconvergence_exit_2(tiny_params, capsys):
    # a single Picard iteration on a strong-field configuration leaves
    # ||dpsi|| > 0.1 -> the reference MayDays (exit 2)
    rc = tcli.run([
        "main", tiny_params,
        "max_NL_iterations = 1",
        "phi_amplitude = 1.0",
    ], device="cpu")
    assert rc == 2
    assert "did not converge" in capsys.readouterr().err


def test_cli_usage_no_args(capsys):
    rc = tcli.run(["main"])
    assert rc == 0
    assert "usage" in capsys.readouterr().err


def test_cli_history_and_files_match_jax(tiny_params, tmp_path, capsys):
    """Both command lines on the same params file: the printed Picard history
    (first two entries, 1e-8 relative) and the checkpoint's chi (1e-8
    relative: the states differ by the second correction's roundoff)."""
    argv = ["main", tiny_params, "verbosity = 3"]
    assert jcli.run(argv) == 0
    jh = norms(capsys.readouterr().out)
    jfinal = {d: tio.read_level_data("vcPoissonFinal.3d.hdf5", d)
              for d in (0, 1)}
    assert tcli.run(argv, device="cpu") == 0
    th = norms(capsys.readouterr().out)
    assert len(jh) == len(th) == 2
    for t, j in zip(th, jh):
        assert t == pytest.approx(j, rel=1e-8)
    for d in (0, 1):
        tb, _, tdx, tn = tio.read_level_data("vcPoissonFinal.3d.hdf5", d)
        jb, _, jdx, jn = jfinal[d]
        assert (tb.lo, tb.hi) == (jb.lo, jb.hi) and tdx == jdx
        np.testing.assert_allclose(tn["chi"], jn["chi"], rtol=1e-8, atol=0)
        np.testing.assert_allclose(tn["A12"], jn["A12"], rtol=1e-8,
                                   atol=1e-14)


def test_cli_restart_warm_start(tiny_params, tmp_path, capsys):
    """read_from_checkpoint: a cold solve writes vcPoissonFinal, and a warm
    re-solve seeded from it starts essentially converged."""
    rc = tcli.run(["main", tiny_params, "max_NL_iterations = 4",
                   "verbosity = 3"], device="cpu")
    assert rc == 0
    cold = norms(capsys.readouterr().out)
    assert len(cold) >= 2 and cold[0] > 1e-3

    rc = tcli.run(["main", tiny_params, "max_NL_iterations = 4",
                   "verbosity = 3",
                   "read_from_checkpoint = vcPoissonFinal.3d.hdf5"],
                  device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    warm = norms(out)
    assert "warm start from vcPoissonFinal.3d.hdf5 (2 levels)" in out
    assert warm[0] < 1e-3 * cold[0]
    assert len(warm) <= len(cold)


def test_cli_without_a_card_returns_2(tiny_params, tmp_path, capsys):
    """device=None means the CUDA device: without one the run names it,
    returns 2 and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    assert tcli.run(["main", tiny_params]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.hdf5"))


def test_cli_without_h5py_returns_2_before_the_solve(
        tiny_params, tmp_path, capsys, monkeypatch):
    """The files need h5py: where it is missing the run says so (the JAX
    package's message) and returns 2 before any solve."""
    monkeypatch.setattr(tio, "HAVE_H5PY", False)
    called = []
    from mg_ic_code_tpu_torch.solver import nonlinear as tnl
    monkeypatch.setattr(tnl, "poisson_solve",
                        lambda *a, **k: called.append(1))
    assert tcli.run(["main", tiny_params], device="cpu") == 2
    assert "h5py is required" in capsys.readouterr().err
    assert not called and not list(tmp_path.glob("*.hdf5"))
