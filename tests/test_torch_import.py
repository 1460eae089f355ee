"""The PyTorch port stands alone: importing it and running a solve pulls in
neither JAX nor the JAX package, and its entry points refuse to run without
a CUDA device unless the CPU is asked for."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SOLVE = r"""
import sys
import torch
torch.set_num_threads(1)
import mg_ic_code_tpu_torch as mgt
from mg_ic_code_tpu_torch.solver.nonlinear import poisson_solve
cfg = mgt.SolverConfig(
    alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16), max_level=1,
    refine_threshold=0.5, block_factor=4, num_mg_smooth=4,
    num_mg_iterations=2, max_iterations=50, max_nl_iterations=2,
    tolerance=1e-10, coefficient_average_type="harmonic",
    bh1_bare_mass=0.2, bh2_bare_mass=0.2, bh1_offset=2.0, bh2_offset=-2.0,
    bh1_momentum=0.02, bh2_momentum=-0.02, bh1_spin=0.02, bh2_spin=0.02,
    phi_amplitude=0.05, verbosity=0, precond_precision="single",
    smoother="pallas",
)
res = poisson_solve(cfg, device="cpu", verbose=False)
assert res.geom.num_levels == 2
assert res.dpsi_norm_history[1] < 0.1 * res.dpsi_norm_history[0]
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "mg_ic_code_tpu" or m.startswith("mg_ic_code_tpu.")]
assert not bad, bad
print("PORT_STANDS_ALONE")
"""


def test_port_solve_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _SOLVE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "PORT_STANDS_ALONE" in r.stdout


def test_device_none_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    import mg_ic_code_tpu_torch as mgt
    from mg_ic_code_tpu_torch.grid.geometry import single_level_geom
    from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu_torch.physics import level_data as ld
    from mg_ic_code_tpu_torch.solver import composite as comp
    from mg_ic_code_tpu_torch.solver.nonlinear import poisson_solve

    cfg = mgt.SolverConfig(n_cells=(8, 8, 8), L=8.0, max_level=0)
    geom = single_level_geom(8, 8.0)
    for call in (
        lambda: mgt.resolve_device(None),
        lambda: poisson_solve(cfg, geom=geom, verbose=False),
        lambda: generate_hierarchy(
            mgt.SolverConfig(n_cells=(8, 8, 8), L=8.0, max_level=1)),
        lambda: ld.problem_fields(geom, cfg, 0),
        lambda: comp.make_amr_spec(geom, cfg),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert mgt.resolve_device("cpu").type == "cpu"


def test_precision_policy():
    from mg_ic_code_tpu_torch import precision

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert precision.precond_dtype("single", cpu) == "float32"
    assert precision.precond_dtype("double", cuda) is None
    assert precision.precond_dtype("auto", cpu) is None
    assert precision.precond_dtype("auto", cuda) == "float32"
    assert precision.OUTER_DTYPE == torch.float64


def test_profiling_scopes_and_report():
    from mg_ic_code_tpu_torch.utils import profiling

    tree = profiling.TimerTree()
    with tree.scope("outer"):
        for _ in range(3):
            with tree.scope("inner", block=True):
                pass
    text = tree.report()
    lines = text.splitlines()
    assert "outer" in lines[0] and "     1x" in lines[0]
    assert "inner" in lines[1] and "     3x" in lines[1]
    assert lines[1].startswith("  ")  # nested one level down
    tree.reset()
    assert tree.report() == ""
    profiling.barrier_sync()  # a no-op without a CUDA device


def test_pout_verbosity(capsys):
    from mg_ic_code_tpu_torch.io import logging as tlog

    old = tlog.verbosity()
    try:
        tlog.set_verbosity(1)
        tlog.pout("shown", level=1)
        tlog.pout("hidden", level=2)
        assert tlog.verbosity() == 1
    finally:
        tlog.set_verbosity(old)
    out = capsys.readouterr().out
    assert "shown" in out and "hidden" not in out
