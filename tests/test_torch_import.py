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
# the sharded solve (parallel/) on a mesh of two CPU entries
from mg_ic_code_tpu_torch.parallel import mesh as pmesh
sharded = poisson_solve(cfg, device="cpu", verbose=False,
                        mesh=pmesh.make_mesh(["cpu"] * 2))
assert abs(sharded.dpsi_norm_history[0] - res.dpsi_norm_history[0]) <= (
    1e-6 * res.dpsi_norm_history[0])
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


_CLI = r"""
import os, sys, tempfile
import torch
torch.set_num_threads(1)
import mg_ic_code_tpu_torch as mgt
from mg_ic_code_tpu_torch import main
from mg_ic_code_tpu_torch.io import chombo_hdf5, restart
from mg_ic_code_tpu_torch.ops import wavefront
canonical = os.path.join(os.path.dirname(mgt.__file__), "params",
                         "canonical.txt")
over = ["N = 16 16 16", "L = 16.0", "max_level = 1",
        "refine_threshold = 0.1", "block_factor = 4", "buffer_size = 2",
        "max_grid_size = 16", "numMGIterations = 1", "max_NL_iterations = 2",
        "verbosity = 0", "bh1_bare_mass = 0.2", "bh2_bare_mass = 0.2",
        "bh1_offset = 2.0", "bh2_offset = -2.0", "precond_precision = double"]
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    rc = main.run(["main", canonical] + over, device="cpu")
    if chombo_hdf5.HAVE_H5PY:
        assert rc == 0, rc
        geom, psi, _ = restart.load_state(
            "vcPoissonFinal.3d.hdf5", mgt.load_params(canonical, over),
            device="cpu")
        assert geom.num_levels == 2 and psi[1].shape == (32, 32, 32)
    else:
        assert rc == 2, rc
    os.chdir("/")
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "mg_ic_code_tpu" or m.startswith("mg_ic_code_tpu.")]
assert not bad, bad
print("CLI_STANDS_ALONE")
"""


def test_port_cli_and_io_import_no_jax():
    """main, io/chombo_hdf5, io/restart and ops/wavefront: a whole
    command-line run on the CPU pulls in no JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _CLI], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "CLI_STANDS_ALONE" in r.stdout


def test_port_sources_name_no_jax_import():
    """No module of the port, nor the GPU smoke script, has an import of
    jax or of the JAX package in its source."""
    import re

    pat = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|mg_ic_code_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mg_ic_code_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for f in files:
        assert not pat.search(open(f).read()), f


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


_MODULES = r"""
import importlib, os, pkgutil, sys
import torch
import mg_ic_code_tpu_torch as mgt
names = [m.name for m in pkgutil.walk_packages(mgt.__path__, mgt.__name__ + ".")]
for need in ("physics.diagnostics", "ops.fused_sweeps", "ops.wavefront",
             "ops.coarse_tower", "ops.cuda_ext", "solver.multigrid",
             "parallel.mesh", "parallel.halo", "parallel.distributed"):
    assert mgt.__name__ + "." + need in names, need
for name in names:
    importlib.import_module(name)
import chip_smoke  # the GPU smoke script: importing it runs nothing
assert os.path.exists(chip_smoke.PERIODIC) and os.path.exists(chip_smoke.CANONICAL)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "mg_ic_code_tpu" or m.startswith("mg_ic_code_tpu.")]
assert not bad, bad
# importing built no kernel and loaded no compiler
from mg_ic_code_tpu_torch.ops import cuda_ext
assert cuda_ext._lib is None and "triton" not in sys.modules
print("EVERY_MODULE_STANDS_ALONE", len(names))
"""


def test_every_port_module_and_the_smoke_script_import_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _MODULES], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "EVERY_MODULE_STANDS_ALONE" in r.stdout


def test_kernel_sources_are_listed_and_the_build_directory_is_ignored():
    from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts

    on_disk = sorted(os.listdir(cuda_ext.CSRC_DIR))
    assert sorted(cuda_ext.SOURCES + cuda_ext.HEADERS) == on_disk
    assert "multisweep.cu" in cuda_ext.SOURCES
    assert "multisweep_halo.cu" in cuda_ext.SOURCES
    # the one-sweep and one-pass entry points: a unit of their own
    assert "gsrb_sweep.cu" in cuda_ext.SOURCES
    for name in ("gsrb_full_sweep", "gsrb_half_sweep"):
        assert name in kernel_counts.KERNELS
    for name in ("multisweep_relax", "multisweep_relax_halo",
                 "multisweep_relax_tiled_pre"):
        assert name in kernel_counts.KERNELS
    # the wavefront wrapper launches the multisweep kernel: one march, one
    # set of instantiations
    assert "wavefront_relax" in kernel_counts.KERNELS
    assert "wavefront.cu" not in on_disk
    # every C entry point that is declared to ctypes is defined in a source
    text = "".join(open(os.path.join(cuda_ext.CSRC_DIR, f)).read()
                   for f in cuda_ext.SOURCES)
    for entry in ("mgk_gsrb_relax", "mgk_gsrb_sweep",
                  "mgk_gsrb_sweep_capacity", "mgk_residual",
                  "mgk_multisweep_relax", "mgk_multisweep_halo",
                  "mgk_multisweep_pre", "mgk_tower_down", "mgk_tower_up",
                  "mgk_tower_capacity", "mgk_tower_barriers",
                  "mgk_residual_capacity"):
        assert f'extern "C" int {entry}(' in text, entry
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "build/" in ignored
    if not os.environ.get("MG_IC_BUILD_DIR"):
        assert cuda_ext.build_dir().startswith(os.path.join(ROOT, "build"))


def test_smoke_script_exits_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 1
    assert r.stdout.strip() == ""
