"""CPU tests of the benchmark (python -m pytest portbench/tests -q).

The harness, its reference and its control are driven here on tiny cells
on the CPU (tiny.py); the one test that needs a card skips without one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import tiny  # noqa: E402
from portbench import cells, reference, roofline, run  # noqa: E402

SEED = 2**31 + 977  # wider than 32 signed bits, as a run's seed may be
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("bench"))


def load(root, name):
    return cells.load(root, name, here=os.path.join(root, "portbench"))


def test_benchmark_json_keeps_to_its_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    e2e = {m["name"] for m in b["end_to_end"]}
    for group, want in keys.items():
        for entry in b[group]:
            assert set(entry) - {"workloads"} == want, entry
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in b["workloads"]:
        cell = cells.load(ROOT, w["name"])
        assert cell.workload["traffic"] == w["traffic"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
    for c in b["configs"]:
        cfg = cells._json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "portbench", "configs",
                                           cfg["params"]))


def test_cell_config_and_metric_added_as_files_are_found(checkout):
    metric = os.path.join(checkout, "portbench", "metrics", "solves_run.py")
    with open(metric, "w") as f:
        f.write("def read(r):\n    return float(len(r.solves))\n")
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["per_layer"].append({"name": "solves_run", "unit": "solves",
                           "better": "higher", "source": "program_counter",
                           "layer": "solve", "moves": "solve_s",
                           "workloads": ["tinyp.scan"]})
    with open(os.path.join(checkout, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = load(checkout, "tinyp.scan")
    assert cell.config["name"] == "tinyp"
    assert cell.params.endswith(os.path.join("configs", "tinyp.txt"))
    assert "solves_run" in cell.readers
    assert [m["name"] for m in cell.end_to_end] == [
        "solve_s", "peak_mem_gb", "setup_s"]
    assert "solves_run" not in load(checkout, "tinyb.scan").readers


def test_precond_bytes_match_a_hand_count():
    # one 8^3 level, one V-cycle: depths 8^3 and the 4^3 bottom.
    # casts 2 * 512 * (8 + 4) = 12288; the 8^3 depth 512 * 4 * (3 + 3.125
    # + 2.125 + 4) = 25088; the bottom (64 * 64 + 2 * 64) * 4 = 16896
    assert roofline.precond_bytes([(8, 8, 8)], 1) == 12288 + 25088 + 16896
    # with a refined 16x8x8 entry and two V-cycles: casts 2 * 1536 * 12 =
    # 36864; a cycle (1024 + 512) * 49 + 16896 = 92160, twice; between
    # the cycles 1536 * 4 * (4 + 3) = 43008
    assert roofline.precond_bytes([(8, 8, 8), (16, 8, 8)], 2) == (
        36864 + 2 * 92160 + 43008)
    assert roofline.depth_chain((256, 256, 256))[-1] == (4, 4, 4)
    assert roofline.depth_chain((64, 48, 40)) == [(64, 48, 40), (32, 24, 20),
                                                  (16, 12, 10), (8, 6, 5)]


@pytest.mark.parametrize("name", ["tinyp.scan", "tinyb.scan"])
def test_reference_agrees_with_the_port_on_the_cpu(checkout, name):
    import mg_ic_code_tpu_torch as mgt
    from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu_torch.solver.nonlinear import poisson_solve

    cell = load(checkout, name)
    draw = {"bh1_spin": 0.07, "bh2_spin": 0.07, "phi_amplitude": 0.02}
    cfg = dataclasses.replace(mgt.load_params(cell.params), **draw)
    geom = generate_hierarchy(cfg, device="cpu")
    p = reference.Params(reference.read_params(cell.params), draw)
    h = reference.hierarchy(p)
    assert h.boxes == [(b.lo, b.hi) for b in geom.boxes]
    if name == "tinyb.scan":  # a refined level with coarse-fine faces
        assert h.boxes[-1] != h.domain[-1]
    res = poisson_solve(cfg, geom=geom, device="cpu", verbose=False)
    got = reference.judge(h, res.psi, res.dpsi, res.constant_K,
                          res.dpsi_norm_history)
    assert got["residual"] < 1e-9 and got["history"] < 1e-12, got
    assert got.get("k", 0.0) < 1e-12, got
    # the judge reads a wrong psi as wrong: one cell moved by 1e-6
    res.psi[-1][3, 4, 5] += 1e-6
    assert reference.judge(h, res.psi, res.dpsi, res.constant_K,
                           res.dpsi_norm_history)["residual"] > 1e-7


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(checkout, trace):
    cell = load(checkout, "tinyp.scan")
    out = run.run(cell, SEED, 1.0, bool(trace), device="cpu")
    # a CPU run traces no card: no breakdown, no device metrics
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    want = [m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)]
    assert set(out["metrics"]) <= set(want)
    on_card = {"precond_roofline", "device_idle_pct"}
    assert set(want) - set(out["metrics"]) == (on_card if trace else set())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["checks"]) == {"failed", "hierarchy", "residual",
                                  "history", "k", "krylov"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_jax_module_is_loaded_by_a_run(checkout):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import cells, run\n"
            "c = cells.load(%r, 'tinyp.scan', here=%r)\n"
            "out = run.run(c, 5, 0.1, False, device='cpu')\n"
            "assert 'mg_ic_code_tpu_torch' in sys.modules\n"
            "print(run.forbidden_modules(), out['correct'])\n"
            % (ROOT, checkout, os.path.join(checkout, "portbench")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("mg_ic_code_tpu_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mg_ic_code_tpu.solver", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.forbidden_modules() == ["jax", "mg_ic_code_tpu.solver"]


def test_without_a_card_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "bbh7.scan", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files_give_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/ has no
    program to run: the run fails and prints no result."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import cells, run\n"
            "c = cells.load(%r, 'bbh7.scan')\n"
            "print(run.run(c, 1, 0.1, False, device='cpu'))\n"
            % (str(tmp_path), str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, timeout=600,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""
    assert "mg_ic_code_tpu_torch" in p.stderr


def test_the_control_is_not_correct(checkout):
    """The control, the program's f32 outer loop in place of its f64, fails
    the limits the sound runs keep."""
    cell = load(checkout, "tinyp.scan")
    bench = run.Bench(cell, "cpu")
    bench.setup()
    h = bench.hierarchy()
    for dtype, ok in ((torch.float64, True), (torch.float32, False)):
        win = bench.window(SEED, 0.5, dtype=dtype)
        checks = bench.check(win, h)
        assert all(c["value"] <= c["limit"]
                   for c in checks.values()) is ok, checks


def _unchanged(nl):
    keep = nl.finish_iteration

    def finish(geom, psi_list, dpsi_list, average_down=False):
        _, norm = keep(geom, psi_list, dpsi_list, average_down)
        return list(psi_list), norm
    return finish


def _half_left_out(nl):
    keep = nl.finish_iteration

    def finish(geom, psi_list, dpsi_list, average_down=False):
        cut = []
        for d in dpsi_list:
            d = d.clone()
            d[d.shape[0] // 2:] = 0.0
            cut.append(d)
        psi, _ = keep(geom, psi_list, cut, average_down)
        return psi, keep(geom, psi_list, dpsi_list, average_down)[1]
    return finish


def _altered(nl):
    keep = nl.poisson_solve

    def solve(*a, **k):
        res = keep(*a, **k)
        res.psi[-1][1, 2, 3] += 1e-5
        return res
    return solve


def _weak_precond(comp):
    keep = comp.make_amr_spec

    def spec(geom, cfg, *a, **k):
        return keep(geom, dataclasses.replace(cfg, num_mg_smooth=1), *a, **k)
    return spec


@pytest.mark.parametrize("name", ["tinyp.scan", "tinyb.scan"])
@pytest.mark.parametrize("fault,module,attr", [
    (_unchanged, "nonlinear", "finish_iteration"),
    (_half_left_out, "nonlinear", "finish_iteration"),
    (_altered, "nonlinear", "poisson_solve"),
    (_weak_precond, "composite", "make_amr_spec"),
])
def test_a_broken_solve_is_not_correct(checkout, monkeypatch, name, fault,
                                       module, attr):
    """A run whose timed path is broken underneath reads correct = false:
    a Picard step that leaves psi as it was; half of each level's cells
    left out of the update; one cell of the answer altered where the solve
    returns it; a preconditioner that smooths once a V-cycle where the
    configuration states four (the f64 answer stands, the BiCGStab
    iterations rise). (One card: no exchange between cards to leave out.)"""
    import importlib

    mod = importlib.import_module(f"mg_ic_code_tpu_torch.solver.{module}")
    cell = load(checkout, name)
    monkeypatch.setattr(mod, attr, fault(mod))
    out = run.run(cell, SEED, 0.1, False, device="cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.requires_cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "bbh7.scan", "--seed", str(SEED),
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
