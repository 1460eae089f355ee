"""Tiny cells for the benchmark's CPU tests, added as files to a copy.

`copy(tmp)` copies BENCHMARK.json and portbench/ into `tmp` and adds two
cells the CPU holds, as a later change would add them: a configuration
file with its params beside it, a workload file (bbh7.scan's, with the
tiny cells' limits), and entries in the copy's BENCHMARK.json.
`tinyp.scan` is a 16^3 periodic box; `tinyb.scan`
the canonical binary on a 16^3 base with two refined levels, the finest
cut in x (coarse-fine faces).
"""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PARAMS = os.path.join(ROOT, "mg_ic_code_tpu_torch", "params")

# the limits of the tiny cells, from their CPU readings (f64 residual
# 3e-12 to 6e-11, history 0 to 3e-16, K 0; the f32 control 3e-4 to 3e-3,
# 2e-8 to 5e-8, 9e-6; BiCGStab iterations a Picard step 2.0 to 2.33, with
# one smooth a V-cycle in place of four 4.0 to 7.3)
LIMITS = {"failed": 0, "hierarchy": 0, "residual": 1e-8, "history": 1e-10,
          "krylov": 3.0}
# the periodic box's draws (the binary's are bbh7.scan's)
PERIODIC_DRAWS = [
    {"key": "bh1_spin", "low": 0.025, "high": 0.075,
     "tied": {"bh2_spin": 1.0}},
    {"key": "bh1_momentum", "low": 0.025, "high": 0.075,
     "tied": {"bh2_momentum": -1.0}},
    {"key": "phi_amplitude", "low": 0.01, "high": 0.03},
]

TINY = {
    "tinyp": ("periodic.txt", {"N": "16 16 16", "L": "16.0",
                               "precond_precision": "single"}),
    "tinyb": ("canonical.txt", {"N": "16 16 16", "max_level": "2",
                                "refine_threshold": "0.5",
                                "precond_precision": "single"}),
}


def params_text(base: str, over: dict) -> str:
    lines = []
    with open(os.path.join(PARAMS, base)) as f:
        for line in f:
            key = line.split("=", 1)[0].strip()
            if "=" in line and not line.lstrip().startswith("#") and (
                    key in over):
                continue
            lines.append(line.rstrip("\n"))
    lines += [f"{k} = {v}" for k, v in over.items()]
    return "\n".join(lines) + "\n"


def copy(tmp: str) -> str:
    """The copy's root, with the tiny cells added."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    here = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, (params, over) in TINY.items():
        with open(os.path.join(here, "configs", name + ".txt"), "w") as f:
            f.write(params_text(params, over))
        with open(os.path.join(here, "configs", name + ".json"), "w") as f:
            json.dump({"name": name, "source": "a test", "params":
                       name + ".txt", "reduced": sorted(over)}, f)
        with open(os.path.join(here, "workloads", "bbh7.scan.json")) as f:
            wl = json.load(f)
        wl.update(config=name, check={"sample": 2, "within": 4},
                  trace_solves=1, limits=dict(LIMITS))
        if name == "tinyp":
            wl["draws"] = PERIODIC_DRAWS
            wl["limits"]["k"] = 1e-10
        with open(os.path.join(here, "workloads", name + ".scan.json"),
                  "w") as f:
            json.dump(wl, f)
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": sorted(over), "why": "a test"})
        bench["workloads"].append({"name": name + ".scan", "config": name,
                                   "traffic": "scan", "chips": 1,
                                   "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root
