"""Where the benchmark finds a cell's data, by name.

`BENCHMARK.json` at the root of the checkout lists the cells and the
metrics; each cell's traffic and correctness limits are in
`workloads/<cell>.json`, which names its configuration,
`configs/<config>.json`, whose params file lies beside it; each per-layer
metric is read by `metrics/<metric>.py`. Adding a cell, a configuration or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    params: str  # path of the params file beside it
    workload: dict  # workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # ... and its per-layer metrics
    readers: dict  # per-layer metric name -> read(readings)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(path: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether `cell` reports `metric`: it is listed under the metric's
    `workloads`, or the metric lists none and the cell reports the
    end-to-end metric it moves (per-layer) or every cell does."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or any(m["name"] == moves for m in end_to_end)


def load(root: str, name: str, here: str = HERE) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = _json(os.path.join(here, "workloads", name + ".json"))
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workloads/{name}.json names configuration "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    config = _json(os.path.join(here, "configs", entry["config"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name, [])]
    per_layer = [m for m in bench["per_layer"] if reports(m, name, e2e)]
    readers = {m["name"]: _reader(os.path.join(here, "metrics",
                                               m["name"] + ".py"))
               for m in per_layer}
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                params=os.path.join(here, "configs", config["params"]),
                workload=workload, end_to_end=e2e, per_layer=per_layer,
                readers=readers)
