"""The benchmark of mg_ic_code_tpu_torch: whole initial-data solves of a
parameter scan, on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One request is one whole nonlinear solve, `poisson_solve(cfg, geom=geom)`,
from the physics fields and psi = 1 to the returned result. Set-up loads
the cell's params, builds the hierarchy once and solves once to warm up.
The window then runs solves one after another, each with the parameters of
the next draw of the scan (traffic.py), until `--seconds` have passed; the
solve running then finishes. Afterwards the plain reference (reference.py)
judges the solves the seed picked and the last one, and the result is
printed as the last line of standard output, each number compared with its
limit as the last lines of standard error.

With --trace 0 the line holds the cell's end-to-end metrics. With --trace 1
it holds its per-layer metrics (metrics/<name>.py): the window's first
`trace_solves` solves run under the profiler with a range around each of
the program's layers (spans.py, devtrace.py), the next as many with the
card synchronised around every operator and preconditioner application,
the rest plain.

The run needs a CUDA card (and exits with 2 without one). The program
builds its kernels at first use into the checkout's build/ directory.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import (  # noqa: E402
    cells, devtrace, reference, roofline, spans, traffic,
)

# top-level module names no run may have loaded once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mg_ic_code_tpu")
TIMED = ("apply", "precond")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Window:
    records: list  # per solve: seconds, ok, picard, krylov
    kept: list  # the outputs the check judges
    wall_s: float
    peak_bytes: int
    trace: dict
    timed: dict

    @property
    def failed(self) -> int:
        return sum(not r["ok"] for r in self.records)


class Bench:
    """One cell on one device: set-up, the window, the check."""

    def __init__(self, cell: cells.Cell, device="cuda"):
        self.cell, self.device = cell, torch.device(device)
        self.tokens = reference.read_params(cell.params)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def setup(self) -> None:
        import mg_ic_code_tpu_torch as mgt
        from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy
        from mg_ic_code_tpu_torch.solver import nonlinear

        self.nl = nonlinear
        self.cfg = mgt.load_params(self.cell.params)
        t0 = time.perf_counter()
        self.geom = generate_hierarchy(self.cfg, device=self.device)
        self.hierarchy_s = time.perf_counter() - t0
        self.boxes = [(b.lo, b.hi) for b in self.geom.boxes]
        self.solve(None)
        self.sync()
        self.setup_peak = self.peak()
        self.setup_s = time.perf_counter() - T_START

    def solve(self, draw, dtype=torch.float64):
        """One request: (result or None where it raised or gave a psi that
        is not finite, its wall seconds)."""
        cfg = dataclasses.replace(self.cfg, **draw) if draw else self.cfg
        t0 = time.perf_counter()
        try:
            res = self.nl.poisson_solve(cfg, geom=self.geom, dtype=dtype,
                                        device=self.device, verbose=False)
        except self.nl.NonConvergenceError:
            res = None
        self.sync()
        dt = time.perf_counter() - t0
        if res is not None and not bool(torch.stack(
                [torch.isfinite(p).all() for p in res.psi]).all()):
            res = None
        return res, dt

    def keep(self, i: int, draw: dict, res, bufs=None) -> dict:
        """What the check needs of solve i, copied off the card (into
        `bufs`, pinned host memory, where given) before it returns."""
        if bufs is None:
            psi = [p.to("cpu") for p in res.psi]
            dpsi = [p.to("cpu") for p in res.dpsi]
        else:
            psi, dpsi = bufs
            for b, p in zip(psi + dpsi, res.psi + res.dpsi):
                b.copy_(p, non_blocking=True)
            self.sync()
        return {"index": i, "draw": dict(draw), "psi": psi, "dpsi": dpsi,
                "K": res.constant_K, "history": list(res.dpsi_norm_history),
                "krylov": list(res.linear_iters)}

    def _pinned(self, n: int, dtype) -> list:
        if self.device.type != "cuda":
            return [None] * n
        shapes = [tuple(h - lo + 1 for lo, h in zip(*b)) for b in self.boxes]
        return [tuple([torch.empty(s, dtype=dtype, pin_memory=True)
                       for s in shapes] for _ in range(2))
                for _ in range(n)]

    def window(self, seed: int, seconds: float, trace: bool = False,
               dtype=torch.float64) -> Window:
        wl = self.cell.workload
        scan = traffic.Scan(wl, seed)
        picked = traffic.sample(wl, seed)
        bufs = dict(zip(picked, self._pinned(len(picked), dtype)))
        k = int(wl["trace_solves"]) if trace else 0
        records, kept, timed = [], [], {}
        tr = wrapped = None
        res = None
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        # the copies the check keeps are no request's work: their seconds
        # are taken out of the window's
        paused = 0.0
        t_start = time.perf_counter()
        i = 0
        while True:
            if trace and i == 0:
                tr = devtrace.Trace(card=self.device.type == "cuda")
                wrapped = spans.Wrapped(spans.POINTS, tr.span)
            if trace and i == k:
                wrapped.remove()
                tr.stop()
                wrapped = spans.Wrapped(TIMED, spans.timed(self.sync, timed))
            if trace and i == 2 * k:
                wrapped.remove()
            draw = scan.draw(i)
            with (tr.span("solve") if trace and i < k
                  else contextlib.nullcontext()):
                res, dt = self.solve(draw, dtype)
            records.append({
                "seconds": dt, "ok": res is not None,
                "picard": len(res.dpsi_norm_history) if res else 0,
                "krylov": list(res.linear_iters) if res else []})
            done = (time.perf_counter() - t_start - paused >= seconds
                    and i >= 2 * k)
            if res is not None and (i in bufs and not done):
                t0 = time.perf_counter()
                kept.append(self.keep(i, draw, res, bufs[i]))
                paused += time.perf_counter() - t0
            i += 1
            if done:
                break
            res = None
        wall = time.perf_counter() - t_start - paused
        peak = self.peak()
        if res is not None:
            kept.append(self.keep(i - 1, draw, res))
        res = None
        self.sync()
        return Window(records=records, kept=kept, wall_s=wall,
                      peak_bytes=peak,
                      trace=tr.reduce() if tr else {}, timed=timed)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.geom = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def hierarchy(self) -> reference.Hier:
        return reference.hierarchy(reference.Params(self.tokens), self.device)

    def judge(self, h: reference.Hier, rec: dict) -> dict:
        """The numbers compared for one kept solve: the reference's
        readings of its outputs, and `krylov`, its BiCGStab iterations a
        Picard step (a preconditioner that does less than the
        configuration states takes more)."""
        p = reference.Params(self.tokens, rec["draw"])
        out = reference.judge(reference.Hier(p, h.boxes), rec["psi"],
                              rec["dpsi"], rec["K"], rec["history"],
                              self.device)
        out["krylov"] = sum(rec["krylov"]) / len(rec["krylov"])
        return out

    def check(self, win: Window, h: reference.Hier) -> dict:
        """Every number compared, with its limit (None where the
        hierarchy differs and the solves cannot be judged on it)."""
        nums = {"failed": win.failed,
                "hierarchy": sum(a != b for a, b in zip(h.boxes, self.boxes))
                + abs(len(h.boxes) - len(self.boxes))}
        if nums["hierarchy"] == 0:
            for rec in win.kept:
                for key, v in self.judge(h, rec).items():
                    nums[key] = max(nums.get(key, 0.0), v)
        limits = self.cell.workload["limits"]
        return {k: {"value": nums.get(k), "limit": limits[k]}
                for k in limits}

    def precond_bytes(self, h: reference.Hier):
        t = self.tokens
        prec = t.get("precond_precision", ["auto"])[0]
        low = 8 if prec == "double" or (
            prec == "auto" and self.device.type != "cuda") else 4
        return roofline.precond_bytes(
            [h.shape(l) for l in range(h.levels)],
            int(t.get("numMGIterations", ["1"])[0]), low)


def end_to_end(bench: Bench, win: Window) -> dict:
    return {"setup_s": bench.setup_s,
            "solve_s": win.wall_s / len(win.records),
            "peak_mem_gb": win.peak_bytes / 1e9}


def per_layer(bench: Bench, win: Window, h: reference.Hier) -> dict:
    readings = types.SimpleNamespace(
        hierarchy_s=bench.hierarchy_s, solves=win.records, spans=win.timed,
        trace=win.trace, precond_bytes=bench.precond_bytes(h),
        hbm_bytes_s=roofline.HBM_BYTES_S)
    out = {}
    for name, read in bench.cell.readers.items():
        v = read(readings)
        if v is not None:
            out[name] = v
    return out


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        device="cuda") -> dict:
    """Set-up, the window and the check of one run: the result line."""
    bench = Bench(cell, device)
    bench.setup()
    print(f"set-up {bench.setup_s:.3f} s (hierarchy {bench.hierarchy_s:.3f}"
          f" s)", file=sys.stderr)
    win = bench.window(seed, seconds, trace)
    print(f"window {win.wall_s:.3f} s, {len(win.records)} solves, "
          f"{win.failed} failed", file=sys.stderr)
    bench.release()
    h = bench.hierarchy()
    checks = bench.check(win, h)
    if trace:
        vals = per_layer(bench, win, h)
        metrics = cell.per_layer
    else:
        vals = end_to_end(bench, win)
        metrics = cell.end_to_end
    on_card = bench.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(bench.device) if on_card
           else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(win.peak_bytes, bench.setup_peak)}
    if trace:
        dev["busy_s"] = win.trace.get("busy_s", 0.0)
        dev["window_s"] = win.trace.get("window_s", 0.0)
    out = {
        "correct": bool(win.kept) and all(
            c["value"] is not None and c["value"] <= c["limit"]
            for c in checks.values()),
        "attempted": len(win.records), "failed": win.failed,
        "metrics": {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                    for m in metrics if m["name"] in vals},
        "device": dev,
    }
    if trace and win.trace:
        out["breakdown"] = win.trace["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
