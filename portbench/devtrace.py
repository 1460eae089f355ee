"""The device trace of the traced solves, reduced to what the metrics read.

`Trace()` starts a torch.profiler trace of the card alone (kernels, copies
and fills, and the runtime calls that launched them; no host operators,
whose recording would slow the host path that the traced solves run), and
launches one marker kernel so that the trace's clock can be paired with
the host's. The benchmark's ranges around the program's layers are host
times it keeps itself (`Trace.span`). After the window `reduce()` writes
the trace out in the temporary directory, reads it back, deletes it and
sums:

* `busy_s` / `window_s`: seconds in which a kernel, copy or fill ran on
  the card (intervals merged), within the traced window: from the start
  of the first `solve` range to the end of the last (a solve's range ends
  after its last read-back, so the card is done with it);
* `device_s[point]` / `calls[point]`: device seconds of the work launched
  while a `point` range was open (the launch's runtime call, matched to
  the work by its correlation id), and the number of such ranges;
* `device_ops`: the 10 device operations that took the most time, by
  name; `idle_gaps`: the 10 longest stretches of the window with nothing
  on the card, each named by the innermost benchmark range open on the
  host when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TOP = 10


def short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    s = name.removeprefix("void ")
    depth = 0
    for i in range(len(s) - 1, -1, -1) if s.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(s[i], 0)
        if depth == 0:
            s = s[:i]
            break
    return s[:160]


def _merged(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """`card` False (a CPU run) keeps the host ranges and traces nothing."""

    def __init__(self, card: bool = True):
        self.ranges: list = []  # (point, start ns, end ns), host monotonic
        self.prof = None
        if card:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.mark_ns = time.monotonic_ns()
            torch.cuda._sleep(1)

    @contextlib.contextmanager
    def span(self, point: str):
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.ranges.append((point, t0, time.monotonic_ns()))

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()

    def _events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                tr = json.load(f)
        finally:
            os.remove(path)
        return tr["traceEvents"] if isinstance(tr, dict) else tr

    def reduce(self) -> dict:
        if self.prof is None:
            return {}
        launches, work, mark = {}, [], None
        for e in self._events():
            cat, args = e.get("cat"), e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = e["ts"]
            elif cat in DEVICE_CATS:
                if cat == "kernel" and MARKER in e["name"]:
                    mark = args.get("correlation")
                    continue
                name = short(e["name"]) if cat == "kernel" else e["name"]
                work.append((e["ts"], e["ts"] + e.get("dur", 0.0), name,
                             args.get("correlation")))
        if mark not in launches:
            return {}
        # host ns -> trace us: the marker's launch call began right after
        # mark_ns was read
        off = launches[mark] - self.mark_ns * 1e-3
        ranges: dict = {}
        for p, a, b in self.ranges:
            ranges.setdefault(p, []).append((a * 1e-3 + off, b * 1e-3 + off))
        solves = ranges.get("solve", [])
        if not solves:
            return {}
        w0, w1 = min(a for a, _ in solves), max(b for _, b in solves)
        inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in work
                  if b > w0 and a < w1]
        busy = _merged([(a, b) for a, b, _, _ in inside])

        device_s, calls = {}, {}
        for point, spans in ranges.items():
            spans = sorted(spans)
            starts = [a for a, _ in spans]
            total = 0.0
            for a, b, _, c in inside:
                t = launches.get(c)
                if t is None:
                    continue
                k = bisect.bisect_right(starts, t) - 1
                if k >= 0 and t <= spans[k][1]:
                    total += b - a
            device_s[point], calls[point] = total * 1e-6, len(spans)

        by_name: dict = {}
        for a, b, n, _ in inside:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        opened = sorted((a, b, p) for p, spans in ranges.items()
                        for a, b in spans)

        def host_doing(t: float) -> str:
            best = None
            for a, b, p in opened:
                if a > t:
                    break
                if b >= t and (best is None or a >= best[0]):
                    best = (a, p)
            return "between the benchmark's ranges" if best is None else (
                best[1])

        return {
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "device_s": device_s, "calls": calls,
            "breakdown": {
                "device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[host_doing(a), (b - a) * 1e-6]
                              for a, b in gaps],
            },
        }
