"""Spans the benchmark puts around the program's layers, from its own code.

Each point is a function of the program that another of its functions
calls by a module-level name, so that a wrapper set on the module is the
one called. `Wrapped(points, around)` runs every call of each point inside
`around(point)`, a context manager (devtrace.Trace.span for the traced
solves; `timed` for the timed ones), and `remove()` puts the functions
back.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

PROGRAM = "mg_ic_code_tpu_torch"
POINTS = {
    "fields": ("physics.level_data", "problem_fields"),
    "prepare": ("solver.nonlinear", "prepare_iteration"),
    "coefs": ("solver.composite", "build_coefs"),
    "linear": ("solver.composite", "solve_linear"),
    "apply": ("solver.composite", "composite_apply"),
    "precond": ("solver.composite", "precond"),
    "finish": ("solver.nonlinear", "finish_iteration"),
}


class Wrapped:
    def __init__(self, points, around):
        self._saved = []
        for p in points:
            mod = importlib.import_module(f"{PROGRAM}.{POINTS[p][0]}")
            fn = getattr(mod, POINTS[p][1])
            self._saved.append((mod, POINTS[p][1], fn))
            setattr(mod, POINTS[p][1], self._wrap(p, fn, around))

    @staticmethod
    def _wrap(point, fn, around):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with around(point):
                return fn(*a, **k)
        return wrapped

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


def timed(sync, seconds: dict):
    """`around` that synchronises the card before and after each call and
    keeps the call's wall seconds in seconds[point]."""
    @contextlib.contextmanager
    def around(point):
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            seconds.setdefault(point, []).append(time.perf_counter() - t0)
    return around
