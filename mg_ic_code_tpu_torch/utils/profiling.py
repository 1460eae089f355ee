"""Hierarchical scoped timers + NVTX ranges.

The observability equivalent of Chombo's CH_TIME scoped-timer tree:
`scope(...)` nests, `report()` prints the hierarchical time table. On a
CUDA device every scope also opens an NVTX range so the same names line up
in a device trace.

By default timers measure host wall time around the enqueue; pass
`block=True` to time completed device work (`torch.cuda.synchronize()`
before the clock is read).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class _Node:
    name: str
    total: float = 0.0
    count: int = 0
    children: dict = field(default_factory=dict)

    def child(self, name: str) -> "_Node":
        if name not in self.children:
            self.children[name] = _Node(name)
        return self.children[name]


def _cuda_live() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class TimerTree:
    """One tree per instance; thread-unsafe by design (the per-process
    CH_TIMER model)."""

    def __init__(self):
        self.root = _Node("root")
        self._stack = [self.root]

    @contextlib.contextmanager
    def scope(self, name: str, block: bool = False):
        node = self._stack[-1].child(name)
        self._stack.append(node)
        nvtx = _cuda_live()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            if block:
                barrier_sync()
            node.total += time.perf_counter() - t0
            node.count += 1
            if nvtx:
                torch.cuda.nvtx.range_pop()
            self._stack.pop()

    def report(self, out=None) -> str:
        lines: list[str] = []

        def rec(node: _Node, depth: int, parent_total: float):
            if node is not self.root:
                pct = (
                    100.0 * node.total / parent_total
                    if parent_total > 0
                    else 100.0
                )
                lines.append(
                    f"{'  ' * depth}[{node.total * 1e3:10.2f} ms] "
                    f"{node.count:6d}x {pct:5.1f}%  {node.name}"
                )
            ptotal = node.total if node is not self.root else sum(
                c.total for c in node.children.values()
            )
            for c in sorted(
                node.children.values(), key=lambda c: -c.total
            ):
                rec(c, depth + (node is not self.root), ptotal)

        rec(self.root, 0, 0.0)
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text

    def reset(self):
        self.root = _Node("root")
        self._stack = [self.root]


# default process-wide tree (the CH_TIMER global)
TIMERS = TimerTree()
scope = TIMERS.scope
report = TIMERS.report
reset = TIMERS.reset


def barrier_sync():
    """Wait until all enqueued device work is done (no-op on the CPU)."""
    if _cuda_live():
        torch.cuda.synchronize()
