"""Per-process log streams with verbosity gating.

Equivalent of Chombo's pout()/parstream for the reference's progress
lines (Main_PoissonSolver.cpp:133-134, 149, 210): in a run over several
processes (parallel/distributed.py) each process writes its own
`pout.<n>` in the current directory and process 0 mirrors its lines to
stdout; one process writes to stdout alone. `verbosity` gates detail
exactly like the reference's parameter (PoissonParameters.cpp:62-64).
"""

from __future__ import annotations

import sys
from typing import TextIO

_verbosity: int = 2
_stream: TextIO | None = None


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def verbosity() -> int:
    return _verbosity


def _process() -> tuple[int, int]:
    """(index, count) of this process."""
    from mg_ic_code_tpu_torch.parallel import distributed as dist

    return dist.process_index(), dist.process_count()


def pout(msg: str, level: int = 1) -> None:
    """Write a log line if `level` <= current verbosity: to this process's
    `pout.<n>` (opened at the first line, line-buffered) over several
    processes, process 0 also to stdout; on one process to the CURRENT
    sys.stdout (harnesses swap it underneath us)."""
    global _stream
    if level > _verbosity:
        return
    rank, count = _process()
    if count > 1:
        if _stream is None:
            _stream = open(f"pout.{rank}", "a", buffering=1)
        print(msg, file=_stream)
        if rank != 0:
            return
    print(msg, file=sys.stdout)


def close() -> None:
    """Close this process's `pout.<n>` (a later line opens it again)."""
    global _stream
    if _stream is not None:
        _stream.close()
        _stream = None
