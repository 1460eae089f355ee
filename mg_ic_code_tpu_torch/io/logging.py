"""Log stream with verbosity gating (single process).

Equivalent of Chombo's pout()/parstream for the reference's progress
lines: `verbosity` gates detail exactly like the reference's parameter.
The port is single-process, so every line goes to the current stdout.
"""

from __future__ import annotations

import sys

_verbosity: int = 2


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def verbosity() -> int:
    return _verbosity


def pout(msg: str, level: int = 1) -> None:
    """Write a log line if `level` <= current verbosity (always to the
    CURRENT sys.stdout — harnesses swap it underneath us)."""
    if level > _verbosity:
        return
    print(msg, file=sys.stdout)
