"""Debug assertions, the CH_assert equivalent.

Port of the JAX package's `utils/asserts.py`. Chombo's CH_assert compiles
away in optimized builds and aborts in DEBUG builds (used at e.g.
VariableCoeffPoissonOperator.cpp:85-87, SetLevelData.cpp:36). Here:
host-side checks are plain asserts; checks of device values are enabled
with `enable_debug_checks(True)` and are off by default, like a release
build: each one reads a flag back from the device, which waits for the
device to finish the work queued before it.
"""

from __future__ import annotations

import torch

_enabled = False


def enable_debug_checks(on: bool = True) -> None:
    global _enabled
    _enabled = on


def debug_checks_enabled() -> bool:
    return _enabled


def check_finite(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """In debug mode, raise FloatingPointError when x has NaN/Inf (one
    device sync). Returns x unchanged so calls chain."""
    if _enabled and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x


def host_assert(cond: bool, msg: str) -> None:
    """Host-side precondition (always on: these are cheap shape/config
    checks, the moral equivalent of CH_assert on box metadata)."""
    if not cond:
        raise AssertionError(msg)
