"""The bytes a preconditioner application needs, and the card's peak.

Counted from the hierarchy's shapes and the algorithm alone, so that the
count reads the same whatever implements it: each step's inputs read once
and its outputs written once (the rule the port's kernel table uses),
whatever a kernel reads again. One application (composite.precond) is
`numMGIterations` AMR V-cycles in the preconditioner's precision, with
the residual cast down on the way in and the correction cast up on the
way out. A V-cycle, at every refined entry and at every depth of the base
level's chain above its bottom:

  * the downsweep's relax from a zero start: rhs and a in, e out;
  * the residual restricted by full weighting: e, rhs and a in, an
    eighth out;
  * the prolongation of the coarse correction: e and an eighth in, e out;
  * the post-smooth: e, rhs and a in, e out;

and the bottom's dense solve: its inverse and r in, e out. From the second
V-cycle on, the composite residual (e, rhs, a in, r out) and the sum of
the corrections (two in, one out) at every entry.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: device memory rate (the bound of every step
# above: about 1 to 2 operations a byte, against 67 TFLOP/s in f32)
HBM_BYTES_S = 3.35e12
MIN_DEPTH = 4  # no depth of the base chain is smaller in any dimension


def depth_chain(shape) -> list:
    """The base level's multigrid depths: halved while every dimension is
    even and the halves stay at least MIN_DEPTH."""
    chain = [tuple(shape)]
    while all(n % 2 == 0 for n in chain[-1]):
        half = tuple(n // 2 for n in chain[-1])
        if min(half) < MIN_DEPTH:
            break
        chain.append(half)
    return chain


def precond_bytes(shapes, v_cycles: int, low: int = 4,
                  outer: int = 8) -> float:
    """Bytes of one application on the entries `shapes` (the base first),
    the preconditioner in `low`-byte floats inside an `outer`-byte Krylov
    vector."""
    cells = [math.prod(s) for s in shapes]
    chain = [math.prod(s) for s in depth_chain(shapes[0])]
    per_cycle = sum(n * low * (3 + 3.125 + 2.125 + 4)
                    for n in cells[1:] + chain[:-1])
    bottom = chain[-1]
    per_cycle += (bottom * bottom + 2 * bottom) * low
    between = (v_cycles - 1) * sum(cells) * low * (4 + 3)
    casts = 2 * sum(cells) * (outer + low)
    return float(casts + v_cycles * per_cycle + between)
