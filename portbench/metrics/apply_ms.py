"""Milliseconds of one f64 application of the composite operator
(solver/composite.composite_apply), the card synchronised before and
after every call: the mean over the calls of the timed solves."""


def read(r):
    s = r.spans.get("apply") or []
    return 1e3 * sum(s) / len(s) if s else None
