"""Milliseconds of one preconditioner application (solver/composite.precond:
the AMR V-cycles in f32), the card synchronised before and after every
call: the mean over the calls of the timed solves."""


def read(r):
    s = r.spans.get("precond") or []
    return 1e3 * sum(s) / len(s) if s else None
