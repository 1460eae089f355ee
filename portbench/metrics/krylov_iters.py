"""BiCGStab iterations of one linear solve (NLResult.linear_iters), the
mean over every Picard iteration of the window's solves that returned."""


def read(r):
    n = [k for s in r.solves if s["ok"] for k in s["krylov"]]
    return sum(n) / len(n) if n else None
