"""Picard iterations a solve took (the length of its dpsi-norm history),
the mean over the window's solves that returned."""


def read(r):
    n = [s["picard"] for s in r.solves if s["ok"]]
    return sum(n) / len(n) if n else None
