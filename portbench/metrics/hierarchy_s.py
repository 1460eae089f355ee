"""Seconds of the program's hierarchy generation in set-up
(grid/tagging.generate_hierarchy), by the host clock around the call."""


def read(r):
    return r.hierarchy_s
