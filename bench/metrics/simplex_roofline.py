"""The simplex kernel's share of its roofline over the traced window (%).

Device time of ``simplex_kernel``/``simplex_cluster_kernel`` by the
profiler, set against the least time the window's LPs need
(``bench/roofline/simplex.py``).
"""

from bench.roofline import share


def read(run):
    return share(run, "simplex")
