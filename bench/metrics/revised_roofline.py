"""The revised kernel's share of its roofline over the traced window (%).

Device time of ``revised_kernel``/``revised_sweep_kernel`` by the
profiler, set against the least time the window's LPs need
(``bench/roofline/revised.py``).
"""

from bench.roofline import share


def read(run):
    return share(run, "revised")
