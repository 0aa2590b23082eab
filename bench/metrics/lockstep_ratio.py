"""Pivot slots a launch pays for over pivots the LPs took.

``SolveStats.lockstep_iterations / simplex_iterations``: every LP of a
dispatch round waits for its slowest.  Read in the ``--trace 1`` run
over one call of each pool entry (the calls the window repeats), after
the profiled window: the counters cost a sync a dispatch round.
"""


def read(run):
    s = run.stats
    if s is None or not s.simplex_iterations:
        return None
    return s.lockstep_iterations / s.simplex_iterations
