"""The solver state of the largest dispatch round, GiB: ``SolveStats.tableau_bytes``.

Read in the ``--trace 1`` run over one call of each pool entry, after the
profiled window (the counters cost a sync a dispatch round).
"""


def read(run):
    s = run.stats
    if s is None or not s.tableau_bytes:
        return None
    return s.tableau_bytes / 2**30
