"""Mean pivots an LP took over the window: the returned ``iterations``."""


def read(run):
    return run.pivots / run.lps if run.lps else None
