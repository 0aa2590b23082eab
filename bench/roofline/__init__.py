"""Each kernel's operations and bytes, counted from the LPs' inputs and pivots.

``bench/roofline/<kernel>.py`` holds ``KERNELS`` (a pattern over the
short names of the kernel's device functions) and ``work(m, n,
itemsize, lps, pivots, phase1_lps, calls) -> (operations, bytes)``.
"""


def share(run, kernel: str):
    """100 x the least time the window's LPs need on ``kernel`` over its device time.

    The least time is the larger of the operations over the card's peak
    rate in the LPs' dtype and the bytes over its memory bandwidth
    (``bench/peaks.json``).  None where the trace holds no time of the
    kernel or the card is not in the table.
    """
    from bench.harness import load_module

    if run.trace is None:
        return None
    module = load_module("roofline", kernel)
    seconds = run.trace.seconds(module.KERNELS)
    peak = run.peak()
    if seconds <= 0 or peak is None:
        return None
    cfg = run.cell.config
    itemsize = 8 if cfg["dtype"] == "float64" else 4
    ops, nbytes = module.work(cfg["m"], cfg["n"], itemsize, run.lps, run.pivots, run.phase1_lps,
                              len(run.calls))
    least = max(ops / peak["flops"][cfg["dtype"]], nbytes / peak["bytes_per_s"])
    return 100.0 * least / seconds
