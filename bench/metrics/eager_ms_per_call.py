"""Device milliseconds a call of everything but the port's four kernels.

The front door and the dispatch on the device: canonicalize, the
tableau build, uncanonicalize, copies and sets, by the profiler.
"""


def read(run):
    t = run.trace
    if t is None or t.calls == 0:
        return None
    return (sum(t.device_s.values()) - t.port_seconds()) * 1e3 / t.calls
