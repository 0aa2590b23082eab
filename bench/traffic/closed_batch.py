"""One caller in a closed loop, each call a batch of LPs with their own ``A``.

A call is ``repro_torch.solve(LPProblem.make(c, a, bu=b, device=a.device))`` on
``lps_per_call`` LPs, waited for before the next call starts.  The
batches come in turn from a pool of ``pool`` distinct batches, drawn on
the device from the seed during set-up.
"""

from __future__ import annotations


def make_pool(generator, config, params, g, device):
    """``params["pool"]`` batches ``(a, b, c)`` of ``params["lps_per_call"]`` LPs each."""
    return [generator.dense(g, params["lps_per_call"], config["m"], config["n"],
                            config["torch_dtype"], device) for _ in range(params["pool"])]


def call(rt, entry, stats=None):
    a, b, c = entry
    return rt.solve(rt.LPProblem.make(c, a, bu=b, device=a.device), stats=stats)


def lps(entry) -> int:
    return entry[0].shape[0]


def rows(entry, idx):
    """The LPs ``idx`` of a pool entry as ``(a, b, c)``: (k, m, n), (k, m), (k, n)."""
    a, b, c = entry
    return a[idx], b[idx], c[idx]
