"""One caller in a closed loop, each call a batch of LPs over ONE ``A``.

A call is ``repro_torch.solve(SharedLPBatch(a, b, c))``: one constraint
matrix and ``lps_per_call`` pairs ``(b, c)``, the reachability pattern
(one polytope, many objectives), waited for before the next call
starts.  The batches come in turn from a pool of ``pool`` distinct
ones, drawn on the device during set-up.  Their matrices are one set,
drawn from the cell's ``matrix_seed``, the same for every seed: how
many pivots an LP takes depends mostly on its polytope, so matrices
drawn from the seed would make the seed change the work (a rate that
spread 7% over seeds and 0.7% over runs of one seed, on an H100).  The
seed draws every ``(b, c)`` and the order of the matrices.
"""

from __future__ import annotations

import torch


def make_pool(generator, config, params, g, device):
    """``params["pool"]`` batches ``(a, b, c)``: ``a`` (m, n), ``b``/``c`` per LP."""
    g_a = torch.Generator(device=device).manual_seed(params["matrix_seed"])
    pool = [generator.shared(g, params["lps_per_call"], config["m"], config["n"],
                             config["torch_dtype"], device, g_a=g_a)
            for _ in range(params["pool"])]
    order = torch.randperm(len(pool), generator=g, device=device).tolist()
    return [pool[k] for k in order]


def call(rt, entry, stats=None):
    a, b, c = entry
    return rt.solve(rt.SharedLPBatch(a, b, c), stats=stats)


def lps(entry) -> int:
    return entry[1].shape[0]


def rows(entry, idx):
    """The LPs ``idx`` of a pool entry as ``(a, b, c)``: (k, m, n), (k, m), (k, n)."""
    a, b, c = entry
    k = b[idx].shape[0]
    return a.expand(k, *a.shape), b[idx], c[idx]
