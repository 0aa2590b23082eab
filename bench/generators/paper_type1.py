"""The paper's LP type 1: a feasible initial basic solution (one phase).

    maximize c . x   subject to   A x <= b,   x >= 0,   b >= 0

A PyTorch copy, drawn on the device, of the distributions of
``repro_torch/core/lp.py:random_lp_batch`` (``feasible_start=True``):
``A`` uniform in [-1, 1] with ``|A_jj| + 1`` on the diagonal, ``b``
uniform in [1, 10], ``c`` uniform in [0.1, 1].  The origin is a vertex,
so the slack basis starts feasible.
"""

from __future__ import annotations

import torch


def _uniform(g, shape, lo, hi, dtype, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=dtype, device=device)


def _matrix(g, lead, m, n, dtype, device):
    a = _uniform(g, (*lead, m, n), -1.0, 1.0, dtype, device)
    k = min(m, n)
    diag = a.diagonal(dim1=-2, dim2=-1)[..., :k]
    diag.copy_(diag.abs() + 1.0)
    return a


def dense(g, lps, m, n, dtype, device):
    """``(a, b, c)`` of ``lps`` LPs, each with its own ``A``: (lps, m, n), (lps, m), (lps, n)."""
    a = _matrix(g, (lps,), m, n, dtype, device)
    b = _uniform(g, (lps, m), 1.0, 10.0, dtype, device)
    c = _uniform(g, (lps, n), 0.1, 1.0, dtype, device)
    return a, b, c


def shared(g, lps, m, n, dtype, device, g_a=None):
    """``(a, b, c)`` of ``lps`` LPs over ONE ``A``: (m, n), (lps, m), (lps, n); ``A``
    drawn from ``g_a`` where given, else from ``g``."""
    a = _matrix(g if g_a is None else g_a, (), m, n, dtype, device)
    b = _uniform(g, (lps, m), 1.0, 10.0, dtype, device)
    c = _uniform(g, (lps, n), 0.1, 1.0, dtype, device)
    return a, b, c
