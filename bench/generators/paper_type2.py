"""The paper's LP type 2: an infeasible initial basic solution (two phases).

    maximize c . x   subject to   x <= hi,   -x <= -lo,   W x <= w,   x >= 0

A PyTorch copy, drawn on the device, of the distributions of
``repro_torch/core/lp.py:random_lp_batch`` (``feasible_start=False``): a
box ``lo <= x <= hi`` with ``lo`` uniform in [0.5, 1] and ``hi - lo`` in
[0.5, 2], written as ``I x <= hi`` and ``-I x <= -lo`` (so ``b < 0`` on
n rows and the slack basis is infeasible), then ``m - 2n`` loose cover
rows ``W x <= W hi + u`` with ``W`` uniform in [0.1, 1] and ``u`` in
[0.1, 1]; ``c`` uniform in [0.1, 1].  Needs ``m >= 2n``.
"""

from __future__ import annotations

import torch


def _uniform(g, shape, lo, hi, dtype, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=dtype, device=device)


def _rows(g, lead, lps, m, n, dtype, device, g_w=None):
    """The matrix ``[I; -I; W]`` with ``lead`` leading dims, and ``b`` for ``lps`` boxes;
    ``W`` drawn from ``g_w`` where given, else from ``g``."""
    extra = m - 2 * n
    if extra < 0:
        raise ValueError(f"type 2 needs m >= 2n, got m={m} n={n}")
    lo = _uniform(g, (lps, n), 0.5, 1.0, dtype, device)
    hi = lo + _uniform(g, (lps, n), 0.5, 2.0, dtype, device)
    eye = torch.eye(n, dtype=dtype, device=device)
    a = torch.zeros((*lead, m, n), dtype=dtype, device=device)
    a[..., :n, :] = eye
    a[..., n:2 * n, :] = -eye
    b = torch.empty((lps, m), dtype=dtype, device=device)
    b[:, :n] = hi
    b[:, n:2 * n] = -lo
    if extra:
        w = _uniform(g if g_w is None else g_w, (*lead, extra, n), 0.1, 1.0, dtype, device)
        a[..., 2 * n:, :] = w
        cover = (w * hi[:, None, :]).sum(dim=-1) if lead else hi @ w.T
        b[:, 2 * n:] = cover + _uniform(g, (lps, extra), 0.1, 1.0, dtype, device)
    return a, b


def dense(g, lps, m, n, dtype, device):
    """``(a, b, c)`` of ``lps`` LPs, each with its own ``A``: (lps, m, n), (lps, m), (lps, n)."""
    a, b = _rows(g, (lps,), lps, m, n, dtype, device)
    c = _uniform(g, (lps, n), 0.1, 1.0, dtype, device)
    return a, b, c


def shared(g, lps, m, n, dtype, device, g_a=None):
    """``(a, b, c)`` of ``lps`` LPs over ONE ``[I; -I; W]``: (m, n), (lps, m), (lps, n);
    ``W`` drawn from ``g_a`` where given, else from ``g``."""
    a, b = _rows(g, (), lps, m, n, dtype, device, g_w=g_a)
    c = _uniform(g, (lps, n), 0.1, 1.0, dtype, device)
    return a, b, c
