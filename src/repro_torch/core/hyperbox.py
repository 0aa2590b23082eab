"""Closed-form hyperbox LP solver (paper Sec. 6): the hyperbox kernel's plain version.

Follows ``repro/core/hyperbox.py``.  When the feasible region is a box
``[lo_1, hi_1] x ... x [lo_n, hi_n]``, ``max l.x`` decomposes
coordinate-wise:

    rho_B(l) = sum_i l_i * (lo_i if l_i < 0 else hi_i)

This is the ``"torch"`` backend's box path, and the function the CUDA
kernel ``kernels/csrc/hyperbox.cu`` is held against.
"""

from __future__ import annotations

import torch

from .lp import OPTIMAL, LPSolution


def support(lo: torch.Tensor, hi: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Support values of box [lo, hi] in each direction: (..., n) -> (...)."""
    pick = torch.where(directions < 0, lo, hi)
    return (directions * pick).sum(dim=-1)


def argsupport(lo, hi, directions):
    """Support values and the maximizing vertex."""
    pick = torch.where(directions < 0, lo, hi)
    return (directions * pick).sum(dim=-1), pick


def solve_batched(lo, hi, directions) -> LPSolution:
    """LPSolution-shaped wrapper so the public solver API is uniform."""
    obj, x = argsupport(lo, hi, directions)
    bsz = obj.shape[0]
    return LPSolution(
        objective=obj,
        x=x,
        status=torch.full((bsz,), OPTIMAL, dtype=torch.int32, device=obj.device),
        iterations=torch.zeros((bsz,), dtype=torch.int32, device=obj.device),
    )
