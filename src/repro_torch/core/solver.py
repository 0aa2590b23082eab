"""Deprecated object-style solver API: a thin shim over ``repro_torch.solve``.

Follows ``repro/core/solver.py``.  New code should call::

    import repro_torch
    sol = repro_torch.solve(problem_or_batch, repro_torch.SolveOptions(...))

:class:`BatchedLPSolver` translates its constructor knobs into a
``SolveOptions`` and delegates to the dispatch layer, so its results are
those of the functional front door, ``mesh`` and ``batch_axes``
included (the batch split over a ``DeviceMesh``).  The reference's
``unroll`` has no counterpart in the port.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

from . import dispatch as _dispatch
from .backends import DEFAULT_BACKEND, SolveOptions
from .engine import LPC
from .lp import LPBatch, LPSolution


class BatchedLPSolver:
    """Deprecated shim: a batched LP solver; use ``repro_torch.solve`` instead."""

    def __init__(self, rule: str = LPC, max_iters: int = 0, chunk_size: Optional[int] = None,
                 mesh=None, batch_axes: Sequence[str] = ("data",),
                 backend: str = DEFAULT_BACKEND):
        warnings.warn(
            "BatchedLPSolver is deprecated; use repro_torch.solve(problem, "
            "options=repro_torch.SolveOptions(...)) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self.rule = rule
        self.max_iters = max_iters
        self.chunk_size = chunk_size
        self.mesh = mesh
        self.batch_axes = tuple(ax for ax in batch_axes
                                if mesh is not None and ax in mesh.mesh_dim_names)
        self.backend = backend
        self.options = SolveOptions(backend=backend, rule=rule, max_iters=max_iters,
                                    chunk_size=chunk_size)

    def solve(self, batch: LPBatch, seed: int = 0) -> LPSolution:
        options = self.options if seed == 0 else self.options.replace(seed=seed)
        return _dispatch.solve_canonical(batch, options, mesh=self.mesh,
                                         batch_axes=self.batch_axes)

    def solve_adaptive(self, batch: LPBatch, first_cap: int = 0, seed: int = 0) -> LPSolution:
        """The legacy two-pass solve: a round at ``first_cap`` (0 = ``8 (m + n)``),
        then the LPs still running at the full cap, with their counts continued."""
        return _dispatch.solve_canonical(
            batch, self.options.replace(first_cap=max(first_cap, 0), seed=seed),
            mesh=self.mesh, batch_axes=self.batch_axes)

    def solve_hyperbox(self, lo, hi, directions, device=None) -> LPSolution:
        return _dispatch.solve_hyperbox(lo, hi, directions, self.options, device=device,
                                        mesh=self.mesh, batch_axes=self.batch_axes)
