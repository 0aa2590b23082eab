"""Persistent solve sessions and the dense warm-started sweep.

Follows ``repro/core/session.py``.

* :class:`SolveSession` pins one ``SolveOptions``, one
  :class:`~repro_torch.core.backends.SolveStats` record and optionally a
  device mesh for a traffic profile, and holds the serve loop's solver
  surface: the resolved
  options of a shape, the iteration-0 state of newly admitted LPs, and
  one capped continuation round.  In the port the counters
  ``compiles``/``cache_hits`` count kernel specialisations (kernel
  source x dtype x variant, ``kernels/build.py:SPECIALIZATIONS``): a
  call that used one for the first time in the process books it as a
  compile, any other call as a cache hit.  Nothing is compiled per
  shape or per cap, so after the first call of a traffic profile
  ``compiles`` stops moving.  The reference counts XLA executables
  (``jit._cache_size()``), which has no torch counterpart.

* :func:`sweep_problems` runs S steps over problems that differ only in
  their objective, each warm-started from the previous step's optimal
  basis.  The reference compiles the sweep into one ``lax.scan``; the
  port runs a device loop over the steps: each step is canonicalize ->
  the tableau warm from the previous basis -> one launch of the simplex
  kernel (``kernels/ops.py:simplex_resume``) -> uncanonicalize, and the
  statuses are read once, after the last step (no host sync in
  between; the LPs that need phase I are found once, before it).  The reference carries the previous step's terminal tableau
  and re-prices its objective row; the port rebuilds the tableau from the
  carried basis, as the per-step loop ``Polytope.step_sweep`` does, so
  the two give the same supports and pivots bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from . import dispatch as _dispatch
from . import spmd as _spmd
from .backends import SolveOptions, SolveStats, get_backend, kernel_cache_size
from .bucketing import ShapeGrid, next_pow2
from .lp import (OPTIMAL, LPBatch, LPSolution, ResumeState, SharedLPBatch, _tensor,
                 resolve_device)
from .problem import LPProblem, canonicalize, uncanonicalize
from .tableau import TableauSpec, build_tableau


def _on(value, device: torch.device):
    """``value`` (a problem, a batch, or a list of problems) with its tensors on ``device``."""
    if isinstance(value, (list, tuple)):
        return [_on(v, device) for v in value]
    return _spmd.to_device(value, device)


class SolveSession:
    """A pinned-options solve context whose counters show the steady state.

    Every call goes through the session's ``options`` and accumulates into
    its ``stats``.  The session runs on ``device`` (None = the card, which
    raises without one; pass ``device="cpu"`` for the CPU): problems and
    batches are moved there first.  With a ``mesh`` each rank solves its
    own rows on the mesh's device, and inputs stay where they are until
    a rank takes its rows.

    Parameters
    ----------
    options : SolveOptions, optional
        The configuration of every call.
    grid : sequence of (int, int), optional
        Pinned shape classes for list inputs (``core/bucketing.py``).
    stats : SolveStats, optional
        The record to accumulate into; a fresh one by default.
    device : str or torch.device, optional
        Where the session solves (under a ``mesh``, the mesh's device).
    mesh : DeviceMesh, optional
        Split every batch over the mesh's ``"data"`` axis.
    """

    def __init__(self, options: Optional[SolveOptions] = None, *, mesh=None,
                 grid: Optional[ShapeGrid] = None, stats: Optional[SolveStats] = None,
                 device=None):
        self.options = options or SolveOptions()
        self.grid = grid
        self.stats = stats if stats is not None else SolveStats()
        self.mesh = mesh
        self._split = _spmd.resolve_split(mesh, ("data",))
        self.device = self._split.device if self._split is not None else resolve_device(device)
        self._pinned: Dict[tuple, SolveOptions] = {}

    def _place(self, value):
        # Under a mesh a rank moves only its own rows (the dispatch does).
        return value if self._split is not None else _on(value, self.device)

    def solve(self, problem: Union[LPProblem, LPBatch, SharedLPBatch, Sequence[LPProblem]]
              ) -> Union[LPSolution, List[LPSolution]]:
        """Solve through the pinned configuration, recording into ``stats``."""
        from .. import api  # api imports this package

        return api.solve(self._place(problem), self.options, mesh=self.mesh, grid=self.grid,
                         stats=self.stats)

    def solve_hyperbox(self, lo, hi, directions) -> LPSolution:
        """Box-LP batch through the pinned configuration (paper Sec. 6)."""
        return _dispatch.solve_hyperbox(lo, hi, directions, self.options, stats=self.stats,
                                        device=self.device, mesh=self.mesh)

    # -- the serve loop's solver surface -------------------------------------

    def resolve_options(self, m: int, n: int, dtype, batch: Optional[int] = None
                        ) -> SolveOptions:
        """The pinned options with the open config knobs resolved for a shape.

        One resolution per shape class ``(m, n, dtype, next_pow2(batch))``,
        memoized for the session's lifetime, so every round of a class runs
        one concrete backend and the autotuner (``runtime/autotune.py``)
        prices (in trial mode, times) each class at most once per session.
        The decision is booked into the session's ``stats``.
        """
        key = (m, n, str(dtype), next_pow2(batch) if batch else 0)
        hit = self._pinned.get(key)
        if hit is None:
            hit = self._pinned[key] = _dispatch.resolve_backend(
                self.options, shape=(m, n), dtype=dtype, batch=batch, stats=self.stats,
                device=self.device, mesh=self.mesh if self._split is not None else None)
        return hit

    def init_state(self, batch, options: Optional[SolveOptions] = None, joining=None):
        """The iteration-0 resume state of a canonical batch (the splice input).

        Resuming it for K steps is bit-identical to a cold solve at cap K.
        ``options`` must name a concrete backend (default: the session's).
        Under a mesh the state is a ``ShardedState``: each new row goes to
        the least loaded rank beside ``joining`` (the in-flight state it
        will be spliced onto), and each rank builds its own rows' state.
        """
        options = options or self.options
        backend = get_backend(options.backend)
        if backend.init_canonical is None:
            raise ValueError(f"backend {backend.name!r} has no init_canonical hook; "
                             "it cannot splice new LPs into in-flight rounds")
        before = backend.cache_size() if backend.cache_size else None
        split = self._split
        if split is None:
            state = backend.init_canonical(_on(batch, self.device), options)
        else:
            owner = _spmd.assign_owners(split, joining, batch.batch)
            mine = np.nonzero(owner == split.block)[0]
            local, exc = None, None
            try:
                if mine.size:
                    rows = batch.take(torch.as_tensor(mine, device=batch.b.device))
                    local = backend.init_canonical(_spmd.to_device(rows, split.device), options)
            except Exception as err:  # agreed below: every rank raises
                exc = err
            state = _spmd.ShardedState(local, owner, split.block)
        grown = backend.cache_size() - before if before is not None else 0
        if split is not None:
            (grown,) = split.agree(exc, [grown])  # the same booking on every rank
        if before is not None:
            self.stats.record_cache(0, grown)
        return state

    def resume_round(self, batch, state, cap: int, options: Optional[SolveOptions] = None):
        """One capped continuation round: ``(LPSolution, new_state)``.

        Advances every LP of ``batch`` by at most ``cap`` ADDITIONAL
        iterations from ``state`` (row-aligned with ``batch``); the
        solution's iteration counts are the round's own.  The round runs
        through ``core/dispatch.py:dispatch_round_safe``: a transient
        failure re-dispatches it from the same state, up to
        ``options.retry_budget`` times, before the error reaches the
        caller (the serve loop then dead-letters the group).  The
        guardrails run on the way out when ``options.guardrails`` is on.
        """
        base = (options or self.options).replace(
            max_iters=int(cap), compaction="off", first_cap=None, resume="scratch")
        sol, out_state = _dispatch.dispatch_round_safe(self._place(batch), base,
                                                       self.stats, state=state,
                                                       want_state=True, mesh=self.mesh)
        if base.guardrails:
            sol = _dispatch.apply_guardrails(sol, out_state)
        self.stats.resumed += batch.batch
        return sol, out_state


# ---------------------------------------------------------------------------
# the dense warm-started sweep
# ---------------------------------------------------------------------------


def sweep_supported(options: SolveOptions) -> bool:
    """Whether :func:`sweep_problems` honours ``options``.

    The sweep drives the simplex solver of ``cuda`` (the kernel) or
    ``torch`` (the plain loop) directly, one uncompacted, unchunked round
    a step.  ``"auto"`` counts as ``cuda``: a sweep pivots from the last
    step's vertex, which a first-order method has none of.
    """
    return (options.backend in ("cuda", "torch", "auto") and options.compaction == "off"
            and options.first_cap is None and options.chunk_size is None)


def sweep_problems(template: LPProblem, c_stack, options: Optional[SolveOptions] = None,
                   stats: Optional[SolveStats] = None) -> torch.Tensor:
    """Warm-started sweep over problems that differ only in their objective.

    ``template`` is the step-0 problem batch (K LPs of any general form);
    every step reuses its rows, bounds and flags with ``c_stack[s]`` (S,
    K, n) as the objective.  Step s starts each LP from step s-1's basis
    where that step ended OPTIMAL, and cold elsewhere.  Returns the (S,
    K) objective values in user coordinates.  ``stats`` records per step
    what the per-step loop records (K LPs, one round, the pivots, the
    warm-started LPs) and the sweep's specialisations, read after the
    last step.  Raises ``ValueError`` if :func:`sweep_supported` fails.
    """
    options = options or SolveOptions()
    if not sweep_supported(options):
        raise ValueError("sweep_problems runs the uncompacted, unchunked simplex of "
                         "backend 'cuda', 'torch' or 'auto'; got incompatible options")
    options = options.replace(backend="torch" if options.backend == "torch" else "cuda")
    backend = get_backend(options.backend)
    c_stack = _tensor(c_stack, dtype=template.dtype, device=template.device)
    # Only c changes across the steps, so the LPs that need phase I are
    # found once, here: the one read-back before the last step.
    canon0 = canonicalize(template).batch
    spec = TableauSpec(canon0.m, canon0.n, options.effective_layout)
    phase1_rows = (canon0.b < 0).any(dim=1).nonzero().flatten()
    before = kernel_cache_size()
    basis = None
    objs, iters, warm = [], [], []
    for c_s in c_stack:
        canon = canonicalize(dataclasses.replace(template, c=c_s, basis0=basis))
        if basis is None:
            warm.append(torch.zeros((), dtype=torch.int64, device=c_s.device))
        else:
            warm.append((basis > 0).any(dim=-1).sum())
        # The tableau, warm from the carried basis, and one launch from it:
        # bit-identical to a cold solve with basis0 (the resume contract).
        cb = canon.batch
        start = ResumeState(*build_tableau(cb.a, cb.b, cb.c, cb.basis0, spec, phase1_rows))
        sol, _ = backend.resume_canonical(cb, start, options)
        if options.guardrails:
            sol = _dispatch.apply_guardrails(sol)
        out = uncanonicalize(canon, sol)
        # Carry only the bases of LPs that converged; 0 is out of range, so
        # the tableau build cold-starts the rest.
        basis = torch.where((sol.status == OPTIMAL)[:, None], sol.basis, 0)
        objs.append(out.objective)
        iters.append(sol.iterations)
    objs = torch.stack(objs)
    if stats is not None:
        stats.record_cache(before, kernel_cache_size())
        it = torch.stack(iters)
        steps, k = it.shape
        stats.lps += steps * k
        stats.rounds += steps
        stats.simplex_iterations += int(it.sum())
        stats.lockstep_iterations += int(it.amax(dim=1).sum()) * k
        stats.warm_started += int(torch.stack(warm).sum())
        stats.record_tableau(k * spec.bytes_per_lp(template.dtype))
    return objs


def sweep_polytope_supports(a, b, direction_stack, options: Optional[SolveOptions] = None,
                            stats: Optional[SolveStats] = None, device=None) -> torch.Tensor:
    """Support values of ``{x : Ax <= b, x free}`` over a (S, K, n) direction sweep.

    :func:`sweep_problems` on the polytope's support LPs; ``device=None``
    means the card.
    """
    from .support import Polytope

    poly = Polytope(a, b)
    template = poly.to_problem(direction_stack[0], device=device)
    return sweep_problems(template, direction_stack, options, stats)

