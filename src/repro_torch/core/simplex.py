"""Batched lockstep simplex in plain PyTorch: the simplex kernel's plain version.

Follows ``repro/core/simplex.py``.  One Python loop advances every LP of
the batch by one simplex iteration per step through the blocks of
``core/engine.py``; a finished LP is frozen by masking.  The loop stops
when no LP is RUNNING (one host check per step) or at the cap.

This is the ``"torch"`` backend, and through
``kernels/simplex_cuda.py:simplex_plain`` the reference the CUDA
kernel is held against: the kernel runs each LP in its own thread block
until it stops, which gives the same result because a finished LP is
frozen here and the RPC step counter is that LP's own loop index.

Two entry points: :func:`solve_batched` (build the tableau, iterate) and
:func:`resume_batched` (continue a carried
:class:`~repro_torch.core.lp.ResumeState`).  Resumed rounds whose caps
sum to K end bit-identical to one solve at cap K.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import engine
from .engine import BLAND, LPC, RPC  # noqa: F401  (re-exported API)
from .lp import (
    ITER_LIMIT,
    RUNNING,
    UNBOUNDED,
    LPSolution,
    ResumeState,
    auto_cap,
)
from .tableau import DEFAULT_LAYOUT, TableauSpec, build_tableau


def resolve_cap(max_iters: int, m: int, n: int) -> int:
    """The 0 -> auto cap rule shared by every solver entry point."""
    return auto_cap(m, n) if max_iters <= 0 else int(max_iters)


def phase2_costs(c: torch.Tensor, spec: TableauSpec) -> torch.Tensor:
    """(B, spec.q) extended phase-II cost row (zeros outside columns 1..n)."""
    bsz, n = c.shape
    c_ext = torch.zeros((bsz, spec.q), dtype=c.dtype, device=c.device)
    c_ext[:, 1 : 1 + n] = c
    return c_ext


def _iterate(tab, basis, phase, c_ext, feas_tol, cap, seed, *, spec, rule, tol):
    """The lockstep loop shared by the cold and resume paths.

    Returns ``(LPSolution, ResumeState)``.
    """
    m, n = spec.m, spec.n
    bsz, _, q = tab.shape
    dtype, dev = tab.dtype, tab.device
    elig = engine.eligible_mask(q, m, n, dev)
    half_big = torch.tensor(engine.BIG / 2, dtype=dtype, device=dev)
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)

    status = torch.full((bsz,), RUNNING, dtype=torch.int32, device=dev)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    step = 0
    while step < cap:
        active = status == RUNNING
        if not bool(active.any()):
            break
        noise = (
            engine.rpc_noise(seed, step, 0, bsz, q, dtype, dev) if rule == RPC else None
        )
        e, max_c = engine.select_entering(tab[:, m, :], elig, rule, tol, noise)
        at_opt = max_c <= tol_t
        tab, phase, status = engine.phase_transition(
            tab, basis, phase, status, at_opt, c_ext, feas_tol, spec
        )
        pivoting = active & ~at_opt
        l, min_ratio, full_col = engine.ratio_test(tab, basis, e, spec, tol)
        unbounded = pivoting & (min_ratio >= half_big)
        status = torch.where(unbounded, torch.full_like(status, UNBOUNDED), status)
        do_pivot = pivoting & ~unbounded
        tab, basis = engine.pivot_update(
            tab, basis, e, l, full_col, do_pivot, spec, tol
        )
        iters = iters + do_pivot.to(torch.int32)
        step += 1

    status = torch.where(status == RUNNING, torch.full_like(status, ITER_LIMIT), status)
    objective, x = engine.extract_solution(tab, basis, status, spec, n, fill=-float("inf"))
    sol = LPSolution(objective=objective, x=x, status=status, iterations=iters, basis=basis)
    return sol, ResumeState(tab, basis, phase)


def init_batched(a, b, c, basis0=None, layout: str = DEFAULT_LAYOUT) -> ResumeState:
    """The iteration-0 :class:`ResumeState`: tableau built, nothing pivoted."""
    _, m, n = a.shape
    return ResumeState(*build_tableau(a, b, c, basis0, TableauSpec(m, n, layout)))


def solve_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    rule: str = LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    basis0: Optional[torch.Tensor] = None,
    want_state: bool = False,
    layout: str = DEFAULT_LAYOUT,
):
    """Solve a batch of LPs (max c.x, Ax <= b, x >= 0) in lockstep.

    ``max_iters`` 0 means ``50 (m + n)``; ``tol`` 0 means the dtype
    default; ``seed`` keys the RPC noise.  Returns an ``LPSolution``, or
    ``(LPSolution, ResumeState)`` with ``want_state``.
    """
    _, m, n = a.shape
    spec = TableauSpec(m, n, layout)
    if tol <= 0.0:
        tol = engine.default_tolerance(a.dtype)
    tab, basis, phase = build_tableau(a, b, c, basis0, spec)
    sol, state = _iterate(
        tab, basis, phase, phase2_costs(c, spec), engine.phase1_feasibility_tol(b),
        resolve_cap(max_iters, m, n), seed, spec=spec, rule=rule, tol=tol,
    )
    return (sol, state) if want_state else sol


def resume_batched(
    b: torch.Tensor,
    c: torch.Tensor,
    state: ResumeState,
    rule: str = LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    want_state: bool = True,
):
    """Continue a batch from a carried state for ``max_iters`` more steps.

    ``b``/``c`` are the canonical arrays of the interrupted solve (they
    re-derive the cost row and the feasibility threshold).  The layout
    comes from the carried tableau.
    """
    m = state.basis.shape[1]
    n = c.shape[-1]
    spec = TableauSpec.from_tableau(m, n, state.tab.shape[-1])
    if tol <= 0.0:
        tol = engine.default_tolerance(state.tab.dtype)
    sol, out_state = _iterate(
        state.tab, state.basis, state.phase, phase2_costs(c, spec),
        engine.phase1_feasibility_tol(b), resolve_cap(max_iters, m, n), seed,
        spec=spec, rule=rule, tol=tol,
    )
    return (sol, out_state) if want_state else sol
