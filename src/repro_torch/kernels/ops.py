"""Solver entry points over the CUDA kernels.

Follows ``repro/kernels/ops.py``: the simplex, revised, PDHG and
hyperbox wrappers.  The tableau (``core/tableau.py:build_tableau``), the
revised start state (``core/revised.py:init_traced``) and the PDHG step
sizes (``core/pdhg.py:step_sizes``) are computed by the plain code and
handed to the kernels unpadded: the TPU's 128-lane/8-sublane padding,
VMEM budget and batch tiling do not carry over (one thread block per LP
takes every shape).  On CPU tensors the
same calls run the kernels' plain versions, as the reference's wrappers
run Pallas in interpret mode off the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import engine
from ..core import pdhg as _pdhg
from ..core import revised as _revised
from ..core.lp import LPSolution, ResumeState
from ..core.simplex import phase2_costs, resolve_cap
from ..core.tableau import DEFAULT_LAYOUT, TableauSpec, build_tableau
from . import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda


def _launch(tab, basis, phase, b, c, spec: TableauSpec, rule, max_iters, seed, tol,
            want_state: bool):
    if tol <= 0.0:
        tol = engine.default_tolerance(tab.dtype)
    c_ext = phase2_costs(c, spec)
    feas = engine.phase1_feasibility_tol(b).contiguous()
    cap = resolve_cap(max_iters, spec.m, spec.n)
    obj, x, status, iters = simplex_cuda.simplex(
        tab, basis, phase, c_ext, feas, cap, spec=spec, rule=rule, seed=seed, tol=tol
    )
    sol = LPSolution(objective=obj, x=x, status=status, iterations=iters, basis=basis)
    if not want_state:
        return sol
    return sol, ResumeState(tab, basis, phase)


def simplex_solve(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    rule: str = engine.LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    basis0: Optional[torch.Tensor] = None,
    want_state: bool = False,
    layout: str = DEFAULT_LAYOUT,
):
    """Solve a batch (max c.x, Ax <= b, x >= 0) with the simplex kernel.

    Same knobs and results as ``core/simplex.py:solve_batched``.  The
    kernel pivots the freshly built tableau in place, so ``want_state``
    (returning ``(LPSolution, ResumeState)``) costs nothing.
    """
    _, m, n = a.shape
    spec = TableauSpec(m, n, layout)
    tab, basis, phase = build_tableau(a, b, c, basis0, spec)
    return _launch(tab.contiguous(), basis.contiguous(), phase.contiguous(), b, c, spec,
                   rule, max_iters, seed, tol, want_state)


def simplex_resume(
    b: torch.Tensor,
    c: torch.Tensor,
    state: ResumeState,
    rule: str = engine.LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    want_state: bool = True,
):
    """Continue a carried :class:`ResumeState` for ``max_iters`` more steps.

    The same launch as a cold solve, on a copy of the state (the caller's
    state is left as it was).  Rounds whose caps sum to K end
    bit-identical to one solve at cap K.
    """
    m = state.basis.shape[1]
    n = c.shape[-1]
    spec = TableauSpec.from_tableau(m, n, state.tab.shape[-1])
    return _launch(
        state.tab.clone(memory_format=torch.contiguous_format),
        state.basis.to(torch.int32).clone(memory_format=torch.contiguous_format),
        state.phase.to(torch.int32).clone(memory_format=torch.contiguous_format),
        b, c, spec, rule, max_iters, seed, tol, want_state,
    )


def _revised_launch(a, b, c, state: _revised.RevisedResumeState, cap: int, rule, seed, tol,
                    want_state: bool):
    """One revised-kernel launch on ``state``'s buffers, updated in place.

    The objective is computed after the launch from the terminal
    ``(basis, xb)`` by the same ascending sum as the plain loop.
    """
    binv, basis, xb, phase = (t.contiguous() for t in
                              (state.binv, state.basis, state.xb, state.phase))
    feas = engine.phase1_feasibility_tol(b).contiguous()
    x, status, iters = revised_cuda.revised(a, b, c, binv, basis, xb, phase, feas, cap,
                                            rule=rule, seed=seed, tol=tol)
    sol = LPSolution(objective=_revised.objective(basis, xb, c, status), x=x, status=status,
                     iterations=iters, basis=basis)
    if not want_state:
        return sol
    return sol, _revised.RevisedResumeState(binv, basis, xb, phase)


def revised_solve(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    rule: str = engine.LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    basis0: Optional[torch.Tensor] = None,
    want_state: bool = False,
):
    """Solve a shared-A batch (``a`` (m, n), ``b`` (B, m), ``c`` (B, n)) with the revised kernel.

    Same knobs and results as ``core/revised.py:solve_batched``.
    ``basis0`` warm-starts through the same ``init_traced`` overlay (the
    factorization runs before the launch; warm rows enter the kernel in
    phase II).  The kernel updates the start state in place, so
    ``want_state`` (returning ``(LPSolution, RevisedResumeState)``) costs
    nothing.
    """
    cap, tol = _revised.resolve_cap_tol(a, max_iters, tol)
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    return _revised_launch(a, b, c, _revised.init_traced(a, b, basis0), cap, rule, seed, tol,
                           want_state)


def revised_resume(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    state: _revised.RevisedResumeState,
    rule: str = engine.LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    want_state: bool = True,
):
    """Continue a carried :class:`RevisedResumeState` for ``max_iters`` more steps.

    The shared ``a`` is passed back in.  The launch runs on a copy of the
    state (the caller's is left as it was); rounds whose caps sum to K
    end bit-identical to one solve at cap K.
    """
    cap, tol = _revised.resolve_cap_tol(a, max_iters, tol)
    copy = _revised.RevisedResumeState(
        state.binv.clone(memory_format=torch.contiguous_format),
        state.basis.to(torch.int32).clone(memory_format=torch.contiguous_format),
        state.xb.clone(memory_format=torch.contiguous_format),
        state.phase.to(torch.int32).clone(memory_format=torch.contiguous_format),
    )
    return _revised_launch(a.contiguous(), b.contiguous(), c.contiguous(), copy, cap, rule,
                           seed, tol, want_state)


def revised_sweep(
    a: torch.Tensor,
    b: torch.Tensor,
    c_stack: torch.Tensor,
    rule: str = engine.LPC,
    max_iters: int = 0,
    seed: int = 0,
    tol: float = 0.0,
    warm: bool = True,
):
    """``core/revised.py:sweep_batched`` on the kernel: one launch per step.

    Each step launches on the state carried from the step before, with
    the sweep's warm/cold overlay.  Returns ``(objective, x, status,
    iterations)``, each with a leading (T, B).
    """
    cap, tol = _revised.resolve_cap_tol(a, max_iters, tol)
    a, b = a.contiguous(), b.contiguous()

    def step(c_t, start):
        return _revised_launch(a, b, c_t.contiguous(), start, cap, rule, seed, tol, True)

    return _revised.sweep_loop(a, b, c_stack, step, warm)


def _pdhg_launch(a, b, c, state: _pdhg.PDHGResumeState, cap: int, tol: float, restart: int,
                 want_state: bool):
    """One PDHG-kernel launch on ``state``'s buffers, updated in place.

    The step sizes are computed here once, by the plain ``step_sizes``,
    as the reference's wrapper hoists them out of its kernel; the
    objective is computed after the launch by the same function as the
    plain loop's.
    """
    tau, sigma, scales = _pdhg.step_sizes(a, b, c)
    scales = tuple(s.contiguous() for s in scales)
    status, iters = pdhg_cuda.pdhg(a, b, c, state, tau.contiguous(), sigma.contiguous(), scales,
                                   cap, tol=_pdhg.resolve_tol(tol),
                                   restart=_pdhg.resolve_restart(restart))
    sol = LPSolution(objective=_pdhg.objective(c, state.x, status), x=state.x, status=status,
                     iterations=iters, y=state.y)
    return (sol, state) if want_state else sol


def pdhg_solve(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    tol: float = 0.0,
    restart: int = 0,
    max_iters: int = 0,
    want_state: bool = False,
):
    """Solve a canonical batch (max c.x, Ax <= b, x >= 0) with the PDHG kernel.

    Same knobs and results as ``core/pdhg.py:solve_batched`` (``y`` holds
    the dual point).  The kernel updates a fresh cold state in place, so
    ``want_state`` (returning ``(LPSolution, PDHGResumeState)``) costs
    nothing.
    """
    bsz, m, n = a.shape
    a, b, c = a.contiguous(), b.to(a.dtype).contiguous(), c.to(a.dtype).contiguous()
    state = _pdhg.init_state(bsz, m, n, a.dtype, a.device)
    return _pdhg_launch(a, b, c, state, _pdhg.resolve_cap(max_iters, m, n), tol, restart,
                        want_state)


def pdhg_resume(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    state: _pdhg.PDHGResumeState,
    *,
    tol: float = 0.0,
    restart: int = 0,
    max_iters: int = 0,
    want_state: bool = True,
):
    """Continue a carried :class:`PDHGResumeState` for ``max_iters`` more steps.

    The launch runs on a copy of the state (the caller's is left as it
    was); rounds whose caps sum to K end bit-identical to one launch at
    cap K.
    """
    _, m, n = a.shape
    a, b, c = a.contiguous(), b.to(a.dtype).contiguous(), c.to(a.dtype).contiguous()
    copy = _pdhg.PDHGResumeState(*(getattr(state, f.name).clone(
        memory_format=torch.contiguous_format) for f in dataclasses.fields(state)))
    return _pdhg_launch(a, b, c, copy, _pdhg.resolve_cap(max_iters, m, n), tol, restart,
                        want_state)


def hyperbox_support(lo, hi, directions) -> torch.Tensor:
    """Box support values via the hyperbox kernel: (B, n) -> (B,).

    ``lo``/``hi`` are (B, n), or one box (n,) or (1, n) that the kernel
    reads with row stride 0.
    """
    d = directions.contiguous()
    return hyperbox_cuda.hyperbox(lo.to(d.dtype).contiguous(), hi.to(d.dtype).contiguous(), d)
