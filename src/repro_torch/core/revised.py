"""Batched revised simplex over a SHARED constraint matrix: the revised kernel's plain version.

Follows ``repro/core/revised.py``.  For support sweeps, reachability and
scenario analysis, thousands of LPs share one ``A`` and differ only in
``c`` and/or ``b``.  Per LP this engine keeps only

* ``basis`` (m,) basis column IDs (the tableau path's convention),
* ``binv`` (m, m) basis inverse, kept by the rank-1 product-form update
  the tableau pivot applies to its columns,
* ``xb`` (m,) current basic solution,
* ``phase`` the two-phase flag,

and prices the reduced-cost row afresh every iteration against the one
``A``.  Rows with ``b_i < 0`` are negated up front (``sgn = -1``,
artificial basic), so the cold basis matrix is the identity and
``binv = I``.

This is the ``"torch-shared"`` backend, and through
``kernels/revised_cuda.py:revised_plain`` the reference the CUDA
kernel ``kernels/csrc/revised.cu`` is held against bit for bit on the
card.  The determinism rules that make that hold:

* every product and sum is its own rounded operation (no fused
  multiply-add; the kernel is built with ``-fmad=false``);
* every contraction (``y = c_B . B^-1``, the pricing ``(y . sgn) . A``,
  the entering column ``u = B^-1 . me``, the phase-I value and the final
  objective) is summed over its inner index in ascending order, one
  multiply and one add per term (:func:`_contract`; no ``bmm``,
  ``einsum`` or ``torch.sum``, whose order is unspecified);
* every arg-reduction breaks ties toward the lowest index;
* ``tol``, ``BIG`` and the feasibility threshold are compared in the
  tensors' dtype.

One deliberate difference from the reference: the reduced costs of the
basic columns are set to 0 before the entering choice.  They are 0 in
exact arithmetic, but priced afresh they are rounding noise, and in
float32 that noise can exceed ``tol`` and let a basic column enter
(a wasted pivot that changes the trajectory; ROADMAP queue 3 names the
fixtures).

The reference's while-loop becomes a Python loop with one host check per
step, and its ``lax.scan`` sweep a Python loop over steps.  A finished LP
is frozen by masking, so the kernel, which runs each LP in its own thread
block until it stops (and a whole sweep's steps in one launch), gives the
same result.  Resumed rounds whose caps
sum to K end bit-identical to one solve at cap K.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import engine
from .engine import LPC, RPC
from .lp import INFEASIBLE, ITER_LIMIT, OPTIMAL, RUNNING, UNBOUNDED, LPSolution
from .simplex import resolve_cap


@dataclasses.dataclass(frozen=True)
class RevisedResumeState:
    """Interrupted revised-simplex state: O(m^2) per LP.

    The shared ``A`` is not carried: a resume passes the canonical arrays
    back in, as it does ``b`` and ``c``.
    """

    binv: torch.Tensor  # (B, m, m) basis inverse in the signed system
    basis: torch.Tensor  # (B, m) int32 basis column IDs
    xb: torch.Tensor  # (B, m) basic solution (>= 0)
    phase: torch.Tensor  # (B,) int32 simplex phase (1 or 2)

    @property
    def batch(self) -> int:
        return self.basis.shape[0]

    def take(self, idx) -> "RevisedResumeState":
        """Gather state rows (a slice or an index tensor)."""
        return RevisedResumeState(self.binv[idx], self.basis[idx], self.xb[idx], self.phase[idx])


@dataclasses.dataclass(frozen=True)
class _RState:
    binv: torch.Tensor
    basis: torch.Tensor
    xb: torch.Tensor
    phase: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    step: int


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def state_bytes_per_lp(m: int, n: int, dtype=torch.float32) -> int:
    """Resident iteration-state bytes per LP: binv + xb floats, basis + phase ints."""
    return (m * m + m) * _itemsize(dtype) + (m + 1) * 4


def stored_bytes_per_lp(m: int, n: int, batch: int, dtype=torch.float32) -> float:
    """Stored problem-data bytes per LP: one shared ``A`` amortized over B rows."""
    return (m * n / batch + m + n) * _itemsize(dtype)


def _signs(b: torch.Tensor, dtype) -> torch.Tensor:
    """(B, m) row signs: -1 on b < 0 rows (negated, artificial basic), +1 else."""
    return torch.where(b < 0, -1.0, 1.0).to(dtype)


def _contract(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum_k x[..., k] * y[..., k]``, k ascending, one multiply and one add per term.

    The order the CUDA kernel sums every contraction in; the operands
    broadcast over their leading axes.
    """
    shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    acc = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k] * y[..., k]
    return acc


def _cold_state(a: torch.Tensor, b: torch.Tensor) -> RevisedResumeState:
    """The all-slack/artificial start: basis matrix = I, so binv = I, xb = |b|.

    ``binv`` is a fresh contiguous (B, m, m) tensor: the kernel updates it
    in place.
    """
    bsz, m = b.shape
    n = a.shape[1]
    dtype, dev = a.dtype, a.device
    neg = b < 0
    row_ids = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    basis = torch.where(neg, 1 + n + m + row_ids, 1 + n + row_ids).to(torch.int32)
    binv = torch.eye(m, dtype=dtype, device=dev).expand(bsz, m, m).contiguous()
    xb = _signs(b, dtype) * b
    phase = torch.where(neg.any(dim=1), 1, 2).to(torch.int32)
    return RevisedResumeState(binv, basis, xb, phase)


def _warm_state(
    a: torch.Tensor, b: torch.Tensor, basis0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factorize a proposed basis: ``(binv, basis, xb, ok)``.

    A row is accepted when every ID is in range (1..n+m, no artificials),
    the factorization succeeds (``solve_ex``'s ``info`` is 0) and is
    finite, and the basic solution is primal feasible; the caller
    overlays the cold start elsewhere.  The basis matrix is assembled in
    the unsigned system ``[A|I]`` from the one shared ``A`` and its
    inverse moved into the signed system by column scaling
    (``(S B)^-1 = B^-1 S``).
    """
    bsz, m = b.shape
    n = a.shape[1]
    dtype, dev = a.dtype, a.device
    basis0 = basis0.to(device=dev, dtype=torch.int32)
    in_range = (basis0 >= 1) & (basis0 <= n + m)
    safe = torch.where(in_range, basis0, 1).to(torch.int32)
    ai = torch.cat([a, torch.eye(m, dtype=dtype, device=dev)], dim=1)  # (m, n+m) shared
    cols = torch.index_select(ai, 1, (safe.to(torch.int64) - 1).reshape(-1))  # (m, B*m)
    bmat = cols.reshape(m, bsz, m).permute(1, 0, 2)  # (B, m, m): column k = ai[:, safe[k]-1]
    eye = torch.eye(m, dtype=dtype, device=dev).expand(bsz, m, m)
    binv_u, info = torch.linalg.solve_ex(bmat, eye)
    xb = (binv_u @ b[..., None])[..., 0]
    binv = binv_u * _signs(b, dtype)[:, None, :]
    feas_tol = engine._const(1e-9 if dtype == torch.float64 else 1e-6, b) * torch.clamp(
        b.abs().amax(dim=-1), min=1.0
    )
    finite = torch.isfinite(binv_u).all(dim=2).all(dim=1) & torch.isfinite(xb).all(dim=-1)
    feasible = (xb >= -feas_tol[:, None]).all(dim=-1)
    ok = in_range.all(dim=-1) & (info == 0) & finite & feasible
    binv = torch.where(torch.isfinite(binv), binv, torch.zeros_like(binv))
    xb = torch.clamp(torch.where(torch.isfinite(xb), xb, torch.zeros_like(xb)), min=0.0)
    return binv, safe, xb, ok


def _overlay(ok: torch.Tensor, warm: RevisedResumeState, cold: RevisedResumeState):
    """``warm`` where ``ok`` (entering phase II), ``cold`` elsewhere.

    Fresh contiguous tensors (``solve_ex`` may hand back a column-major
    inverse): the kernel updates them in place.
    """
    return RevisedResumeState(
        torch.where(ok[:, None, None], warm.binv, cold.binv).contiguous(),
        torch.where(ok[:, None], warm.basis, cold.basis).contiguous(),
        torch.where(ok[:, None], warm.xb, cold.xb).contiguous(),
        torch.where(ok, 2, cold.phase).to(torch.int32),
    )


def init_traced(a, b, basis0: Optional[torch.Tensor]) -> RevisedResumeState:
    """Iteration-0 state: cold start with the warm overlay where the basis is accepted."""
    cold = _cold_state(a, b)
    if basis0 is None:
        return cold
    wbinv, wbasis, wxb, ok = _warm_state(a, b, basis0)
    return _overlay(ok, RevisedResumeState(wbinv, wbasis, wxb, cold.phase), cold)


def init_batched(a, b, c, basis0: Optional[torch.Tensor] = None) -> RevisedResumeState:
    """The iteration-0 :class:`RevisedResumeState` (``c`` unused; signature parity)."""
    del c
    return init_traced(a, b, basis0)


def _basic_costs(basis, phase, c, m: int, n: int) -> torch.Tensor:
    """(B, m) cost of each basic variable under the CURRENT phase.

    Phase I: -1 per basic artificial (ID >= 1+n+m), -0 else (the
    negated 0/1 mask, as the reference computes it).  Phase II: ``c[j]``
    for original variables, 0 for slacks and for a still-basic
    degenerate artificial.
    """
    cb1 = -(basis >= 1 + n + m).to(c.dtype)
    is_var = (basis >= 1) & (basis <= n)
    cvals = torch.gather(c, 1, torch.clamp(basis.to(torch.int64) - 1, 0, n - 1))
    cb2 = torch.where(is_var, cvals, torch.zeros_like(cvals))
    return torch.where((phase == 1)[:, None], cb1, cb2)


def iteration_step(a, b, c, sgn, feas_tol, elig, s: _RState, *, rule: str, tol: float,
                   seed: int, row0: int = 0) -> _RState:
    """One lockstep revised-simplex iteration over the whole batch."""
    m, n = a.shape
    bsz = b.shape[0]
    dtype, dev = a.dtype, a.device
    q = 1 + n + m
    art_start = 1 + n + m
    row_ids = torch.arange(m, device=dev)[None, :]
    tol_t = engine._const(tol, a)
    ar = torch.arange(bsz, device=dev)

    active = s.status == RUNNING
    p1 = s.phase == 1

    # Pricing: y = c_B . B^-1, then the one shared A.
    cb = _basic_costs(s.basis, s.phase, c, m, n)
    y = _contract(cb[:, None, :], s.binv.transpose(1, 2))  # (B, m)
    w = y * sgn
    priced = _contract(w[:, None, :], a.t()[None])  # (B, n)
    r_vars = torch.where(p1[:, None], torch.zeros_like(c), c) - priced
    r_slack = -w
    obj0 = -_contract(cb, s.xb)  # the tableau's -z slot
    objrow = torch.cat([obj0[:, None], r_vars, r_slack], dim=1)
    # A basic column's reduced cost is 0 in exact arithmetic; priced afresh
    # it is rounding noise that may exceed tol, so it is set to 0.
    is_basic = torch.zeros((bsz, q + m), dtype=torch.bool, device=dev)
    is_basic.scatter_(1, s.basis.to(torch.int64), True)
    objrow = torch.where(is_basic[:, :q], torch.zeros_like(objrow), objrow)

    noise = engine.rpc_noise(seed, s.step, row0, bsz, q, dtype, dev) if rule == RPC else None
    e, max_c = engine.select_entering(objrow, elig, rule, tol, noise)
    at_opt = max_c <= tol_t

    # Phase transition: pricing is recomputed from (basis, phase) next step.
    p1_done = active & at_opt & p1
    feasible = obj0 <= feas_tol
    status = torch.where(p1_done & ~feasible, INFEASIBLE, s.status).to(torch.int32)
    status = torch.where(active & at_opt & (s.phase == 2), OPTIMAL, status).to(torch.int32)
    new_phase = torch.where(p1_done & feasible, 2, s.phase).to(torch.int32)

    # Entering column u = B^-1 . (S M_e): one column of A or a slack one-hot.
    e64 = e.to(torch.int64)
    col_a = torch.index_select(a, 1, torch.clamp(e64 - 1, 0, n - 1)).t()  # (B, m)
    col_s = (row_ids == torch.clamp(e64 - 1 - n, 0, m - 1)[:, None]).to(dtype)
    me = sgn * torch.where((e64 <= n)[:, None], col_a, col_s)
    u = _contract(s.binv, me[:, None, :])  # (B, m)

    # Ratio test: engine.ratio_test's formulas on (u, xb).
    big = engine._const(engine.BIG, a)
    pos = u > tol_t
    ratios = torch.where(pos, s.xb / torch.where(pos, u, torch.ones_like(u)), big)
    art_escape = (s.basis >= art_start) & (s.xb <= tol_t) & (u < -tol_t)
    ratios = torch.where(art_escape, torch.zeros_like(ratios), ratios)
    l = ratios.argmin(dim=-1)
    min_ratio = ratios.amin(dim=-1)

    pivoting = active & ~at_opt
    unbounded = pivoting & (min_ratio >= engine._const(engine.BIG / 2, a))
    status = torch.where(unbounded, UNBOUNDED, status).to(torch.int32)
    do_pivot = pivoting & ~unbounded

    # Rank-1 product-form update of binv and xb (engine.pivot_update's formulas).
    pe = u[ar, l]
    safe_pe = torch.where(pe.abs() > tol_t, pe, torch.ones_like(pe))
    npr = s.binv[ar, l, :] / safe_pe[:, None]
    l_rows = row_ids == l[:, None]
    upd_binv = torch.where(l_rows[:, :, None], npr[:, None, :],
                           s.binv - u[:, :, None] * npr[:, None, :])
    npx = s.xb[ar, l] / safe_pe
    upd_xb = torch.where(l_rows, npx[:, None], s.xb - u * npx[:, None])

    binv = torch.where(do_pivot[:, None, None], upd_binv, s.binv)
    xb = torch.where(do_pivot[:, None], upd_xb, s.xb)
    basis = torch.where(do_pivot[:, None] & l_rows, e[:, None], s.basis).to(torch.int32)
    iters = s.iters + do_pivot.to(torch.int32)
    return _RState(binv, basis, xb, new_phase, status, iters, s.step + 1)


def objective(basis, xb, c, status, fill: float = -float("inf")) -> torch.Tensor:
    """(B,) phase-II objective ``c_B . x_B`` at the terminal basis, ``fill`` where not OPTIMAL.

    Summed in ascending row order (:func:`_contract`); the kernel sums
    the same terms in the same order on its terminal state.
    """
    bsz, m = basis.shape
    n = c.shape[-1]
    phase2 = torch.full((bsz,), 2, dtype=torch.int32, device=basis.device)
    total = _contract(_basic_costs(basis, phase2, c, m, n), xb)
    return torch.where(status == OPTIMAL, total, engine._const(fill, xb))


def primal(basis, xb, status, n: int) -> torch.Tensor:
    """(B, n) primal point: each basic original's value in its slot, 0 where not OPTIMAL."""
    var_ids = torch.arange(1, n + 1, device=basis.device)[None, None, :]
    hit = basis[:, :, None] == var_ids
    x = torch.where(hit, xb[:, :, None], torch.zeros_like(xb)[:, :, None]).sum(dim=1)
    return torch.where((status == OPTIMAL)[:, None], x, torch.zeros_like(x))


def _iterate(a, b, c, state: RevisedResumeState, feas_tol, cap: int, seed: int, *,
             rule: str, tol: float):
    """The lockstep loop (cold and resume paths): ``(LPSolution, RevisedResumeState)``."""
    m, n = a.shape
    bsz = b.shape[0]
    dev = a.device
    sgn = _signs(b, a.dtype)
    elig = engine.eligible_mask(1 + n + m, m, n, dev)
    s = _RState(
        binv=state.binv, basis=state.basis.to(torch.int32), xb=state.xb,
        phase=state.phase.to(torch.int32),
        status=torch.full((bsz,), RUNNING, dtype=torch.int32, device=dev),
        iters=torch.zeros((bsz,), dtype=torch.int32, device=dev),
        step=0,
    )
    while s.step < cap:
        if not bool((s.status == RUNNING).any()):
            break
        s = iteration_step(a, b, c, sgn, feas_tol, elig, s, rule=rule, tol=tol, seed=seed)
    status = torch.where(s.status == RUNNING, ITER_LIMIT, s.status).to(torch.int32)
    sol = LPSolution(
        objective=objective(s.basis, s.xb, c, status),
        x=primal(s.basis, s.xb, status, n),
        status=status,
        iterations=s.iters,
        basis=s.basis,
    )
    return sol, RevisedResumeState(s.binv, s.basis, s.xb, s.phase)


def resolve_cap_tol(a, max_iters: int, tol: float):
    m, n = a.shape
    cap = resolve_cap(max_iters, m, n)
    return cap, (engine.default_tolerance(a.dtype) if tol <= 0.0 else tol)


def solve_batched(a, b, c, rule: str = LPC, max_iters: int = 0, seed: int = 0,
                  tol: float = 0.0, basis0: Optional[torch.Tensor] = None,
                  want_state: bool = False):
    """Solve B LPs (max c_k.x, A x <= b_k, x >= 0) over ONE shared ``a`` (m, n).

    The knobs of ``core/simplex.py:solve_batched``; ``basis0`` warm-starts
    with a per-row cold fallback.  Returns an ``LPSolution``, or
    ``(LPSolution, RevisedResumeState)`` with ``want_state``.
    """
    cap, tol = resolve_cap_tol(a, max_iters, tol)
    sol, state = _iterate(a, b, c, init_traced(a, b, basis0),
                          engine.phase1_feasibility_tol(b), cap, seed, rule=rule, tol=tol)
    return (sol, state) if want_state else sol


def resume_batched(a, b, c, state: RevisedResumeState, rule: str = LPC, max_iters: int = 0,
                   seed: int = 0, tol: float = 0.0, want_state: bool = True):
    """Continue a carried :class:`RevisedResumeState` for ``max_iters`` more steps.

    The shared ``a`` is passed back in; capped rounds summing to K are
    bit-identical to one solve at cap K.
    """
    cap, tol = resolve_cap_tol(a, max_iters, tol)
    sol, out = _iterate(a, b, c, state, engine.phase1_feasibility_tol(b), cap, seed,
                        rule=rule, tol=tol)
    return (sol, out) if want_state else sol


# ---------------------------------------------------------------------------
# Warm objective sweep: one (A, b), a stack of cost vectors
# ---------------------------------------------------------------------------

StepFn = Callable[[torch.Tensor, RevisedResumeState], Tuple[LPSolution, RevisedResumeState]]


def sweep_loop(a, b, c_stack, step: StepFn, warm: bool = True):
    """The sweep's carry over steps, around one solve per step.

    ``step(c_t, start)`` solves the batch for cost rows ``c_t`` from the
    iteration-0 state ``start`` (fresh tensors it may update in place).
    Each step starts from the previous step's terminal state on rows
    that ended OPTIMAL (``b`` never changes, so that basis stays primal
    feasible and enters phase II) and cold elsewhere.  Returns
    ``(objective, x, status, iterations)``, each with a leading (T, B).
    """
    cold = _cold_state(a, b)
    ok = torch.zeros((b.shape[0],), dtype=torch.bool, device=b.device)
    state = cold
    outs = []
    for c_t in c_stack:
        sol, state = step(c_t, _overlay(ok, state, cold))
        ok = sol.status == OPTIMAL if warm else torch.zeros_like(ok)
        outs.append((sol.objective, sol.x, sol.status, sol.iterations))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def sweep_batched(a, b, c_stack, rule: str = LPC, max_iters: int = 0, seed: int = 0,
                  tol: float = 0.0, warm: bool = True):
    """Solve a (T, B, n) stack of objectives over ONE ``(A, b)`` system.

    The support-sweep inner loop (``Polytope.support_sweep``): with
    ``warm=True`` each step restarts from the previous direction's
    optimal basis where one exists.  Returns ``(objective, x, status,
    iterations)``, each with a leading (T, B).
    """
    cap, tol = resolve_cap_tol(a, max_iters, tol)
    feas = engine.phase1_feasibility_tol(b)

    def step(c_t, start):
        return _iterate(a, b, c_t, start, feas, cap, seed, rule=rule, tol=tol)

    return sweep_loop(a, b, c_stack, step, warm)
