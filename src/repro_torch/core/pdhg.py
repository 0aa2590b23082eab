"""Batched restarted PDHG in plain PyTorch: the PDHG kernel's plain version.

Follows ``repro/core/pdhg.py``: the first-order backend for the shapes
the tableau simplex cedes (``max(m, n) >= 500``).  For the canonical
problem (``max c.x  s.t.  Ax <= b, x >= 0``; dual ``min b.y  s.t.
A'y >= c, y >= 0``) each step is the Chambolle-Pock update with
extrapolation on the primal,

    x+ = max(0, x + tau * (c - A'y))
    y+ = max(0, y + sigma * (A (2 x+ - x) - b)),

with PDLP's step sizes (``eta = 0.9 / ||A||_2`` by power iteration, split
by the primal weight ``||c|| / ||b||``), a fixed-period restart to the
running average, termination on relative KKT residuals against
``pdhg_tol``, and divergence certificates (a Farkas ray of a growing
iterate) checked at restart boundaries only.  The certificates are
heuristics; :func:`confirm_certificates` re-derives every flag on the
float64 oracle before it is reported, and :func:`crossover` polishes
OPTIMAL rows into exact vertices on the simplex kernel.

:func:`pdhg_step` keeps the reference's operations in the reference's
order.  :func:`iterate` is the lockstep loop: every LP of the batch
advances one step per iteration, a finished LP is frozen by masking, and
the loop stops at the cap or when no LP is RUNNING (one host check per
step; on the card the step is a replayed CUDA graph and the check comes
every 32 steps, with the same result).  It is the ``pdhg`` backend on CPU tensors and, through
``kernels/pdhg_cuda.py:pdhg_plain``, the version the CUDA kernel
(``kernels/csrc/pdhg.cu``) is held against.  The two are not
bit-identical: the matvecs here are ``torch.einsum`` (a library product
whose reduction order is its own), the kernel's are hand-written.  The
reference's Pallas kernel and its XLA loop differ the same way.

A chain of :func:`resume_batched` rounds whose caps sum to K ends
bit-identical to one solve at cap K: the loop carries everything it
needs in :class:`PDHGResumeState`, and a frozen row does not change.
"""

from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Tuple

import numpy as np
import torch

from .lp import (
    INFEASIBLE,
    ITER_LIMIT,
    OPTIMAL,
    RUNNING,
    UNBOUNDED,
    LPBatch,
    LPSolution,
    row_sum,
    row_tiles,
)

#: Default relative KKT tolerance when ``SolveOptions.pdhg_tol`` is 0.
#: 1e-4 is the "moderate accuracy" setting of PDLP/cuPDLP; pair with
#: ``crossover=True`` when exact vertices are required.
DEFAULT_PDHG_TOL = 1e-4

#: Default restart period when ``SolveOptions.pdhg_restart`` is 0.
DEFAULT_RESTART = 64

#: Power iterations for the per-LP ||A||_2 estimate.
POWER_ITERS = 24

#: Step-size safety factor: eta = STEP_SAFETY / ||A||_2 keeps
#: tau * sigma * ||A||^2 below 1 when the estimate slightly undershoots.
STEP_SAFETY = 0.9

#: Relative tolerance for the Farkas-ray feasibility of a normalized
#: diverging iterate (the certificate checks).
CERT_EPS = 1e-3

#: Iterate-norm threshold before a divergence certificate may fire.
DIVERGENCE_GUARD = 1e3

#: Fraction of the ideal per-period ray growth (``restart * step * eps *
#: scale``) an iterate must sustain between restart boundaries before a
#: divergence certificate may fire: a bounded LP with a large-norm
#: optimum plateaus there, a genuine ray keeps growing.
GROWTH_FRACTION = 0.25

_TINY = 1e-30


def auto_cap_pdhg(m: int, n: int) -> int:
    """The pdhg backend's iteration cap for ``max_iters <= 0``."""
    return max(20_000, 40 * (m + n))


def resolve_cap(max_iters: int, m: int, n: int) -> int:
    """``max_iters`` with the pdhg 0 -> auto rule applied."""
    return int(max_iters) if max_iters > 0 else auto_cap_pdhg(m, n)


def resolve_tol(tol: float) -> float:
    """``pdhg_tol`` with the 0 -> :data:`DEFAULT_PDHG_TOL` rule applied."""
    return tol if tol > 0.0 else DEFAULT_PDHG_TOL


def resolve_restart(restart: int) -> int:
    """``pdhg_restart`` with the 0 -> :data:`DEFAULT_RESTART` rule applied."""
    return restart if restart > 0 else DEFAULT_RESTART


def state_bytes_per_lp(m: int, n: int, dtype=torch.float32) -> int:
    """Resident bytes one LP costs the pdhg solver (problem data + state).

    A/b/c (``m n + m + n``), the iterate state of
    :class:`PDHGResumeState` (x and its running sum ``2n``; y, the cached
    ``A x`` and their running sums ``4m``; the two growth norms) and the
    int32 restart counter: O(m n) against the tableau's O(m (n + m)).
    """
    item = torch.empty((), dtype=dtype).element_size()
    return item * (m * n + m + n + 2 * n + 4 * m + 2) + 4


@dataclasses.dataclass(frozen=True)
class PDHGResumeState:
    """Mid-solve PDHG state, carried between rounds.

    Everything the loop carries, so a capped round continues EXACTLY.
    ``ax`` is the loop's cached ``A x`` (after a restart it is the
    averaged accumulator, not a fresh product); ``x_sum``/``y_sum``/
    ``ax_sum`` and ``inner`` make the restart schedule resume-invariant;
    ``x_grow``/``y_grow`` are the iterate norms at the last restart
    boundary, read by the certificates' growth gate.
    """

    x: torch.Tensor  # (B, n) primal iterate
    y: torch.Tensor  # (B, m) dual iterate
    ax: torch.Tensor  # (B, m) carried A @ x
    x_sum: torch.Tensor  # (B, n) running primal sum since last restart
    y_sum: torch.Tensor  # (B, m) running dual sum since last restart
    ax_sum: torch.Tensor  # (B, m) running A @ x sum since last restart
    inner: torch.Tensor  # (B,) int32 steps since last restart
    x_grow: torch.Tensor  # (B,) ||x|| at the last restart boundary
    y_grow: torch.Tensor  # (B,) ||y|| at the last restart boundary

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    def take(self, idx) -> "PDHGResumeState":
        """Gather state rows (a slice or an index tensor)."""
        return PDHGResumeState(*(getattr(self, f.name)[idx] for f in dataclasses.fields(self)))


def init_state(bsz: int, m: int, n: int, dtype, device=None) -> PDHGResumeState:
    """The cold-start state: x = 0, y = 0 (and A @ 0 = 0), fresh buffers."""

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return PDHGResumeState(
        x=z(bsz, n), y=z(bsz, m), ax=z(bsz, m),
        x_sum=z(bsz, n), y_sum=z(bsz, m), ax_sum=z(bsz, m),
        inner=torch.zeros((bsz,), dtype=torch.int32, device=device),
        x_grow=z(bsz), y_grow=z(bsz),
    )


# ---------------------------------------------------------------------------
# matvecs
# ---------------------------------------------------------------------------


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``A @ x``: (B, m, n), (B, n) -> (B, m)."""
    return torch.einsum("bmn,bn->bm", a, x)


def rmatvec(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched ``A' @ y``: (B, m, n), (B, m) -> (B, n)."""
    return torch.einsum("bmn,bm->bn", a, y)


def _l2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one rounded division (torch's ``float / tensor``
    multiplies by the reciprocal instead)."""
    return torch.div(torch.tensor(num, dtype=den.dtype, device=den.device), den)


def spectral_norm(a: torch.Tensor, iters: int = POWER_ITERS) -> torch.Tensor:
    """Per-LP ||A||_2 estimate by power iteration on ``A'A``.

    Deterministic (all-ones start), so every solve and every resumed
    round recomputes the same step sizes from the same ``A``.
    """
    bsz, _, n = a.shape
    v = torch.full((bsz, n), 1.0 / np.sqrt(n), dtype=a.dtype, device=a.device)
    for _ in range(iters):
        w = rmatvec(a, matvec(a, v))
        v = w / torch.clamp(_l2(w), min=_TINY)[:, None]
    return _l2(matvec(a, v))


#: Batch size of every step-size computation (``core/lp.py:row_tiles``).
#: The power iteration's batched products and norms are library calls,
#: which pick their algorithm by batch size on the card: the same row's
#: ``A x`` differed in its last bits between a batch of 3 and one of 256
#: (``tools/row_bits_probe.py``, H100).  In tiles of exactly this many
#: rows each LP's step sizes are a function of that LP alone, so a row
#: resumed in a serve-loop group of any size steps as it does in a
#: one-shot batch.  Summing the products by ``row_sum`` instead made the
#: step sizes of 64 LPs of 500x500 3.7x slower than these tiles, and the
#: compacted PDHG rounds of ``chip_smoke.py`` 2.7x (H100,
#: ``tools/row_local_cost.py``).  The reference has no such tile: XLA on
#: its devices reduces each row alike.
STEP_TILE = 64


def _step_sizes(a, b, c):
    anorm = spectral_norm(a)
    eta = _rdiv(STEP_SAFETY, torch.clamp(anorm, min=_TINY))
    bn = _l2(b)
    cn = _l2(c)
    omega = torch.where((bn > 1e-12) & (cn > 1e-12), cn / torch.clamp(bn, min=_TINY),
                        torch.ones_like(bn))
    omega = torch.clamp(omega, 1e-2, 1e2)
    return eta / omega, eta * omega, anorm, 1.0 + bn, 1.0 + cn


def step_sizes(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Per-LP ``(tau, sigma, (anorm, bscale, cscale))``.

    ``tau * sigma = (STEP_SAFETY / ||A||)^2``; the primal weight
    ``omega = ||c|| / ||b||`` (clipped to [1e-2, 1e2], 1 when degenerate)
    splits the product.  Computed in tiles of :data:`STEP_TILE` rows.  On
    the card the matvecs are float32 products: TF32 must stay off.
    """
    rows = torch.arange(a.shape[0], device=a.device)
    parts = [[t[:real] for t in _step_sizes(a[idx], b[idx], c[idx])]
             for idx, real in row_tiles(rows, STEP_TILE)] or [_step_sizes(a, b, c)]
    tau, sigma, anorm, bscale, cscale = (torch.cat(ts) for ts in zip(*parts))
    return tau, sigma, (anorm, bscale, cscale)


# ---------------------------------------------------------------------------
# one step, and the lockstep loop
# ---------------------------------------------------------------------------


def pdhg_step(a, b, c, x, y, ax, x_sum, y_sum, ax_sum, inner, x_grow, y_grow, status, iters,
              tau, sigma, scales, *, tol: float, restart: int, mv: Callable = matvec,
              rmv: Callable = rmatvec):
    """One lockstep PDHG iteration over a batch.

    (1) the termination and certificate checks on the CURRENT iterate,
    from the cached ``ax`` and this step's ``A'y``; (2) the prox steps;
    (3) the restart-to-average bookkeeping.  Rows whose status left
    RUNNING are frozen everywhere.  Everything is per-LP arithmetic.
    """
    anorm, bscale, cscale = scales
    active = status == RUNNING
    aty = rmv(a, y)

    # --- (1) termination: relative KKT residuals on (x, y)
    pres = _l2(torch.clamp_min(ax - b, 0.0)) / bscale
    dres = _l2(torch.clamp_min(c - aty, 0.0)) / cscale
    pobj = torch.sum(c * x, dim=-1)
    dobj = torch.sum(b * y, dim=-1)
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    opt = (pres <= tol) & (dres <= tol) & (gap <= tol)

    # --- certificates, at restart boundaries only, gated on growth
    xnorm = _l2(x)
    ynorm = _l2(y)
    at_period = inner + 1 >= restart
    ray_eps = CERT_EPS * torch.clamp(anorm, min=1.0)
    dual_ray = torch.amax(torch.clamp_min(-aty, 0.0), dim=-1) / torch.clamp(ynorm, min=_TINY)
    infeas = (
        at_period
        & (ynorm >= DIVERGENCE_GUARD)
        & (ynorm - y_grow >= GROWTH_FRACTION * restart * sigma * CERT_EPS * bscale)
        & (dual_ray <= ray_eps)
        & (dobj / torch.clamp(ynorm, min=_TINY) <= -CERT_EPS * bscale)
    )
    prim_ray = torch.amax(torch.clamp_min(ax, 0.0), dim=-1) / torch.clamp(xnorm, min=_TINY)
    unbounded = (
        at_period
        & (xnorm >= DIVERGENCE_GUARD)
        & (xnorm - x_grow >= GROWTH_FRACTION * restart * tau * CERT_EPS * cscale)
        & (prim_ray <= ray_eps)
        & (pobj / torch.clamp(xnorm, min=_TINY) >= CERT_EPS * cscale)
        & (pres <= CERT_EPS)
    )

    status = torch.where(active & opt, OPTIMAL, status)
    status = torch.where(active & ~opt & infeas, INFEASIBLE, status)
    status = torch.where(active & ~opt & ~infeas & unbounded, UNBOUNDED, status).to(torch.int32)

    live = status == RUNNING
    iters = iters + live.to(torch.int32)

    # --- (2) prox steps
    x1 = torch.clamp_min(x + tau[:, None] * (c - aty), 0.0)
    ax1 = mv(a, x1)
    y1 = torch.clamp_min(y + sigma[:, None] * (2.0 * ax1 - ax - b), 0.0)

    # --- (3) restart-to-average bookkeeping
    cnt = inner + 1
    xs1 = x_sum + x1
    ys1 = y_sum + y1
    axs1 = ax_sum + ax1
    do_restart = cnt >= restart
    denom = cnt.to(x.dtype)[:, None]
    dr = do_restart[:, None]
    x2 = torch.where(dr, xs1 / denom, x1)
    y2 = torch.where(dr, ys1 / denom, y1)
    ax2 = torch.where(dr, axs1 / denom, ax1)
    xs2 = torch.where(dr, torch.zeros_like(xs1), xs1)
    ys2 = torch.where(dr, torch.zeros_like(ys1), ys1)
    axs2 = torch.where(dr, torch.zeros_like(axs1), axs1)
    inner2 = torch.where(do_restart, torch.zeros_like(cnt), cnt)
    xg2 = torch.where(do_restart, xnorm, x_grow)
    yg2 = torch.where(do_restart, ynorm, y_grow)

    # Freeze finished rows.
    lv = live[:, None]
    x = torch.where(lv, x2, x)
    y = torch.where(lv, y2, y)
    ax = torch.where(lv, ax2, ax)
    x_sum = torch.where(lv, xs2, x_sum)
    y_sum = torch.where(lv, ys2, y_sum)
    ax_sum = torch.where(lv, axs2, ax_sum)
    inner = torch.where(live, inner2, inner).to(torch.int32)
    x_grow = torch.where(live, xg2, x_grow)
    y_grow = torch.where(live, yg2, y_grow)
    return x, y, ax, x_sum, y_sum, ax_sum, inner, x_grow, y_grow, status, iters


def objective(c: torch.Tensor, x: torch.Tensor, status: torch.Tensor) -> torch.Tensor:
    """``c . x`` where OPTIMAL, else -inf: the same for the kernel and the loop.

    ``core/lp.py:row_sum``, so a row's objective does not depend on the
    rows of its launch.
    """
    pobj = row_sum(c * x)
    return torch.where(status == OPTIMAL, pobj, torch.full_like(pobj, -math.inf))


def iterate_with(a, b, c, state: PDHGResumeState, cap: int, tau, sigma, scales, *, tol: float,
                 restart: int, graph: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, PDHGResumeState]:
    """Up to ``cap`` ADDITIONAL lockstep steps from ``state`` with given step sizes.

    Returns ``(status, iters, state)``; rows still RUNNING at the cap
    report ITER_LIMIT.  On the card the loop replays one captured step
    (:func:`_replay_loop`); ``graph=False`` runs it eagerly, as on the
    CPU, with the same bits.
    """
    bsz = a.shape[0]
    status = torch.full((bsz,), RUNNING, dtype=torch.int32, device=a.device)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=a.device)
    carry = tuple(getattr(state, f.name) for f in dataclasses.fields(state))

    def step(*loop):
        return pdhg_step(a, b, c, *loop, tau, sigma, scales, tol=tol, restart=restart)

    loop = _replay_loop if a.is_cuda and graph else _eager_loop
    *carry, status, iters = loop(step, (*carry, status, iters), int(cap))
    status = torch.where(status == RUNNING, ITER_LIMIT, status).to(torch.int32)
    return status, iters, PDHGResumeState(*carry)


def _eager_loop(step, loop, cap: int):
    """``step`` until no row is RUNNING (``loop[-2]`` is the status) or ``cap``."""
    for _ in range(cap):
        if not bool((loop[-2] == RUNNING).any()):
            break
        loop = step(*loop)
    return loop


#: Steps the graphed loop replays between two host checks for RUNNING rows.
GRAPH_CHECK_EVERY = 32


_GRAPH_STREAMS = {}


def _graph_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for every capture: the library keeps a
    workspace for each stream it has seen, so a new stream per call would
    leave one behind each time."""
    if device not in _GRAPH_STREAMS:
        _GRAPH_STREAMS[device] = torch.cuda.Stream(device=device)
    return _GRAPH_STREAMS[device]


def _replay_loop(step, loop, cap: int):
    """The lockstep loop on the card: one step captured as a CUDA graph.

    An eager step is about a hundred small launches, which the host
    issues slower than the card runs them; replaying a captured step
    runs the same kernels on the same buffers.  The host checks for
    RUNNING rows every :data:`GRAPH_CHECK_EVERY` steps instead of every
    step: once every row is frozen a step changes nothing, so the result
    is the same bits as the eager loop's.
    """
    static = [t.clone() for t in loop]
    dev = static[0].device
    side = _graph_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step(*static)  # warm-up outside the capture (library handles, workspaces)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for dst, src in zip(static, step(*static)):
            dst.copy_(src)
    done = 0
    while done < cap and bool((static[-2] == RUNNING).any()):
        for _ in range(min(GRAPH_CHECK_EVERY, cap - done)):
            graph.replay()
        done += min(GRAPH_CHECK_EVERY, cap - done)
    return static


def iterate(a, b, c, state: PDHGResumeState, cap: int, *, tol: float,
            restart: int) -> Tuple[LPSolution, PDHGResumeState]:
    """Run up to ``cap`` ADDITIONAL steps from ``state`` (the plain loop).

    Step sizes are recomputed from ``a`` (deterministically, so a resumed
    round uses the same tau/sigma).
    """
    tau, sigma, scales = step_sizes(a, b, c)
    status, iters, out = iterate_with(a, b, c, state, cap, tau, sigma, scales, tol=tol,
                                      restart=restart)
    sol = LPSolution(objective=objective(c, out.x, status), x=out.x, status=status,
                     iterations=iters, y=out.y)
    return sol, out


def solve_batched(a, b, c, *, tol: float = 0.0, restart: int = 0, max_iters: int = 0,
                  want_state: bool = False):
    """Solve a canonical batch with restarted PDHG (the plain lockstep loop).

    ``tol`` 0 -> 1e-4, ``restart`` 0 -> 64, ``max_iters`` 0 ->
    :func:`auto_cap_pdhg`.  Returns an ``LPSolution`` with the dual point
    in ``y``, or ``(LPSolution, PDHGResumeState)`` with ``want_state``.
    """
    bsz, m, n = a.shape
    b = b.to(a.dtype)
    c = c.to(a.dtype)
    sol, state = iterate(a, b, c, init_state(bsz, m, n, a.dtype, a.device),
                         resolve_cap(max_iters, m, n), tol=resolve_tol(tol),
                         restart=resolve_restart(restart))
    return (sol, state) if want_state else sol


def resume_batched(a, b, c, state: PDHGResumeState, *, tol: float = 0.0, restart: int = 0,
                   max_iters: int = 0, want_state: bool = True):
    """Continue a batch from a carried :class:`PDHGResumeState`.

    ``max_iters`` is the ADDITIONAL step budget; rounds whose budgets sum
    to K replay one uninterrupted cap-K solve bit for bit.  Unlike the
    simplex resume, ``a`` comes back: the matvecs read it every step.
    """
    _, m, n = a.shape
    sol, out = iterate(a, b.to(a.dtype), c.to(a.dtype), state, resolve_cap(max_iters, m, n),
                       tol=resolve_tol(tol), restart=resolve_restart(restart))
    return (sol, out) if want_state else sol


# ---------------------------------------------------------------------------
# certificate confirmation on the float64 oracle
# ---------------------------------------------------------------------------


def confirm_workers(rows: int) -> int:
    """Host threads of the confirmation: one a core (``os.cpu_count()``), at
    most one a flagged row."""
    return max(1, min(os.cpu_count() or 1, rows))


def oracle_statuses(a: np.ndarray, b: np.ndarray, c: np.ndarray, max_iters: int,
                    workers: int = 1) -> np.ndarray:
    """The float64 oracle's status of each LP, solved on ``workers`` host threads.

    Each LP is one ``core/oracle.py:solve_lp`` call, independent of the
    others, so the statuses equal the sequential ``solve_batch``'s row
    for row.  The oracle's pivots are NumPy operations on a whole tableau
    (at 500x500, 0.75M entries a rank-1 update), which release the GIL,
    so the threads run side by side.
    """
    from . import oracle as _oracle

    if workers <= 1:
        return _oracle.solve_batch(a, b, c, max_iters=max_iters)[2]

    def one(i):
        return _oracle.solve_lp(a[i], b[i], c[i], max_iters)[2]

    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="lp-confirm") as pool:
        return np.asarray(list(pool.map(one, range(a.shape[0]))), np.int32)


def confirm_certificates(batch: LPBatch, sol: LPSolution, options=None) -> LPSolution:
    """Exactly confirm, or revoke, the loop's heuristic divergence flags.

    Every UNBOUNDED/INFEASIBLE row is re-solved by the float64 oracle
    (``core/oracle.py``) under a ``max(400, 2 (m + n))`` pivot budget, one
    row a host thread (:func:`oracle_statuses`, :func:`confirm_workers`),
    and the flag survives only if the oracle reproduces it; any other
    outcome reverts the row to ITER_LIMIT: never a wrong certificate, at
    worst an honest non-answer.  A genuine ray is cheap to reproduce; a
    false flag on a long valley would make the oracle grind to
    optimality, and the budget turns that into ITER_LIMIT.
    """
    st = sol.status.cpu().numpy()
    flagged = np.nonzero((st == UNBOUNDED) | (st == INFEASIBLE))[0]
    if flagged.size == 0:
        return sol
    idx = torch.as_tensor(flagged, device=batch.a.device)
    a, b, c = (t[idx].cpu().double().numpy() for t in (batch.a, batch.b, batch.c))
    exact = oracle_statuses(a, b, c, max(400, 2 * (batch.m + batch.n)),
                            confirm_workers(flagged.size))
    ok = exact == st[flagged]
    if np.all(ok):
        return sol
    status = sol.status.clone()
    status[torch.as_tensor(flagged[~ok], device=status.device)] = ITER_LIMIT
    return dataclasses.replace(sol, status=status)


# ---------------------------------------------------------------------------
# crossover: PDHG point -> simplex basis -> exact vertex
# ---------------------------------------------------------------------------


#: Fixed batch size of every crossover polish.  The warm tableau is built
#: by library routines (``torch.linalg.solve_ex``, batched products) that
#: pick their algorithm by batch size on the card, so a row polished
#: among 32 rows and alone differed in the last bits (measured on the
#: H100).  Polishing in replica-padded tiles of exactly this many rows
#: makes each row's bits a function of that row alone, as the
#: reference's ``CROSSOVER_TILE`` does for XLA.  Any fixed size does
#: that; 64 rows (64 thread blocks of the simplex kernel, half the card's
#: SMs) a launch rather than the reference's 8 is a choice of speed, and
#: ``chip_smoke.py`` times the polish at both (``crossover_tiles``).
CROSSOVER_TILE = 64


def crossover_basis(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Basis guess from a (near-)optimal point: the m largest of [x | b - Ax].

    IDs follow the tableau column convention (variable j -> 1 + j, slack
    i -> 1 + n + i).  At a vertex many of the values are exactly 0, so
    ties are the normal case: a stable descending sort breaks them toward
    the lower index, as the reference's ``jax.lax.top_k`` does
    (``torch.topk`` does not promise that order).
    """
    n = x.shape[-1]
    m = b.shape[-1]
    vals = torch.cat([x, b - matvec(a, x)], dim=-1)
    idx = torch.sort(vals, dim=-1, descending=True, stable=True).indices[:, :m]
    return torch.where(idx < n, 1 + idx, 1 + n + (idx - n)).to(torch.int32)


def crossover(batch: LPBatch, sol: LPSolution, options=None, *,
              tile: int = CROSSOVER_TILE) -> LPSolution:
    """Polish a PDHG solution's OPTIMAL rows into exact simplex vertices.

    Gathers the converged rows, reads a basis guess off each point and
    warm-starts the simplex solver from it (``kernels/ops.py:
    simplex_solve``: the simplex kernel on the card, its plain version on
    the CPU), whose warm path validates the guess per LP and cold-starts
    the rows where it is singular or infeasible.  The polished rows carry
    the exact vertex objective/point and a reusable ``basis``;
    ``iterations`` adds the polish pivots to the PDHG steps.  Other rows
    pass through.

    The gathered rows are polished in tiles of ``tile`` rows
    (:data:`CROSSOVER_TILE`, ``core/lp.py:row_tiles``), one launch a
    tile, so each row's polished bits depend on that row and the tile
    size alone.
    """
    from ..kernels import ops as kernel_ops  # lazy: kernels import core

    st = sol.status.cpu().numpy()
    opt = np.nonzero(st == OPTIMAL)[0]
    if opt.size == 0:
        return sol
    bsz, m = batch.batch, batch.m
    dev = batch.a.device
    tol = getattr(options, "tolerance", 0.0) if options is not None else 0.0
    rows = torch.as_tensor(opt, device=dev)
    parts = []
    for idx, real in row_tiles(rows, tile):
        a, b, c = batch.a[idx], batch.b[idx], batch.c[idx]
        guess = crossover_basis(a, b, sol.x[idx])
        part = kernel_ops.simplex_solve(a, b, c, tol=tol, basis0=guess)
        parts.append(LPSolution(*(getattr(part, f)[:real] for f in
                                  ("objective", "x", "status", "iterations", "basis"))))
    polished = LPSolution(*(torch.cat([getattr(p, f) for p in parts]) for f in
                            ("objective", "x", "status", "iterations", "basis")))
    ok = (polished.status == OPTIMAL).nonzero().flatten()
    done = rows[ok]
    basis = torch.zeros((bsz, m), dtype=torch.int32, device=dev)
    if sol.basis is not None:
        basis.copy_(sol.basis)
    basis[done] = polished.basis[ok]
    objective_ = sol.objective.clone()
    objective_[done] = polished.objective[ok]
    x = sol.x.clone()
    x[done] = polished.x[ok]
    iterations = sol.iterations.clone()
    iterations[done] += polished.iterations[ok]
    return LPSolution(objective=objective_, x=x, status=sol.status, iterations=iterations,
                      basis=basis, y=sol.y)
