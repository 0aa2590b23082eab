"""``repro_torch.solve`` — the front end over every solver path.

Follows ``repro/api.py``:

    import repro_torch
    from repro_torch import LPProblem, SolveOptions

    sol = repro_torch.solve(LPProblem.make(c, a, bu=b))          # on the card
    sols = repro_torch.solve([p1, p2, p3])                       # bucketed list
    sol = repro_torch.solve(p, SolveOptions(backend="torch"))    # plain path

Routing:

  * ``LPProblem`` -> the hyperbox path when ``boxlike`` (no general rows,
    finite box), else canonicalize -> chunked dispatch -> uncanonicalize.
    On ``"cuda"`` (the default), ``"auto"`` and ``"pdhg"`` box problems
    run the hyperbox kernel; on ``"torch"`` they take the closed form
    ``solve_box``.
  * ``list/tuple`` of ``LPProblem`` -> shape bucketing, one solve per
    bucket, per-problem single-LP solutions in input order.
  * ``LPBatch`` -> straight to the chunked dispatch; on ``"pdhg"`` (or
    ``"auto"`` past the frontier) the solution carries the dual point
    ``y``, which ``uncanonicalize`` drops for an ``LPProblem``, as the
    reference does.
  * ``SharedLPBatch`` (one ``A``, batched ``c``/``b``) -> the chunked
    dispatch on the shared revised-simplex backends; the default
    ``"cuda"`` promotes to ``"cuda-shared"``, the revised kernel.

A solve runs where its tensors live: problems built with
``device="cpu"`` solve on the CPU through the kernels' plain versions.

``mesh`` (a ``torch.distributed`` ``DeviceMesh``, ``launch/mesh.py``)
splits the batch dimension across the mesh's ``batch_axes``: every rank
calls ``solve`` with the same input, solves its own block of rows on
the mesh's device, and gets back the whole solution
(``core/dispatch.py``, ``core/spmd.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from .core import dispatch as _dispatch
from .core.backends import SolveOptions, SolveStats
from .core.bucketing import ShapeGrid, bucket_problems, scatter_solutions
from .core.lp import INFEASIBLE, LPBatch, LPSolution, SharedLPBatch
from .core.problem import LPProblem, canonicalize, solve_box, uncanonicalize
from .core.spmd import resolve_split, solution_rows, to_device

Solvable = Union[LPProblem, LPBatch, SharedLPBatch, Sequence[LPProblem]]


def solve(
    problem: Solvable,
    options: Optional[SolveOptions] = None,
    *,
    mesh=None,
    batch_axes: Sequence[str] = ("data",),
    grid: Optional[ShapeGrid] = None,
    stats: Optional[SolveStats] = None,
) -> Union[LPSolution, List[LPSolution]]:
    """Solve general-form LP problem(s); see the module docstring for routing.

    ``options`` defaults to ``SolveOptions()`` (backend ``"cuda"``);
    ``mesh`` splits the batch over its ``batch_axes`` (every rank calls
    with the same input and gets the whole answer); ``grid`` pins the
    shape classes of a list input; ``stats`` collects counters.  Returns
    one ``LPSolution``, or a list for a list input.
    """
    if isinstance(problem, (LPBatch, SharedLPBatch)):
        return _dispatch.solve_canonical(problem, options, stats=stats, mesh=mesh,
                                         batch_axes=batch_axes)
    if isinstance(problem, LPProblem):
        return _solve_problem(problem, options, stats, mesh, batch_axes)
    if isinstance(problem, (list, tuple)):
        return _solve_many(problem, options, grid, stats, mesh, batch_axes)
    raise TypeError(
        "repro_torch.solve expects LPProblem, LPBatch, SharedLPBatch, or a list of "
        f"LPProblem; got {type(problem).__name__}"
    )


def solve_hyperbox(
    lo,
    hi,
    directions,
    options: Optional[SolveOptions] = None,
    *,
    mesh=None,
    batch_axes: Sequence[str] = ("data",),
    stats: Optional[SolveStats] = None,
    device=None,
) -> LPSolution:
    """Support of the box [lo, hi] in each direction (paper Sec. 6).

    ``lo``/``hi`` broadcast to ``directions`` (B, n); inputs go to
    ``device`` (None = the card), or under a ``mesh`` each rank's block
    to the mesh's device (B must split evenly over ``batch_axes``).
    Support values come back in ``objective``, maximizing vertices in
    ``x``.
    """
    return _dispatch.solve_hyperbox(lo, hi, directions, options, stats=stats, device=device,
                                    mesh=mesh, batch_axes=batch_axes)


def _solve_problem(
    problem: LPProblem, options: Optional[SolveOptions], stats: Optional[SolveStats] = None,
    mesh=None, batch_axes: Sequence[str] = ("data",),
) -> LPSolution:
    if problem.batch == 0:
        return _dispatch.empty_solution(problem.n, problem.dtype, problem.device)
    if problem.boxlike:
        if options is not None and options.backend == "torch":
            sol = solve_box(problem)
            if stats is not None:
                stats.record(sol)
            return sol
        return _solve_box_via_backend(problem, options or SolveOptions(), stats, mesh,
                                      batch_axes)
    canon = canonicalize(problem)
    sol = _dispatch.solve_canonical(canon.batch, options, stats=stats, mesh=mesh,
                                    batch_axes=batch_axes)
    # A split solve's answer lives on the mesh's device, its input may not.
    return uncanonicalize(to_device(canon, sol.status.device), sol)


def _solve_box_via_backend(
    problem: LPProblem, options: SolveOptions, stats: Optional[SolveStats] = None,
    mesh=None, batch_axes: Sequence[str] = ("data",),
) -> LPSolution:
    """Boxlike solve through the backend's hyperbox path (sign-adjusted).

    The kernel maximizes, so minimize flips the direction and the sign of
    the support value; empty boxes report INFEASIBLE (the kernels assume
    lo <= hi).  Under a mesh the rows are padded with copies of the last
    to whole blocks of the batch axes, and the copies' answers dropped:
    the reference solves a boxlike problem in closed form, unsplit, at
    any batch size (only its ``solve_hyperbox`` requires whole blocks).
    """
    sign = 1.0 if problem.maximize else -1.0
    bounds = [problem.lo, problem.hi, sign * problem.c]
    split = resolve_split(mesh, batch_axes)
    extra = 0 if split is None else -problem.batch % split.div
    if extra:
        bounds = [torch.cat([t, t[-1:].expand(extra, -1)]) for t in bounds]
    sol = _dispatch.solve_hyperbox(
        *bounds, options, stats=None if extra else stats,
        device=problem.device, mesh=mesh, batch_axes=batch_axes,
    )
    if extra:
        sol = solution_rows(sol, slice(0, problem.batch))
        if stats is not None:
            stats.record(sol)
    infeasible = (problem.lo > problem.hi).any(dim=-1).to(sol.status.device)
    bad = -float("inf") if problem.maximize else float("inf")
    objective = torch.where(infeasible, bad, sign * sol.objective)
    x = torch.where(infeasible[:, None], 0.0, sol.x)
    status = torch.where(infeasible, INFEASIBLE, sol.status).to(torch.int32)
    return LPSolution(objective=objective, x=x, status=status, iterations=sol.iterations)


def _solve_many(
    problems: Sequence[LPProblem],
    options: Optional[SolveOptions],
    grid: Optional[ShapeGrid],
    stats: Optional[SolveStats] = None,
    mesh=None,
    batch_axes: Sequence[str] = ("data",),
) -> List[LPSolution]:
    if not problems:
        return []
    buckets = bucket_problems(problems, grid)
    sols = [_solve_problem(b.problem, options, stats, mesh, batch_axes) for b in buckets]
    return scatter_solutions(buckets, sols, len(problems))
