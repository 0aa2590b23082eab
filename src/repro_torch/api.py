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
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from .core import dispatch as _dispatch
from .core.backends import SolveOptions, SolveStats
from .core.bucketing import ShapeGrid, bucket_problems, scatter_solutions
from .core.lp import INFEASIBLE, LPBatch, LPSolution, SharedLPBatch
from .core.problem import LPProblem, canonicalize, solve_box, uncanonicalize

Solvable = Union[LPProblem, LPBatch, SharedLPBatch, Sequence[LPProblem]]


def solve(
    problem: Solvable,
    options: Optional[SolveOptions] = None,
    *,
    grid: Optional[ShapeGrid] = None,
    stats: Optional[SolveStats] = None,
) -> Union[LPSolution, List[LPSolution]]:
    """Solve general-form LP problem(s); see the module docstring for routing.

    ``options`` defaults to ``SolveOptions()`` (backend ``"cuda"``);
    ``grid`` pins the shape classes of a list input; ``stats`` collects
    counters.  Returns one ``LPSolution``, or a list for a list input.
    """
    if isinstance(problem, (LPBatch, SharedLPBatch)):
        return _dispatch.solve_canonical(problem, options, stats=stats)
    if isinstance(problem, LPProblem):
        return _solve_problem(problem, options, stats)
    if isinstance(problem, (list, tuple)):
        return _solve_many(problem, options, grid, stats)
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
    stats: Optional[SolveStats] = None,
    device=None,
) -> LPSolution:
    """Support of the box [lo, hi] in each direction (paper Sec. 6).

    ``lo``/``hi`` broadcast to ``directions`` (B, n); inputs go to
    ``device`` (None = the card).  Support values come back in
    ``objective``, maximizing vertices in ``x``.
    """
    return _dispatch.solve_hyperbox(lo, hi, directions, options, stats=stats, device=device)


def _solve_problem(
    problem: LPProblem, options: Optional[SolveOptions], stats: Optional[SolveStats] = None
) -> LPSolution:
    if problem.batch == 0:
        return _dispatch.empty_solution(problem.n, problem.dtype, problem.device)
    if problem.boxlike:
        if options is not None and options.backend == "torch":
            sol = solve_box(problem)
            if stats is not None:
                stats.record(sol)
            return sol
        return _solve_box_via_backend(problem, options or SolveOptions(), stats)
    canon = canonicalize(problem)
    sol = _dispatch.solve_canonical(canon.batch, options, stats=stats)
    return uncanonicalize(canon, sol)


def _solve_box_via_backend(
    problem: LPProblem, options: SolveOptions, stats: Optional[SolveStats] = None
) -> LPSolution:
    """Boxlike solve through the backend's hyperbox path (sign-adjusted).

    The kernel maximizes, so minimize flips the direction and the sign of
    the support value; empty boxes report INFEASIBLE (the kernels assume
    lo <= hi).
    """
    sign = 1.0 if problem.maximize else -1.0
    sol = _dispatch.solve_hyperbox(
        problem.lo, problem.hi, sign * problem.c, options, stats=stats,
        device=problem.device,
    )
    infeasible = (problem.lo > problem.hi).any(dim=-1)
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
) -> List[LPSolution]:
    if not problems:
        return []
    buckets = bucket_problems(problems, grid)
    sols = [_solve_problem(b.problem, options, stats) for b in buckets]
    return scatter_solutions(buckets, sols, len(problems))
