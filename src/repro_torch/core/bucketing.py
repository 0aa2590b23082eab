"""Shape bucketing: megabatch heterogeneous LPs into few device batches.

Follows the non-shared half of ``repro/core/bucketing.py``:

  1. group a list of single-LP ``LPProblem``s by padded shape class —
     powers of two per axis by default, or a caller-supplied grid;
  2. pad each problem to its class with disabled rows and dead columns,
     and stack each class into one batched ``LPProblem``;
  3. after the per-bucket solves, scatter results back in input order,
     trimming each primal point to its problem's true variable count.

Objective sense and dtype are part of the bucket key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .lp import LPSolution
from .problem import LPProblem, stack_problems

ShapeGrid = Sequence[Tuple[int, int]]


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (0 stays 0: row-free problems)."""
    if x <= 0:
        return 0
    return 1 << (x - 1).bit_length()


def shape_class(m: int, n: int, grid: Optional[ShapeGrid] = None) -> Tuple[int, int]:
    """The padded (m, n) class a problem lands in.

    Default: power-of-two rounding per axis.  With a grid: the
    smallest-area entry that fits (raises if none does).
    """
    if grid is None:
        return next_pow2(m), next_pow2(n)
    fits = [(gm * gn, gm, gn) for gm, gn in grid if gm >= m and gn >= n]
    if not fits:
        raise ValueError(f"no grid shape fits problem of shape ({m}, {n}): {list(grid)}")
    _, gm, gn = min(fits)
    return gm, gn


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One shape class: the stacked padded problem + provenance."""

    key: Tuple
    problem: LPProblem  # stacked, padded to the class shape
    indices: Tuple[int, ...]  # positions in the input list
    true_shapes: Tuple[Tuple[int, int], ...]  # (m, n) before padding


def bucket_problems(
    problems: Sequence[LPProblem], grid: Optional[ShapeGrid] = None
) -> List[Bucket]:
    """Group, pad, and stack a heterogeneous problem list by shape class."""
    groups: Dict[Tuple, Tuple[List[LPProblem], List[int], List[Tuple[int, int]]]] = {}
    for i, p in enumerate(problems):
        if not isinstance(p, LPProblem):
            raise TypeError(f"problems[{i}] is {type(p).__name__}, expected LPProblem")
        if p.batch != 1:
            raise ValueError(
                "bucket_problems expects single-LP problems (batch == 1); "
                f"problems[{i}] has batch {p.batch} — solve it directly"
            )
        cm, cn = shape_class(p.m, p.n, grid)
        key = (cm, cn, p.maximize, str(p.dtype), str(p.device))
        padded, idx, shapes = groups.setdefault(key, ([], [], []))
        padded.append(p.pad_to(cm, cn))
        idx.append(i)
        shapes.append((p.m, p.n))
    return [
        Bucket(key=key, problem=stack_problems(padded), indices=tuple(idx),
               true_shapes=tuple(shapes))
        for key, (padded, idx, shapes) in groups.items()
    ]


def scatter_solutions(
    buckets: Sequence[Bucket], bucket_solutions: Sequence[LPSolution], total: int
) -> List[LPSolution]:
    """Un-bucket per-bucket solutions back to input order.

    One single-LP ``LPSolution`` per input problem, with ``x`` trimmed to
    the problem's true variable count.  The basis lives in the padded
    canonical space of the bucket, so it is not scattered.
    """
    out: List[Optional[LPSolution]] = [None] * total
    for bucket, sol in zip(buckets, bucket_solutions):
        for row, (idx, (_, tn)) in enumerate(zip(bucket.indices, bucket.true_shapes)):
            out[idx] = LPSolution(
                objective=sol.objective[row : row + 1],
                x=sol.x[row : row + 1, :tn],
                status=sol.status[row : row + 1],
                iterations=sol.iterations[row : row + 1],
            )
    missing = [i for i, s in enumerate(out) if s is None]
    if missing:
        raise RuntimeError(f"scatter left unsolved problems at indices {missing}")
    return out  # type: ignore[return-value]
