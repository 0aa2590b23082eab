"""Shape bucketing: megabatch heterogeneous LPs into few device batches.

Follows ``repro/core/bucketing.py``:

  1. group a list of single-LP ``LPProblem``s by padded shape class —
     powers of two per axis by default, or a caller-supplied grid;
  2. pad each problem to its class with disabled rows and dead columns,
     and stack each class into one batched ``LPProblem``;
  3. after the per-bucket solves, scatter results back in input order,
     trimming each primal point to its problem's true variable count.

Objective sense and dtype are part of the bucket key.  Shared batches
(:class:`~repro_torch.core.lp.SharedLPBatch`) bucket by shape, dtype and
identical ``A`` (:func:`bucket_shared_batches`), so a merged bucket
still stores one ``A``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .lp import LPSolution, SharedLPBatch
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


@dataclasses.dataclass(frozen=True)
class SharedBucket:
    """One (m, n, dtype, device, A) class of shared batches, concatenated.

    Only the per-LP ``b``/``c`` rows are concatenated: the merged batch
    still stores ONE ``A``.
    """

    key: Tuple
    batch: SharedLPBatch  # b/c concatenated over the group, one shared A
    indices: Tuple[int, ...]  # positions in the input list
    sizes: Tuple[int, ...]  # batch rows each input contributed


def bucket_shared_batches(batches: Sequence[SharedLPBatch]) -> List[SharedBucket]:
    """Group ``SharedLPBatch``es by (m, n, dtype, device) and identical ``A``.

    Batches whose matrices compare equal (the same tensor short-circuits)
    merge into one batch per ``A``; batches that share only the shape
    stay apart, since merging them would force densification.  Warm-start
    bases concatenate only when every member carries one.
    """
    shape_groups: Dict[Tuple, List[Tuple[int, SharedLPBatch]]] = {}
    for i, sb in enumerate(batches):
        if not isinstance(sb, SharedLPBatch):
            raise TypeError(f"batches[{i}] is {type(sb).__name__}, expected SharedLPBatch")
        key = (sb.m, sb.n, str(sb.a.dtype), str(sb.a.device))
        shape_groups.setdefault(key, []).append((i, sb))

    out: List[SharedBucket] = []
    for key, members in shape_groups.items():
        a_groups: List[Tuple[SharedLPBatch, List[Tuple[int, SharedLPBatch]]]] = []
        for i, sb in members:
            for rep, grp in a_groups:
                if sb.a is rep.a or torch.equal(sb.a, rep.a):
                    grp.append((i, sb))
                    break
            else:
                a_groups.append((sb, [(i, sb)]))
        for sub, (rep, grp) in enumerate(a_groups):
            parts = [sb for _, sb in grp]
            basis0 = None
            if all(p.basis0 is not None for p in parts):
                basis0 = torch.cat([p.basis0 for p in parts])
            out.append(SharedBucket(
                key=(*key, sub),
                batch=SharedLPBatch(rep.a, torch.cat([p.b for p in parts]),
                                    torch.cat([p.c for p in parts]), basis0=basis0),
                indices=tuple(i for i, _ in grp),
                sizes=tuple(p.batch for p in parts),
            ))
    return out


def scatter_shared_solutions(
    buckets: Sequence[SharedBucket], bucket_solutions: Sequence[LPSolution], total: int
) -> List[LPSolution]:
    """One ``LPSolution`` per input ``SharedLPBatch``, sliced back to its rows."""
    out: List[Optional[LPSolution]] = [None] * total
    for bucket, sol in zip(buckets, bucket_solutions):
        row = 0
        for idx, size in zip(bucket.indices, bucket.sizes):
            sl = slice(row, row + size)
            out[idx] = LPSolution(
                objective=sol.objective[sl], x=sol.x[sl], status=sol.status[sl],
                iterations=sol.iterations[sl],
                basis=None if sol.basis is None else sol.basis[sl],
            )
            row += size
    missing = [i for i, s in enumerate(out) if s is None]
    if missing:
        raise RuntimeError(f"scatter left unsolved batches at indices {missing}")
    return out  # type: ignore[return-value]


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
