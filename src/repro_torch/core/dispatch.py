"""Chunked dispatch of LP batches to a backend.

Follows the plain path of ``repro/core/dispatch.py``: a solve is one
round at the full iteration cap (the reference's one-round plan), and
the round is split into ``SolveOptions.chunk_size`` chunks by slicing —
the paper's device-capacity bound (Sec. 4.4).  Chunks are launched in
order on the current stream; torch's asynchronous launches keep the card
busy while the host slices the next chunk.

A :class:`~repro_torch.core.lp.SharedLPBatch` runs on the shared
backends: ``cuda`` and ``torch`` promote to ``cuda-shared`` and
``torch-shared`` (:func:`resolve_backend`), another backend (such as
``reference`` or ``pdhg``) gets the densified batch, and a plain
``LPBatch`` on a shared backend raises.  Shared chunks slice only
``b``/``c``: the one ``A`` is never copied.

``backend="auto"`` is resolved once per batch, by shape
(``core/backends.py:route_shape``).  On ``pdhg`` two post-passes run on
the merged solution: every divergence certificate is confirmed on the
float64 oracle, then, with ``crossover=True``, the OPTIMAL rows are
polished into exact vertices (``core/pdhg.py``).

Not here yet (later slices): convergence compaction and its round
plans, exact round resume between rounds, guardrails and quarantine,
fault injection and retry, speculation, and mesh sharding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from . import pdhg as _pdhg
from . import revised as _revised
from .backends import SHARED_BACKENDS, SolveOptions, SolveStats, get_backend, route_shape
from .engine import LPC
from .lp import LPBatch, LPSolution, SharedLPBatch, _tensor, resolve_device
from .tableau import TableauSpec


def empty_solution(n: int, dtype=torch.float32, device=None) -> LPSolution:
    """The solution of a zero-LP batch (shape-correct, no device work)."""
    return LPSolution(
        objective=torch.zeros((0,), dtype=dtype, device=device),
        x=torch.zeros((0, n), dtype=dtype, device=device),
        status=torch.zeros((0,), dtype=torch.int32, device=device),
        iterations=torch.zeros((0,), dtype=torch.int32, device=device),
    )


def _concat_solutions(parts: Sequence[LPSolution]) -> LPSolution:
    def cat_optional(field):
        vals = [getattr(p, field) for p in parts]
        return torch.cat(vals) if all(v is not None for v in vals) else None

    return LPSolution(
        objective=torch.cat([p.objective for p in parts]),
        x=torch.cat([p.x for p in parts]),
        status=torch.cat([p.status for p in parts]),
        iterations=torch.cat([p.iterations for p in parts]),
        basis=cat_optional("basis"),
        y=cat_optional("y"),
    )


def resolve_backend(options: SolveOptions, shared: bool = False,
                    shape: Optional[Tuple[int, int]] = None) -> SolveOptions:
    """The concrete backend for a batch of LPs of ``shape`` = (m, n).

    ``"auto"`` resolves through :func:`~repro_torch.core.backends.route_shape`
    (``shape`` is needed for a dense batch); a batch routed to ``pdhg``
    gets ``rule``/``layout`` reset to their defaults, since those knobs
    configure the simplex leg and ``pdhg`` rejects them.  On a shared
    batch the simplex names promote to their shared counterparts
    (``"cuda"`` -> ``"cuda-shared"``, ``"torch"`` -> ``"torch-shared"``):
    the revised engine is the simplex solver for that container.  Every
    other name passes through.
    """
    if options.backend == "auto":
        if not shared and shape is None:
            raise ValueError("backend='auto' needs the batch's shape (m, n) to resolve")
        m, n = shape if shape is not None else (0, 0)
        resolved = route_shape(m, n, options, shared=shared)
        if resolved == "pdhg":
            return options.replace(backend=resolved, rule=LPC, layout=None)
        return options.replace(backend=resolved)
    if shared:
        promote = {"cuda": "cuda-shared", "torch": "torch-shared"}
        if options.backend in promote:
            return options.replace(backend=promote[options.backend])
    return options


def solve_canonical(
    batch: Union[LPBatch, SharedLPBatch],
    options: Optional[SolveOptions] = None,
    stats: Optional[SolveStats] = None,
) -> LPSolution:
    """Solve a canonical batch (``max c.x, Ax <= b, x >= 0``) in one round.

    Runs where the batch's tensors live.  A ``SharedLPBatch`` runs on the
    shared backends, or densified on an explicitly named other backend;
    an ``LPBatch`` on a shared backend raises ``ValueError``.  Returns one
    result row per input LP, in input order.
    """
    options = options or SolveOptions()
    if batch.batch == 0:
        return empty_solution(batch.n, batch.a.dtype, batch.a.device)
    shared = isinstance(batch, SharedLPBatch)
    options = resolve_backend(options, shared, (batch.m, batch.n))
    if shared and options.backend not in SHARED_BACKENDS:
        # An explicit non-shared backend (pdhg, reference, a plug-in): honour the
        # request by densifying, correctness over the memory win.
        batch = batch.densify()
    elif not shared and options.backend in SHARED_BACKENDS:
        raise ValueError(
            f"backend {options.backend!r} consumes SharedLPBatch (one A, batched c/b); "
            "this batch carries a per-LP constraint matrix: solve it on a tableau "
            "backend, or build a SharedLPBatch"
        )
    sol = dispatch_round(batch, options, stats)
    if options.backend == "pdhg":
        # Both post-passes run once, on the merged solution.  Confirmation
        # first: it may revoke a heuristic flag, and crossover polishes
        # only real optima.
        sol = _pdhg.confirm_certificates(batch, sol, options)
        if options.crossover:
            sol = _pdhg.crossover(batch, sol, options)
    return sol


def dispatch_round(
    batch: Union[LPBatch, SharedLPBatch], options: SolveOptions,
    stats: Optional[SolveStats] = None,
) -> LPSolution:
    """One dispatch round: chunk, solve, concatenate, record.

    The only place that talks to a backend for canonical batches.
    """
    backend = get_backend(options.backend)
    bsz = batch.batch
    chunk = options.chunk_size or bsz
    if stats is not None:
        if backend.name == "pdhg":
            per_lp = _pdhg.state_bytes_per_lp(batch.m, batch.n, batch.a.dtype)
        elif backend.name in SHARED_BACKENDS:
            per_lp = _revised.state_bytes_per_lp(batch.m, batch.n, batch.a.dtype)
        else:
            per_lp = TableauSpec(batch.m, batch.n, options.effective_layout).bytes_per_lp(
                batch.a.dtype)
        stats.record_tableau(min(chunk, bsz) * per_lp)
    parts = []
    for lo in range(0, bsz, chunk):
        out = backend.solve_canonical(batch.take(slice(lo, min(lo + chunk, bsz))), options)
        if stats is not None:
            stats.record(out)
        parts.append(out)
    return parts[0] if len(parts) == 1 else _concat_solutions(parts)


def solve_hyperbox(
    lo,
    hi,
    directions,
    options: Optional[SolveOptions] = None,
    stats: Optional[SolveStats] = None,
    device=None,
) -> LPSolution:
    """Closed-form box-LP batch through the selected backend.

    ``lo``/``hi`` broadcast to ``directions`` (B, n).  Array-likes and
    tensors go to ``device`` (None = the card; raises without one).
    """
    options = options or SolveOptions()
    if options.backend == "auto":
        # Box LPs are closed-form: the simplex/first-order question of
        # "auto" does not arise, and the hyperbox kernel answers them.
        options = options.replace(backend="cuda")
    dev = resolve_device(device)
    directions = _tensor(directions, device=dev)
    dtype = directions.dtype
    lo = _tensor(lo, dtype=dtype, device=dev)
    hi = _tensor(hi, dtype=dtype, device=dev)
    if directions.shape[0] == 0:
        return empty_solution(directions.shape[-1], dtype, dev)
    sol = get_backend(options.backend).solve_hyperbox(lo, hi, directions, options)
    if stats is not None:
        stats.record(sol)
    return sol
