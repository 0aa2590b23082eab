"""Round-scheduled, chunked dispatch of LP batches to a backend.

Follows ``repro/core/dispatch.py``.  A solve is a *round plan*, a short
list of per-round iteration caps (:func:`_round_plan`), run by one
gather/dispatch/scatter loop (:func:`solve_canonical`):

  * plain solving                -> one round at the full cap;
  * ``SolveOptions.first_cap``   -> rounds ``[first_cap, full]``, with the
    iteration counts continued across them (the legacy two-pass);
  * ``compaction="chunked"``     -> rounds ``[k, full]``;
  * ``compaction="every_k"``     -> rounds ``[k, 2k, 4k, ..., full]``.

Round 0 dispatches the whole batch; each later round reads the status
vector back (the one host sync per round), gathers the rows that hit the
previous cap (``ITER_LIMIT``) into a dense sub-batch in ascending row
order, dispatches only those, and scatters the results back in input
order.  With ``resume="scratch"`` survivors restart from iteration 0;
with ``resume="basis"`` they continue from the exact state the previous
round stopped at, through the backend's state hooks
(``kernels/ops.py:simplex_resume``, ``revised_resume``, ``pdhg_resume``
on the card), so the rounds' budgets sum to one full solve.  Both are
bit-identical to ``compaction="off"`` under lpc and bland.  A plain
one-round solve reads nothing back.

Each round is split into ``SolveOptions.chunk_size`` chunks by slicing,
the paper's device-capacity bound (Sec. 4.4); torch's asynchronous
launches keep the card busy while the host slices the next chunk.  The
reference pads every later round to a power-of-two size class, so that
XLA reuses one executable; a CUDA launch takes any batch size, so the
port dispatches the survivors as they are (``ROADMAP.md``, "TPU
mechanics not carried over").

After every round the guardrails (:func:`apply_guardrails`) retire rows
whose solution or carried state went non-finite as ``NUMERICAL``.  The
post-passes run once, on the merged solution, in the reference's order:
on ``pdhg`` the divergence certificates are confirmed on the float64
oracle, then (``crossover=True``) the OPTIMAL rows are polished into
vertices (``core/pdhg.py``); last, with ``quarantine=True``, the
``NUMERICAL`` rows are re-solved on the oracle (:func:`_quarantine_resolve`).

A :class:`~repro_torch.core.lp.SharedLPBatch` runs on the shared
backends: ``cuda`` and ``torch`` promote to ``cuda-shared`` and
``torch-shared`` (:func:`resolve_backend`), another backend (such as
``reference`` or ``pdhg``) gets the densified batch, and a plain
``LPBatch`` on a shared backend raises.  Shared gathers take only
``b``/``c``: the one ``A`` is never copied.  The open knobs
(``backend="auto"``, ``layout=None``) are resolved once per batch, by the
cost-model autotuner (``runtime/autotune.py``) or with ``autotune="off"``
by the static table (``core/backends.py:route_shape``), so every round of
a solve runs one backend.

Every round of :func:`solve_canonical` (and of the serve loop, through
``SolveSession.resume_round``) goes through :func:`dispatch_round_safe`:
a transient failure re-dispatches the same round from the same carried
state, on the same backend, up to ``SolveOptions.retry_budget`` times
with capped exponential backoff; errors in
``runtime/chaos.py:NON_TRANSIENT`` (bad arguments, a kernel that did not
build or load) propagate at once.  :func:`dispatch_round` consults an
installed ``runtime/chaos.py:ChaosMonkey`` before the round, before each
chunk and on the outgoing carried state.  With
``SolveOptions.speculation`` a round of several chunks runs them on
worker threads, each on its own CUDA stream, and re-dispatches a chunk
that misses the straggler deadline (:func:`_speculative_chunks`);
:func:`admission_order` is the serve loop's admission policy.

Under a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``; ``batch_axes``
name the axes that split the batch) every entry point here runs as one
process a rank: each rank is given the same full batch, solves its own
block of rows on its own device, and returns the same full solution
(``core/spmd.py``).  A round without a carried state pads the batch to a
multiple of the batch axes' product and trims the padding off again; a
carried state stays with the rank that owns its rows, and later rounds
hand each survivor to its owner.  The counters equal the unsplit
solve's on every rank.  A round that fails on any rank fails on every
rank with the same exception class, so the retries and the propagation
above happen on all ranks together.  Speculation does not run under a
mesh, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime import chaos as _chaos
from . import pdhg as _pdhg
from . import revised as _revised
from . import spmd as _spmd
from .backends import (
    SHARED_BACKENDS,
    Backend,
    SolveOptions,
    SolveStats,
    get_backend,
    route_shape,
)
from .engine import LPC
from .lp import (
    ITER_LIMIT,
    NUMERICAL,
    OPTIMAL,
    LPBatch,
    LPSolution,
    SharedLPBatch,
    _tensor,
    auto_cap,
    concat_states,
    resolve_device,
)
from .tableau import TableauSpec

#: Ceiling on the retry backoff sleep (seconds): retry k of a round sleeps
#: ``min(retry_backoff * 2**k, RETRY_BACKOFF_CAP)``.
RETRY_BACKOFF_CAP = 1.0


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


def _scatter_solution(full: LPSolution, idx: torch.Tensor, part: LPSolution,
                      iter_offset: int = 0, accumulate: bool = False) -> LPSolution:
    """``full`` with rows ``idx`` overwritten by ``part`` (the compaction scatter).

    ``accumulate`` adds the part's iteration counts onto the rows'
    totals (a resumed round reports only its own pivots) instead of
    replacing them; ``iter_offset`` is added to replaced counts (the
    legacy two-pass).  A ``basis``/``y`` present in only one of the two
    is dropped rather than fabricated.
    """
    def put(dst, src):
        out = dst.clone()
        out[idx] = src
        return out

    basis = full.basis
    if basis is not None and part.basis is not None:
        basis = put(basis, part.basis)
    elif part.basis is not None:
        basis = None
    y = full.y
    if y is not None and part.y is not None:
        y = put(y, part.y)
    elif part.y is not None:
        y = None
    if accumulate:
        iterations = full.iterations.clone()
        iterations[idx] += part.iterations
    else:
        iterations = put(full.iterations, part.iterations + iter_offset)
    return LPSolution(
        objective=put(full.objective, part.objective),
        x=put(full.x, part.x),
        status=put(full.status, part.status),
        iterations=iterations,
        basis=basis,
        y=y,
    )


def _full_cap(batch, options: SolveOptions, backend: Optional[Backend] = None) -> int:
    """The effective iteration cap: ``max_iters``, or the backend's auto rule.

    ``pdhg`` has its own (``core/pdhg.py:auto_cap_pdhg``), the simplex
    backends ``50 (m + n)``.  The round plan and a plain solve must agree
    on it: that keeps compaction identical to ``compaction="off"``.
    """
    if options.max_iters > 0:
        return options.max_iters
    cap_fn = (backend.auto_cap if backend is not None else None) or auto_cap
    return cap_fn(batch.m, batch.n)


def _round_cap(batch, options: SolveOptions, backend: Optional[Backend] = None) -> int:
    """The first compaction round's budget (``compact_every``, 0 -> ``8 (m + n)``)."""
    k = options.compact_every if options.compact_every > 0 else 8 * (batch.m + batch.n)
    return min(k, _full_cap(batch, options, backend))


def _round_plan(batch, options: SolveOptions, incremental: bool = False,
                backend: Optional[Backend] = None) -> Tuple[Sequence[int], bool]:
    """Lower ``options`` to per-round caps: ``(caps, carry_iters)``.

    Round 0 dispatches the whole batch at ``caps[0]``; round r > 0 the
    rows that hit round r-1's cap, at ``caps[r]``.  Without
    ``incremental`` (scratch rounds) each cap counts from iteration 0;
    with it (basis resume) each is the round's ADDITIONAL budget, and the
    budgets sum to the full cap.  ``carry_iters`` is True only for the
    legacy two-pass, whose counts continue across its rounds.
    """
    full_cap = _full_cap(batch, options, backend)
    if options.compaction == "chunked":
        cap = _round_cap(batch, options, backend)
        if cap >= full_cap:
            return [cap], False
        return ([cap, full_cap - cap] if incremental else [cap, full_cap]), False
    if options.compaction == "every_k":
        cap = _round_cap(batch, options, backend)
        caps = [cap]
        cum = cap
        while cum < full_cap:
            inc = min(cum, full_cap - cum)  # the cumulative budget doubles
            caps.append(inc if incremental else cum + inc)
            cum += inc
        return caps, False
    if options.first_cap is not None:
        first = options.first_cap or 8 * (batch.m + batch.n)
        return [first, full_cap], True
    return [full_cap], False


def resolve_backend(options: SolveOptions, shared: bool = False,
                    shape: Optional[Tuple[int, int]] = None, dtype=None,
                    batch: Optional[int] = None, stats: Optional[SolveStats] = None,
                    device=None, mesh=None) -> SolveOptions:
    """Resolve the open config knobs for a batch of ``batch`` LPs of ``shape``
    = (m, n) in ``dtype`` on ``device``.

    The one implementation shared by :func:`solve_canonical` (which
    resolves once up front, so every round of a solve runs one backend)
    and the serve loop (once per shape class, at admission).  On a shared
    batch the simplex names first promote to their shared counterparts
    (``"cuda"`` -> ``"cuda-shared"``, ``"torch"`` -> ``"torch-shared"``):
    the revised engine is the simplex solver for that container.

    With ``options.autotune`` on (the default ``"predict"``) and the
    shape known, the cost-model autotuner (``runtime/autotune.py``) fills
    every open knob (``backend="auto"``, ``layout=None``) and records the
    decision into ``stats`` (``SolveStats.autotuned``, ``autotune_log``).
    With ``autotune="off"`` only ``"auto"`` is resolved, through
    :func:`~repro_torch.core.backends.route_shape` (``shape`` is needed
    for a dense batch), and concrete backends pass through.  Either way
    a batch routed to ``pdhg`` gets ``rule``/``layout`` reset to their
    defaults, since those knobs configure the simplex leg and ``pdhg``
    rejects them, and a batch routed to the simplex leg drops
    ``crossover``, which polishes first-order answers only (the
    reference raises there, so ``"auto"`` with ``crossover=True`` could
    not serve traffic on both sides of the frontier).  Under a ``mesh``
    with ``autotune="trial"``, the one resolution that depends on timing,
    every rank takes the mesh's first rank's winner.
    """
    if mesh is not None and options.autotune == "trial":
        mine = resolve_backend(options, shared, shape, dtype, batch, stats, device)
        return _spmd.broadcast_choice(mesh, mine)
    if shared:
        promote = {"cuda": "cuda-shared", "torch": "torch-shared"}
        if options.backend in promote:
            options = options.replace(backend=promote[options.backend])
    if options.autotune != "off" and shape is not None:
        from ..runtime import autotune as _autotune

        m, n = shape
        return _autotune.resolve(m, n, torch.float32 if dtype is None else dtype, options,
                                 shared=shared, batch=batch, stats=stats, device=device)
    if options.backend != "auto":
        return options
    if not shared and shape is None:
        raise ValueError("backend='auto' needs the batch's shape (m, n) to resolve")
    m, n = shape if shape is not None else (0, 0)
    resolved = route_shape(m, n, options.replace(autotune="off"), shared=shared)
    if resolved == "pdhg":
        return options.replace(backend=resolved, rule=LPC, layout=None)
    # The simplex leg returns vertices already: nothing to polish.
    return options.replace(backend=resolved, crossover=False)


def admission_order(requests: Sequence[Tuple[int, Optional[float], int, int]],
                    now: int = 0, starvation_rounds: int = 8) -> list:
    """Admission order of the serve loop: EDF with a starvation bound.

    Each request is ``(ticket, deadline, priority, submitted_round)``:
    ``deadline`` is an absolute time on any monotone clock (None sorts
    last), a larger ``priority`` wins among equal deadlines, and
    ``submitted_round`` is the scheduler round the request arrived in.
    A request that has waited ``starvation_rounds`` rounds is aged: it
    outranks every request that is not, and the aged drain FIFO.  The
    rest go by earliest deadline, then descending priority, then ticket.
    Returns the indices into ``requests`` in admission order.
    """
    def key(i):
        ticket, deadline, priority, submitted = requests[i]
        aged = (now - submitted) >= starvation_rounds
        deadline = math.inf if deadline is None else float(deadline)
        return (0 if aged else 1, submitted if aged else 0, deadline, -priority, ticket)

    return sorted(range(len(requests)), key=key)


def _finite_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite mask over the trailing axes: ``(B, ...) -> (B,)``."""
    return torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=-1)


def state_health(state) -> Optional[torch.Tensor]:
    """(B,) bool: the rows of a carried state whose floating tensors are all finite.

    Covers every state record (the tableau of a
    :class:`~repro_torch.core.lp.ResumeState`, ``binv``/``xb`` of the
    revised record, the PDHG iterates).  None for a state with no
    floating tensor.  A state split over a mesh carries the mask of
    every row, gathered with the round's solution.
    """
    if isinstance(state, _spmd.ShardedState):
        return state.healthy
    ok = None
    for f in dataclasses.fields(state):
        leaf = getattr(state, f.name)
        if not leaf.is_floating_point():
            continue
        rows = _finite_rows(leaf)
        ok = rows if ok is None else ok & rows
    return ok


def apply_guardrails(sol: LPSolution, state=None) -> LPSolution:
    """Retire non-finite rows with the ``NUMERICAL`` status.

    A row is flagged when it claims OPTIMAL with a non-finite objective
    or point, or when its carried state (row-aligned with ``sol``) holds
    a non-finite value.  Other non-OPTIMAL rows carry -inf objectives by
    design and pass.  Flagged rows report ``NUMERICAL``, objective NaN
    and a zero point.  On a healthy batch every select is the identity,
    so results are bit-identical with the guardrails on or off; the mask
    is a few element-wise launches and no host sync.
    """
    bad = (sol.status == OPTIMAL) & ~(torch.isfinite(sol.objective) & _finite_rows(sol.x))
    if state is not None:
        healthy = state_health(state)
        if healthy is not None:
            bad = bad | ~healthy
    return LPSolution(
        objective=torch.where(bad, torch.full_like(sol.objective, float("nan")), sol.objective),
        x=torch.where(bad[:, None], torch.zeros_like(sol.x), sol.x),
        status=torch.where(bad, torch.full_like(sol.status, NUMERICAL), sol.status),
        iterations=sol.iterations,
        basis=sol.basis,
        y=sol.y,
    )


def _quarantine_resolve(batch, sol: LPSolution, options: SolveOptions,
                        stats: Optional[SolveStats] = None) -> LPSolution:
    """Re-solve the ``NUMERICAL`` rows on the float64 oracle (``quarantine=True``).

    Rows whose inputs are not finite are left flagged (no verdict is
    possible); the rest run through ``core/oracle.py:solve_batch`` under
    a ``max(400, 2 (m + n))`` pivot budget, as the certificate
    confirmation does.  A row takes the oracle's verdict where it
    reaches one (OPTIMAL, UNBOUNDED, INFEASIBLE) and stays ``NUMERICAL``
    otherwise: no certificate is fabricated.
    """
    status = sol.status.cpu().numpy()
    flagged = np.nonzero(status == NUMERICAL)[0]
    if flagged.size == 0:
        return sol
    from . import oracle as _oracle

    dev = sol.status.device
    sub = batch.take(torch.as_tensor(flagged, device=batch.b.device))
    if isinstance(sub, SharedLPBatch):
        sub = sub.densify()
    a, b, c = (t.cpu().double().numpy() for t in (sub.a, sub.b, sub.c))
    finite = np.isfinite(a).all(axis=(1, 2)) & np.isfinite(b).all(axis=1) & np.isfinite(c).all(axis=1)
    keep = np.nonzero(finite)[0]
    if keep.size == 0:
        return sol
    obj, xs, ostatus, iters = _oracle.solve_batch(
        a[keep], b[keep], c[keep], max_iters=max(400, 2 * (batch.m + batch.n)))
    if stats is not None:
        stats.quarantined += int(keep.size)
    confirmed = np.nonzero(ostatus != ITER_LIMIT)[0]
    if confirmed.size == 0:
        return sol
    rows = torch.as_tensor(flagged[keep[confirmed]], device=dev)
    part = LPSolution(
        objective=torch.as_tensor(obj[confirmed], device=dev).to(sol.objective.dtype),
        x=torch.as_tensor(xs[confirmed], device=dev).to(sol.x.dtype),
        status=torch.as_tensor(ostatus[confirmed], dtype=torch.int32, device=dev),
        iterations=torch.as_tensor(iters[confirmed], dtype=torch.int32, device=dev),
    )
    return _scatter_solution(sol, rows, part)


def solve_canonical(
    batch: Union[LPBatch, SharedLPBatch],
    options: Optional[SolveOptions] = None,
    stats: Optional[SolveStats] = None,
    mesh=None,
    batch_axes: Sequence[str] = ("data",),
) -> LPSolution:
    """Solve a canonical batch (``max c.x, Ax <= b, x >= 0``): the round scheduler.

    ``options`` picks the round plan (:func:`_round_plan`: one round, the
    legacy ``first_cap`` two-pass, or ``compaction`` with scratch or
    basis ``resume``; compaction wins over ``first_cap``).  Runs where
    the batch's tensors live, or split over ``mesh``'s ``batch_axes``
    (each rank on its own rows, on the mesh's device; every rank returns
    the whole solution).  A ``SharedLPBatch`` runs on the shared
    backends, or densified on an explicitly named other backend; an
    ``LPBatch`` on a shared backend raises ``ValueError``.  ``stats``
    accumulates the counters of every dispatch (one sync each).  Returns
    one result row per input LP, in input order.
    """
    options = options or SolveOptions()
    split = _spmd.resolve_split(mesh, batch_axes)
    if batch.batch == 0:
        return empty_solution(batch.n, batch.a.dtype,
                              batch.a.device if split is None else split.device)
    shared = isinstance(batch, SharedLPBatch)
    options = resolve_backend(options, shared, (batch.m, batch.n), dtype=batch.a.dtype,
                              batch=batch.batch, stats=stats,
                              device=batch.a.device if split is None else split.device,
                              mesh=mesh if split is not None else None)
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
    backend = get_backend(options.backend)
    use_resume = (options.resume == "basis" and options.compaction != "off"
                  and backend.supports_resume)
    caps, carry_iters = _round_plan(batch, options, incremental=use_resume, backend=backend)
    base = options.replace(compaction="off", first_cap=None, resume="scratch")

    sol: Optional[LPSolution] = None
    state = None
    state_idx: Optional[np.ndarray] = None  # the rows `state` holds (None: all)
    iter_offset = 0
    for r, cap in enumerate(caps):
        want_state = use_resume and r < len(caps) - 1
        if sol is None:
            idx, active, sub, sub_state = None, None, batch, None
        else:
            # The round's one host sync: which rows hit the last cap.
            active = torch.nonzero(sol.status == ITER_LIMIT).flatten().cpu().numpy()
            if active.size == 0:
                break
            idx = torch.as_tensor(active, device=sol.status.device)
            sub = batch.take(torch.as_tensor(active, device=batch.b.device))
            sub_state = None
            if state is not None:
                # Survivors are a subset of the rows the last round held.
                local = active if state_idx is None else np.searchsorted(state_idx, active)
                sub_state = state.take(torch.as_tensor(local, device=batch.b.device))
                state = None  # the round's gathered copy is all that is needed
        part, part_state = dispatch_round_safe(sub, base.replace(max_iters=cap), stats,
                                               state=sub_state, want_state=want_state,
                                               mesh=mesh, batch_axes=batch_axes)
        if options.guardrails:
            part = apply_guardrails(part, part_state)
        if stats is not None and sub_state is not None:
            stats.resumed += sub.batch
        if idx is None:
            sol = part
        else:
            sol = _scatter_solution(sol, idx, part, iter_offset=iter_offset,
                                    accumulate=use_resume)
            state_idx = active
        state = part_state
        if carry_iters:
            iter_offset += cap

    def post(fn, sol):
        # Row-local post-passes: under a mesh each rank takes its own rows.
        if split is None:
            return fn(batch, sol)
        return _spmd.map_rows(split, fn, batch, sol)

    if options.backend == "pdhg":
        # Both post-passes run once, on the merged solution.  Confirmation
        # first: it may revoke a heuristic flag, and crossover polishes
        # only real optima.
        sol = post(lambda b, s: _pdhg.confirm_certificates(b, s, options), sol)
        if options.crossover:
            sol = post(lambda b, s: _pdhg.crossover(b, s, options), sol)
    if options.quarantine:
        # Last: it reads only NUMERICAL rows, which neither post-pass touches.
        # Each rank counts its own re-solved rows; the mesh sums them.
        counted = SolveStats()
        sol = post(lambda b, s: _quarantine_resolve(b, s, options, counted), sol)
        if stats is not None:
            stats.quarantined += (counted.quarantined if split is None
                                  else _spmd.total(split, counted.quarantined))
    return sol


def dispatch_round_safe(
    batch: Union[LPBatch, SharedLPBatch], options: SolveOptions,
    stats: Optional[SolveStats] = None, state=None, want_state: bool = False,
    mesh=None, batch_axes: Sequence[str] = ("data",),
):
    """:func:`dispatch_round` with retry from the carried state.

    ``dispatch_round`` mutates neither ``batch`` nor ``state``, so after a
    transient failure (an injected ``ChaosError``, a device runtime
    error) the same round is dispatched again from the same state, and
    the exact-resume protocol makes the retry bit-identical to a round
    that did not fail.  The retry stays on the same backend: no plain
    version stands in for a kernel.  Retry k sleeps
    ``min(options.retry_backoff * 2**k, RETRY_BACKOFF_CAP)`` first.  After
    ``options.retry_budget`` failed retries, or at once on an error in
    ``runtime/chaos.py:NON_TRANSIENT``, the exception propagates.  The
    clean path is one ``try``.  Counters booked by an aborted attempt's
    finished chunks are not rolled back.  Under a mesh every rank sees
    the same failure (:meth:`~repro_torch.core.spmd.BatchSplit.agree`),
    so all ranks retry, or raise, together.
    """
    budget = options.retry_budget
    # Unsplit rounds keep dispatch_round's unsplit call (wrappers of it stay valid).
    split = {} if mesh is None else dict(mesh=mesh, batch_axes=batch_axes)
    for attempt in range(budget + 1):
        try:
            return dispatch_round(batch, options, stats, state=state, want_state=want_state,
                                  **split)
        except Exception as exc:
            if attempt >= budget or not _chaos.is_transient(exc):
                raise
            if stats is not None:
                stats.retries += 1
                if isinstance(exc, _chaos.ChaosError):
                    stats.faults_injected += 1
            delay = min(options.retry_backoff * (2 ** attempt), RETRY_BACKOFF_CAP)
            if delay > 0:
                time.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


def _solve_chunk(backend: Backend, cur, cur_state, options: SolveOptions, want_state: bool):
    if cur_state is not None:
        return backend.resume_canonical(cur, cur_state, options)
    if want_state:
        return backend.start_canonical(cur, options)
    return backend.solve_canonical(cur, options), None


def _state_bytes_per_lp(backend: Backend, batch, options: SolveOptions) -> int:
    """One LP's solver-state bytes on ``backend`` (``SolveStats.tableau_bytes``)."""
    if backend.name == "pdhg":
        return _pdhg.state_bytes_per_lp(batch.m, batch.n, batch.a.dtype)
    if backend.name in SHARED_BACKENDS:
        return _revised.state_bytes_per_lp(batch.m, batch.n, batch.a.dtype)
    return TableauSpec(batch.m, batch.n, options.effective_layout).bytes_per_lp(batch.a.dtype)


def dispatch_round(
    batch: Union[LPBatch, SharedLPBatch], options: SolveOptions,
    stats: Optional[SolveStats] = None, state=None, want_state: bool = False,
    mesh=None, batch_axes: Sequence[str] = ("data",),
):
    """One dispatch round: chunk, solve, concatenate, record -> ``(LPSolution, state)``.

    The only place that talks to a backend for canonical batches (through
    :func:`dispatch_round_safe`: the round scheduler above and
    ``SolveSession.resume_round``).  ``options.max_iters`` is the round's
    budget and ``options.backend`` a concrete name.  ``state`` continues
    a carried state (row-aligned with ``batch``); ``want_state`` returns
    the terminal state, else ``None``.  An active
    ``runtime/chaos.py:ChaosMonkey`` is consulted before the round, before
    each chunk and on the outgoing state.  With ``options.speculation``
    a round of several chunks goes through :func:`_speculative_chunks`.
    Under a ``mesh`` the round is split over its ``batch_axes``
    (:func:`_dispatch_split`).
    """
    split = _spmd.resolve_split(mesh, batch_axes)
    if split is not None:
        return _dispatch_split(batch, options, stats, state, want_state, split)
    monkey = _chaos.active()
    chaos_round = monkey.on_round(options.backend) if monkey is not None else None
    backend = get_backend(options.backend)
    bsz = batch.batch
    chunk = options.chunk_size or bsz
    if stats is not None:
        stats.record_tableau(min(chunk, bsz) * _state_bytes_per_lp(backend, batch, options))
    ranges = [slice(lo, min(lo + chunk, bsz)) for lo in range(0, bsz, chunk)]
    if options.speculation and len(ranges) > 1:
        parts, state_parts = _speculative_chunks(batch, state, options, backend, want_state,
                                                 stats, ranges, monkey, chaos_round)
    else:
        parts, state_parts = [], []
        for k, rows in enumerate(ranges):
            if monkey is not None:
                monkey.on_chunk(chaos_round, k)
            before = backend.cache_size() if stats is not None and backend.cache_size else None
            out, out_state = _solve_chunk(backend, batch.take(rows),
                                          None if state is None else state.take(rows),
                                          options, want_state)
            if before is not None:
                stats.record_cache(before, backend.cache_size())
            if stats is not None:
                stats.record(out)
            parts.append(out)
            if out_state is not None:
                state_parts.append(out_state)
    sol = parts[0] if len(parts) == 1 else _concat_solutions(parts)
    out_state = concat_states(state_parts) if want_state else None
    if monkey is not None and out_state is not None:
        # NaN in scheduled rows of the OUTGOING state: the corruption the
        # next guardrail check must catch.
        out_state, poisoned = monkey.poison_state(chaos_round, out_state)
        if poisoned and stats is not None:
            stats.faults_injected += poisoned
    return sol, out_state


def _dispatch_split(batch, options: SolveOptions, stats: Optional[SolveStats], state,
                    want_state: bool, split: "_spmd.BatchSplit"):
    """One round split over a mesh: :func:`dispatch_round` on this rank's rows,
    then one agreement and one gather.

    Without a :class:`~repro_torch.core.spmd.ShardedState` the batch (and
    a full ``state``, given to every rank) is padded with copies of its
    last row to a multiple of ``split.div`` and cut into equal blocks,
    the reference's plan under a mesh; a rank solves its block in chunks
    of ``chunk_size // div`` and keeps the rows that are not padding.
    With one, each rank solves the rows it owns from its own state rows.
    The chaos hooks act on this rank's part.  The outgoing state is a
    ``ShardedState`` that holds this rank's rows.  ``stats`` books what
    the unsplit round books (the merged solution in chunks of
    ``chunk_size``), the same on every rank.
    """
    backend = get_backend(options.backend)
    bsz = batch.batch
    if isinstance(state, _spmd.ShardedState):
        owner = state.owner
        solved = np.nonzero(owner == split.block)[0]
        local_state = state.local
        order = np.argsort(owner, kind="stable")  # row numbers in block order
    else:
        owner, per = split.even_owner(bsz)
        solved = np.minimum(np.arange(split.block * per, (split.block + 1) * per), bsz - 1)
        local_state = None if state is None else state.take(_rows(solved, state))
        order = None
    keep = int(np.count_nonzero(owner == split.block))
    counts = np.bincount(owner, minlength=split.div).tolist()
    chunk = None if options.chunk_size is None else max(1, options.chunk_size // split.div)
    local = SolveStats()  # this rank's counters; the merged solution is booked below
    local_sol = out_state = health = exc = None
    try:
        if solved.size:
            cur = _spmd.to_device(batch.take(_rows(solved, batch)), split.device)
            if local_state is not None:
                local_state = _spmd.to_device(local_state, split.device)
            local_sol, out_state = dispatch_round(
                cur, options.replace(chunk_size=chunk, speculation=False), local,
                state=local_state, want_state=want_state)
            if keep < solved.size:  # this block's padding replicas
                local_sol = _spmd.solution_rows(local_sol, slice(0, keep))
                if want_state:
                    out_state = out_state.take(slice(0, keep))
            if want_state:
                health = state_health(out_state)
        elif _chaos.active() is not None:
            _chaos.active().on_round(options.backend)  # a rank with no rows counts the round too
    except Exception as err:  # agreed in the gather: every rank raises
        exc = err
    sol, healthy, (grew,) = _spmd.gather_solution(
        split, local_sol, counts, batch.n, batch.a.dtype, exc, health, header=[local.compiles])
    sol, healthy = _spmd.in_row_order(sol, order, healthy)
    if stats is not None:
        stats.faults_injected += local.faults_injected
        chunk = options.chunk_size or bsz
        stats.record_tableau(min(chunk, bsz) * _state_bytes_per_lp(backend, batch, options))
        for k, lo in enumerate(range(0, bsz, chunk)):
            if backend.cache_size:
                stats.record_cache(0, grew if k == 0 else 0)
            stats.record(_spmd.solution_rows(sol, slice(lo, lo + chunk)))
    out = _spmd.ShardedState(out_state, owner, split.block, healthy) if want_state else None
    return sol, out


def _rows(rows: np.ndarray, record):
    """Rows ``rows`` of a batch or state as an index: a slice where they are a
    run (a view, no copy of the rank's block), else an index tensor."""
    if rows.size and np.all(np.diff(rows) == 1):
        return slice(int(rows[0]), int(rows[-1]) + 1)
    return torch.as_tensor(rows, device=_spmd._device_of(record))


def _cross_streams(value, stream: "torch.cuda.Stream") -> None:
    """``record_stream`` on every CUDA tensor of a batch, state or solution."""
    if value is None:
        return
    for f in dataclasses.fields(value):
        t = getattr(value, f.name)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)


def _speculative_chunks(batch, state, options: SolveOptions, backend: Backend,
                        want_state: bool, stats: Optional[SolveStats], ranges, monkey,
                        chaos_round):
    """The chunks of one round as straggler-mitigated work units (``speculation``).

    Each chunk is a unit of ``runtime/straggler.py:run_with_speculation``:
    worker threads solve the chunks, and a chunk past the deadline
    ``alpha * median(finished chunk times)`` is dispatched again on an
    idle worker; the first result wins, and since a solve is
    deterministic the twin's answer is the same bits.  On the card each
    attempt launches on a stream of its own (the kernels launch on the
    current stream): the worker's stream waits on the caller's before it
    reads the inputs, the attempt blocks on its stream before it reports
    (so the deadline sees real durations), and the caller's stream waits
    on the winners' before it reads the outputs.  ``record_stream`` marks
    each tensor that crosses streams, so the allocator does not hand its
    memory out again while another stream may still use it (a losing
    attempt may still run when the round returns).  Specialisations are
    booked once for the whole round; results and counters equal the
    serial loop's.
    """
    from ..runtime.straggler import run_with_speculation

    dev = batch.a.device
    caller = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    before = backend.cache_size() if stats is not None and backend.cache_size else None

    def solve_unit(payload, worker):
        k, rows = payload
        if monkey is not None:
            monkey.on_chunk(chaos_round, k)
        cur = batch.take(rows)
        cur_state = None if state is None else state.take(rows)
        if caller is None:
            return _solve_chunk(backend, cur, cur_state, options, want_state)
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(caller)
        _cross_streams(cur, stream)
        _cross_streams(cur_state, stream)
        with torch.cuda.stream(stream):
            out, out_state = _solve_chunk(backend, cur, cur_state, options, want_state)
        stream.synchronize()
        return out, out_state, stream

    report = run_with_speculation(list(enumerate(ranges)), solve_unit,
                                  n_workers=min(4, len(ranges)))
    parts, state_parts = [], []
    for unit in report.results:
        out, out_state = unit.value[:2]
        if caller is not None:
            caller.wait_stream(unit.value[2])
            _cross_streams(out, caller)
            _cross_streams(out_state, caller)
        if stats is not None:
            stats.record(out)
        parts.append(out)
        if out_state is not None:
            state_parts.append(out_state)
    if before is not None:
        stats.record_cache(before, backend.cache_size())
    return parts, state_parts


def solve_hyperbox(
    lo,
    hi,
    directions,
    options: Optional[SolveOptions] = None,
    stats: Optional[SolveStats] = None,
    device=None,
    mesh=None,
    batch_axes: Sequence[str] = ("data",),
) -> LPSolution:
    """Closed-form box-LP batch through the selected backend.

    ``lo``/``hi`` broadcast to ``directions`` (B, n).  Array-likes and
    tensors go to ``device`` (None = the card; raises without one).
    Under a ``mesh`` each rank solves its block of B / (the batch axes'
    product) rows on the mesh's device and every rank returns the whole
    solution; a B that does not split evenly raises ``ValueError`` on
    every rank, as the reference's sharded placement does (the box path
    does not pad).
    """
    options = options or SolveOptions()
    if options.backend == "auto":
        # Box LPs are closed-form: the simplex/first-order question of
        # "auto" does not arise, and the hyperbox kernel answers them.
        options = options.replace(backend="cuda")
    split = _spmd.resolve_split(mesh, batch_axes)
    dev = resolve_device(device) if split is None else None
    directions = _tensor(directions, device=dev)
    dtype = directions.dtype
    lo = _tensor(lo, dtype=dtype, device=directions.device)
    hi = _tensor(hi, dtype=dtype, device=directions.device)
    backend = get_backend(options.backend)
    if split is None:
        if directions.shape[0] == 0:
            return empty_solution(directions.shape[-1], dtype, dev)
        sol = backend.solve_hyperbox(lo, hi, directions, options)
    else:
        sol = _hyperbox_split(backend, lo, hi, directions, options, split)
    if stats is not None:
        stats.record(sol)
    return sol


def _hyperbox_split(backend: Backend, lo, hi, directions, options: SolveOptions,
                    split: "_spmd.BatchSplit") -> LPSolution:
    """This rank's block of box LPs on its device, then the gather."""
    bsz, n = directions.shape
    if bsz % split.div:
        raise ValueError(
            f"solve_hyperbox: {bsz} box LPs do not split evenly over the mesh's batch axes "
            f"{split.axes} ({split.div} blocks); the box path does not pad")
    if bsz == 0:
        return empty_solution(n, directions.dtype, split.device)
    per = bsz // split.div
    rows = slice(split.block * per, (split.block + 1) * per)
    local, exc = None, None
    try:
        local = backend.solve_hyperbox(
            *(t.expand(bsz, n)[rows].to(split.device) for t in (lo, hi, directions)), options)
    except Exception as err:  # agreed in the gather: every rank raises
        exc = err
    sol, _, _ = _spmd.gather_solution(split, local, [per] * split.div, n, directions.dtype, exc)
    return sol
