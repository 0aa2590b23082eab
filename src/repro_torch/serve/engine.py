"""Serving engines: the LM decode loop, and the LP serve loop (flush mode
and continuous batching).

Follows ``repro/serve/engine.py``.  :class:`Engine` drives a dense
``models.Model``'s prefill and decode steps over a cache allocated once
and written in place (the reference donates it to its jitted step).
:class:`LPEngine` serves single-LP requests over one persistent
:class:`~repro_torch.core.session.SolveSession`, in two modes:

  * **flush mode**: requests accumulate until ``flush_every`` are
    pending or :meth:`LPEngine.flush` is called, then solve as one
    bucketed megabatch through the session;
  * **continuous mode** (:meth:`LPEngine.step`): each step admits pending
    requests (earliest deadline first, with a starvation bound) into
    per-shape-class in-flight groups, as iteration-0 resume states
    spliced beside the survivors of earlier rounds, and advances every
    group by one capped resume round (``ops.simplex_resume`` or
    ``ops.pdhg_resume`` on the card).  An LP completes the round it
    finishes.  Per-LP results are bit-identical to a one-shot
    ``repro_torch.solve`` of the same problems: the exact-resume protocol
    replays an uninterrupted solve, and every quantity mapped back is a
    function of its row alone (``core/lp.py:row_sum``,
    ``core/pdhg.py:STEP_TILE``).

The reference pads each wave and each round to a power-of-two batch with
a floor of 2, so that XLA reuses its executables and never takes its
batch-1 code path.  A CUDA launch takes any batch size, so the port
dispatches waves and survivors as they are (``ROADMAP.md``, "TPU
mechanics not carried over").

Under a ``mesh`` (``LPEngine(mesh=...)``) every rank runs the same
engine on the same requests: the flush path solves through
``api._solve_problem(..., mesh, ("data",))``, and the continuous path's
groups carry ``ShardedState``s (``core/spmd.py``), each rank resuming
the rows it owns.  Admission is driven by the step count, so ranks that
submit the same requests in the same steps take the same decisions; the
one decision that depends on timing, ``autotune="trial"``, takes the
mesh's first rank's winner.

``serve/loadgen.py`` replays open-loop Poisson traces against both modes;
``launch/serve_lp.py`` is the command-line server.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core import dispatch as _dispatch
from ..core import pdhg as _pdhg
from ..core.backends import SolveOptions, SolveStats, get_backend
from ..core.bucketing import ShapeGrid, shape_class
from ..core.lp import (
    ITER_LIMIT,
    NUMERICAL,
    LPBatch,
    LPSolution,
    _tensor,
    concat_states,
    resolve_device,
)
from ..core.problem import (
    Canonicalized,
    LPProblem,
    canonicalize,
    stack_problems,
    uncanonicalize,
    validate_problem,
)
from ..core.session import SolveSession, _on
from ..core.spmd import ShardedState
from ..sharding import collectives as coll
from ..sharding import partition
from ..runtime import chaos as _chaos



class Engine:
    """Greedy (or sampled) continuation of a batch of prompts.

    ``model`` is a ``models.Model``; it moves to ``device`` (the card
    unless the caller passes ``device="cpu"``).  ``max_len`` bounds the
    prompt plus the generated tokens; ``enc_len`` sizes the
    encoder-decoder's cross-attention caches (its frames' length), as the
    reference's ``Engine`` takes it.
    """

    def __init__(self, model, max_len: int, enc_len: int = 0, *, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.max_len = max_len
        self.enc_len = enc_len
        #: The last ``generate``'s cache: allocated once, updated in place.
        self.cache = None

    @torch.inference_mode()
    def generate(self, inputs, steps: int, temperature: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
        """(B, steps) int32 tokens: one from the prefill's logits, then one a
        decode step.

        ``inputs``: ``tokens`` (B, S), and as the model needs them
        ``frames`` (B, Senc, D), ``patch_embeds`` (B, P, D) and
        ``positions`` (B, S, 3), all given to the prefill; the decode steps
        take the sampled tokens alone (positions from the cache index), as
        the reference's ``Engine`` runs them.

        Greedy decoding takes the first maximum (``argmax``, as
        ``jnp.argmax``); ``temperature > 0`` samples from
        ``softmax(logits / temperature)`` with a ``torch.Generator`` seeded
        by ``seed`` (its bits differ from ``jax.random.categorical``).

        Under a mesh (``with partition.activate(mesh)``, the model built
        under it), every rank is given the whole batch, runs its rows
        (``models/model.py``) and samples them, and the sampled tokens are
        gathered over the batch axes: every rank returns the whole
        (B, steps).  Greedy tokens do not depend on the split; sampling
        seeds each block of rows with ``seed`` plus its first row's index,
        so its tokens differ from one process's (and from the
        reference's).
        """
        tokens = _tensor(inputs["tokens"], torch.int32, self.device)
        b, prompt_len = tokens.shape
        if prompt_len + steps - 1 > self.max_len:
            raise ValueError(f"{prompt_len} prompt + {steps} steps exceed max_len {self.max_len}")
        rows = partition.batch_rows(b)
        gen = torch.Generator(device=self.device).manual_seed(seed + rows.start)
        prompt = {"tokens": tokens}
        for k, dt in (("frames", None), ("patch_embeds", None), ("positions", torch.int32)):
            if k in inputs:
                prompt[k] = _tensor(inputs[k], dt, self.device)
        self.cache = self.model.init_cache(b, self.max_len, enc_len=self.enc_len)
        logits, _ = self.model.prefill(prompt, self.cache)
        cur = coll.gather_rows(self._sample(logits[:, -1], temperature, gen), b)
        out = [cur]
        for i in range(steps - 1):
            logits, _ = self.model.decode_step({"tokens": cur[:, None]}, self.cache, prompt_len + i)
            cur = coll.gather_rows(self._sample(logits[:, -1], temperature, gen), b)
            out.append(cur)
        return torch.stack(out, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float, gen: torch.Generator) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


@dataclasses.dataclass
class _Group:
    """One in-flight canonical shape class of the continuous serve loop.

    Rows of ``batch``/``state``/``c_user``/``shift`` and the entries of the
    bookkeeping lists are aligned: row i is the LP of ``tickets[i]``.
    Retirement gathers finished rows out and admission concatenates
    newcomers on: the tensors are the spliced round the scheduler
    dispatches each step.
    """

    options: SolveOptions  # resolved: the class's concrete backend
    full_cap: int  # per-LP total iteration budget (auto rule resolved)
    quantum: int  # per-round incremental budget
    sign: int  # +1 maximize / -1 minimize (for uncanonicalize)
    split: bool  # canonical x+/x- split flag (for uncanonicalize)
    cn: int  # padded user variable count (the class width)
    batch: LPBatch  # canonical rows (basis0 consumed by the init state)
    state: object  # backend resume state, row-aligned with batch
    c_user: torch.Tensor  # (B, cn) user objectives
    shift: torch.Tensor  # (B, cn) lower-bound shifts
    tickets: List[int]
    remaining: List[int]  # per-row iteration budget left
    done: List[int]  # per-row iterations spent so far
    true_n: List[int]  # per-row unpadded variable count


def _scatter_rows(full: torch.Tensor, idx: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    out = full.clone()
    out[idx] = part
    return out


def _scatter_state(state, idx: torch.Tensor, part):
    """``state`` with rows ``idx`` replaced by ``part``'s (a split state by its owners)."""
    if isinstance(state, ShardedState):
        return state.scatter(idx, part)
    return dataclasses.replace(state, **{
        f.name: _scatter_rows(getattr(state, f.name), idx, getattr(part, f.name))
        for f in dataclasses.fields(state)})


class LPEngine:
    """LP server over one persistent session: flush mode and continuous mode.

    Requests are single-LP :class:`~repro_torch.core.problem.LPProblem`\\ s
    of any shape, on any device, submitted for a ticket and redeemed with
    :meth:`result`.  The engine solves on ``device`` (None = the card;
    pass ``device="cpu"`` for the CPU) and moves each admitted wave
    there.

    **Flush mode**: requests accumulate until ``flush_every`` are pending
    or :meth:`flush` is called; a flush is one bucketed megabatch solve.

    **Continuous mode**: drive :meth:`step`.  Each step admits pending
    requests into per-shape-class groups, ordered by
    :func:`~repro_torch.core.dispatch.admission_order` (earliest
    deadline, then priority; a request waits at most
    ``starvation_rounds`` rounds before it outranks every later arrival)
    or in submission order, and advances every group by one capped
    round.  Newcomers enter as iteration-0 states
    (``Backend.init_canonical``) concatenated with the carried survivors,
    so one resume dispatch a round advances both (``stats.spliced``
    counts newcomers that joined a non-empty group).  Requests that
    cannot be spliced (boxlike problems, whose closed form has nothing
    to iterate, and backends without the state hooks, such as
    ``reference``) complete at admission through the one-shot path.

    With ``SolveOptions(backend="auto")`` each shape class resolves once,
    at admission, through the routing table: the simplex kernel below the
    frontier, ``pdhg`` from it on (whose groups get the certificate
    confirmation and, with ``crossover=True``, the polish as their rows
    retire).

    **Faults**: every round goes through
    ``core/dispatch.py:dispatch_round_safe``, which re-dispatches a
    round that failed transiently from the same carried state, on the
    same backend, up to ``options.retry_budget`` times.  A round that
    still fails retires only its own group through the dead-letter path
    (tickets complete ``NUMERICAL``; ``dead_letters``,
    ``stats.dead_lettered``); other groups keep advancing.  Errors in
    ``runtime/chaos.py:NON_TRANSIENT`` (bad arguments, a kernel that did
    not build, load or launch) propagate out of :meth:`step`.  Rows whose carried
    state went non-finite are caught by the per-round guardrails and
    retire ``NUMERICAL`` one by one.

    Parameters
    ----------
    options : SolveOptions, optional
        The configuration of every request.
    flush_every : int, default 256
        Auto-flush threshold of flush mode; continuous callers that never
        want a stop-the-world flush set it large.
    grid : sequence of (int, int), optional
        Pinned shape classes (``core/bucketing.py:shape_class``).
    stats : SolveStats, optional
        The record to accumulate into; a fresh one by default.
    step_iters : int, default 0
        Per-round iteration budget of continuous mode; 0 means
        ``8 (m' + n')`` of each canonical class.
    max_inflight : int, optional
        At most this many LPs in flight across all groups (None: admit
        everything pending each step).
    admission : {"edf", "fifo"}, default "edf"
        Admission order.
    starvation_rounds : int, default 8
        Rounds a request may wait before it ages ahead of every request
        that has not.
    clock : callable, default time.monotonic
        The time source that deadlines are measured on
        (``deadline_misses`` counts completions past their deadline).
    device : str or torch.device, optional
        Where the engine solves.
    mesh : DeviceMesh, optional
        Split every solve and round over the mesh's ``"data"`` axis; every
        rank drives the engine alike and gets every result.
    """

    def __init__(
        self,
        options: Optional[SolveOptions] = None,
        flush_every: int = 256,
        grid: Optional[ShapeGrid] = None,
        stats: Optional[SolveStats] = None,
        *,
        step_iters: int = 0,
        max_inflight: Optional[int] = None,
        admission: str = "edf",
        starvation_rounds: int = 8,
        clock: Callable[[], float] = time.monotonic,
        device=None,
        mesh=None,
    ):
        if admission not in ("edf", "fifo"):
            raise ValueError(f'admission must be "edf" or "fifo", got {admission!r}')
        self.options = options or SolveOptions()
        self.flush_every = flush_every
        self.grid = grid
        self.mesh = mesh
        self.session = SolveSession(self.options, mesh=mesh, grid=grid, stats=stats,
                                    device=device)
        self.step_iters = int(step_iters)
        self.max_inflight = max_inflight
        self.admission = admission
        self.starvation_rounds = int(starvation_rounds)
        self.clock = clock
        self.deadline_misses = 0
        # Tickets retired through the dead-letter path: their group's round
        # kept failing after every retry, so the whole group completed
        # NUMERICAL rather than stalling the other shape classes.
        self.dead_letters: List[int] = []
        self._pending: List[Tuple[int, LPProblem]] = []
        self._pending_ids: Set[int] = set()
        # ticket -> (deadline, priority, submitted_step): the admission order
        self._meta: Dict[int, Tuple[Optional[float], int, int]] = {}
        self._results: Dict[int, LPSolution] = {}
        self._inflight: Dict[int, Tuple] = {}  # ticket -> group key
        self._groups: Dict[Tuple, _Group] = {}
        self._next_ticket = 0
        self._step_count = 0

    @property
    def device(self) -> torch.device:
        return self.session.device

    @property
    def stats(self) -> SolveStats:
        """Cumulative counters of every dispatch this engine made."""
        return self.session.stats

    @property
    def pending_count(self) -> int:
        """Requests submitted but not yet admitted or flushed."""
        return len(self._pending)

    @property
    def inflight_count(self) -> int:
        """LPs the continuous scheduler's groups carry."""
        return len(self._inflight)

    # -- submission ---------------------------------------------------------

    def submit(self, problem: LPProblem, deadline: Optional[float] = None,
               priority: int = 0) -> int:
        """Queue one request; returns a ticket redeemable once it completes.

        ``deadline`` is an absolute completion time on the engine's
        ``clock``: it orders EDF admission and feeds ``deadline_misses``,
        and never cancels work.  ``priority`` breaks ties among equal
        deadlines (larger wins).  Raises ``ValueError`` before a ticket is
        allocated when the problem holds NaN, or Inf where finite data is
        required (the message names the field), or when ``deadline`` is
        NaN or negative.
        """
        if isinstance(problem, LPProblem):
            validate_problem(problem, where="submit: problem")
        if deadline is not None:
            deadline = float(deadline)
            if np.isnan(deadline) or deadline < 0.0:
                raise ValueError(
                    f"submit: deadline must be a non-negative clock time (or None), "
                    f"got {deadline!r}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, problem))
        self._pending_ids.add(ticket)
        self._meta[ticket] = (deadline, int(priority), self._step_count)
        if len(self._pending) >= self.flush_every:
            self.flush()
        return ticket

    def done(self, ticket: int) -> bool:
        """Whether a ticket's result is ready to redeem."""
        return ticket in self._results

    def cancel(self, ticket: int) -> bool:
        """Drop a still-pending request; False once admitted or solved."""
        if ticket not in self._pending_ids:
            return False
        self._pending = [(t, p) for t, p in self._pending if t != ticket]
        self._pending_ids.discard(ticket)
        self._meta.pop(ticket, None)
        return True

    # -- continuous scheduler -----------------------------------------------

    def step(self) -> List[int]:
        """One scheduler round: admit pending requests, advance every group.

        Returns the tickets that completed this round (admission-time
        one-shot completions included).  Never blocks on a ticket.
        """
        self._step_count += 1
        completed: List[int] = []
        self._admit(completed)
        self._advance(completed)
        return completed

    def _admit(self, completed: List[int]) -> None:
        """Admit pending requests into in-flight groups, in admission order."""
        if not self._pending:
            return
        if self.max_inflight is None:
            capacity = len(self._pending)
        else:
            capacity = self.max_inflight - self.inflight_count
            if capacity <= 0:
                return
        if self.admission == "edf":
            order = _dispatch.admission_order(
                [(t, *self._meta[t]) for t, _ in self._pending], now=self._step_count,
                starvation_rounds=self.starvation_rounds)
        else:
            order = list(range(len(self._pending)))
        # Validate and group BEFORE changing any engine state: a bad request
        # fails the admission without dropping the others.
        waves: Dict[Tuple, Tuple[List[int], List[LPProblem], List[int]]] = {}
        for i in order[:capacity]:
            ticket, p = self._pending[i]
            if not isinstance(p, LPProblem):
                raise TypeError(f"ticket {ticket} holds {type(p).__name__}, expected LPProblem")
            if p.batch != 1:
                raise ValueError(
                    "LPEngine serves single-LP requests (batch == 1); "
                    f"ticket {ticket} has batch {p.batch}: solve it directly")
            cm, cn = shape_class(p.m, p.n, self.grid)
            padded = p.pad_to(cm, cn)
            # Key on the PADDED problem's flags: pad_to can flip boxlike and
            # var_upper, and the flags fix the canonical shape of a group.
            key = (cm, cn, padded.maximize, str(padded.dtype), padded.split,
                   padded.row_lower, padded.var_upper, padded.boxlike)
            tickets, probs, true_ns = waves.setdefault(key, ([], [], []))
            tickets.append(ticket)
            probs.append(padded)
            true_ns.append(p.n)
        for key, (tickets, probs, true_ns) in waves.items():
            self._admit_wave(key, tickets, probs, true_ns, completed)
            wave = set(tickets)
            self._pending = [(t, p) for t, p in self._pending if t not in wave]
            self._pending_ids -= wave

    def _admit_wave(self, key: Tuple, tickets: List[int], padded: List[LPProblem],
                    true_ns: List[int], completed: List[int]) -> None:
        """Splice one shape-class wave into its group (or solve it one-shot)."""
        stacked = _on(stack_problems(padded), self.device)
        if stacked.boxlike:
            # Closed form: nothing to iterate, complete at admission.
            self._complete_oneshot(tickets, stacked, true_ns, completed)
            return
        canon = canonicalize(stacked)
        cb = canon.batch
        g = self._groups.get(key)
        # A wave spliced into a group runs the group's resolution: its state
        # joins the group's (one backend, one layout).
        resolved = g.options if g is not None else self.session.resolve_options(
            cb.m, cb.n, cb.a.dtype, batch=cb.batch)
        backend = get_backend(resolved.backend)
        if not backend.supports_splice:
            self._complete_oneshot(tickets, stacked, true_ns, completed)
            return
        state = self.session.init_state(cb, resolved, joining=None if g is None else g.state)
        batch = LPBatch(cb.a, cb.b, cb.c)
        if g is None:
            full_cap = _dispatch._full_cap(cb, resolved, backend)
            quantum = self.step_iters or 8 * (cb.m + cb.n)
            g = self._groups[key] = _Group(
                options=resolved, full_cap=full_cap, quantum=max(1, min(quantum, full_cap)),
                sign=canon.sign, split=canon.split, cn=canon.n, batch=batch, state=state,
                c_user=canon.c_user, shift=canon.shift, tickets=[], remaining=[], done=[],
                true_n=[])
        else:
            if g.tickets:
                self.stats.spliced += len(tickets)
            g.batch = LPBatch(*(torch.cat([getattr(g.batch, f), getattr(batch, f)])
                                for f in ("a", "b", "c")))
            g.state = concat_states([g.state, state])
            g.c_user = torch.cat([g.c_user, canon.c_user])
            g.shift = torch.cat([g.shift, canon.shift])
        g.tickets.extend(tickets)
        g.remaining.extend([g.full_cap] * len(tickets))
        g.done.extend([0] * len(tickets))
        g.true_n.extend(true_ns)
        for t in tickets:
            self._inflight[t] = key

    def _complete_oneshot(self, tickets: List[int], stacked: LPProblem, true_ns: List[int],
                          completed: List[int]) -> None:
        """Admission-time completion through the one-shot solve path."""
        from .. import api  # lazy: api imports the core this module imports

        sol = api._solve_problem(stacked, self.options, self.stats, self.mesh, ("data",))
        for row, (t, tn) in enumerate(zip(tickets, true_ns)):
            self._finish(t, LPSolution(objective=sol.objective[row:row + 1],
                                       x=sol.x[row:row + 1, :tn],
                                       status=sol.status[row:row + 1],
                                       iterations=sol.iterations[row:row + 1]), completed)

    def _advance(self, completed: List[int]) -> None:
        """One capped round for every in-flight group.

        Faults are isolated per group: a round that still fails after
        ``dispatch_round_safe``'s retries dead-letters that one group,
        while every other group keeps advancing.  Non-transient errors
        propagate.
        """
        for key in list(self._groups):
            g = self._groups[key]
            if g.tickets:
                try:
                    self._step_group(g, completed)
                except Exception as exc:
                    if not _chaos.is_transient(exc):
                        raise
                    self._dead_letter_group(key, g, completed)
                    continue
            if not g.tickets:
                del self._groups[key]

    def _dead_letter_group(self, key: Tuple, g: _Group, completed: List[int]) -> None:
        """Retire a group whose round exhausted the retry budget.

        ``_step_group`` commits nothing until every dispatch of its round
        succeeded, so the bookkeeping here is the last good round's.  Each
        ticket finishes ``NUMERICAL`` with a NaN objective, a zero point
        and the iterations it had banked, and lands in ``dead_letters``
        and ``stats.dead_lettered``.
        """
        dtype, dev = g.batch.a.dtype, g.batch.a.device
        for i, t in enumerate(list(g.tickets)):
            sol = LPSolution(
                objective=torch.full((1,), float("nan"), dtype=dtype, device=dev),
                x=torch.zeros((1, g.true_n[i]), dtype=dtype, device=dev),
                status=torch.full((1,), NUMERICAL, dtype=torch.int32, device=dev),
                iterations=torch.tensor([g.done[i]], dtype=torch.int32, device=dev))
            self.dead_letters.append(t)
            self.stats.dead_lettered += 1
            self._finish(t, sol, completed)
        g.tickets = []
        self._groups.pop(key, None)

    def _step_group(self, g: _Group, completed: List[int]) -> None:
        """Advance one group by one round; retire the rows that finished.

        A row's round budget is ``min(quantum, remaining)``; every row
        starts from ``full_cap``, so a round has at most two distinct
        budgets, each one resume dispatch, and the budgets sum to
        ``full_cap`` exactly, which keeps the replay bit-identical to a
        one-shot solve.  The round is fault-atomic: the per-row deltas
        live in locals until every dispatch of the round succeeded, so a
        failure leaves the group as it was.
        """
        nrows = len(g.tickets)
        incs = np.minimum(g.quantum, np.asarray(g.remaining, np.int64))
        budgets = sorted(set(incs.tolist()))
        dev = g.batch.a.device
        status = np.empty(nrows, np.int32)
        done_inc = np.zeros(nrows, np.int64)
        if len(budgets) == 1:
            sol, new_state = self.session.resume_round(g.batch, g.state, budgets[0], g.options)
            obj, x = sol.objective, sol.x
            status[:] = sol.status.cpu().numpy()
            done_inc[:] = sol.iterations.cpu().numpy()
        else:
            obj = torch.zeros((nrows,), dtype=g.batch.a.dtype, device=dev)
            x = torch.zeros((nrows, g.batch.n), dtype=g.batch.a.dtype, device=dev)
            new_state = g.state
            for v in budgets:
                rows = np.nonzero(incs == v)[0]
                ridx = torch.as_tensor(rows, device=dev)
                sol, part_state = self.session.resume_round(
                    g.batch.take(ridx), g.state.take(ridx), int(v), g.options)
                status[rows] = sol.status.cpu().numpy()
                done_inc[rows] = sol.iterations.cpu().numpy()
                obj = _scatter_rows(obj, ridx, sol.objective)
                x = _scatter_rows(x, ridx, sol.x)
                new_state = _scatter_state(new_state, ridx, part_state)
        # Every dispatch succeeded: commit the round's bookkeeping.
        for i in range(nrows):
            g.done[i] += int(done_inc[i])
            g.remaining[i] -= int(incs[i])
        keep = [i for i in range(nrows) if status[i] == ITER_LIMIT and g.remaining[i] > 0]
        kept = set(keep)
        drop = [i for i in range(nrows) if i not in kept]
        if drop:
            self._retire(g, drop, status, obj, x, completed)
        if len(keep) == nrows:
            g.state = new_state
            return
        kidx = torch.as_tensor(keep, dtype=torch.int64, device=dev)
        g.batch = g.batch.take(kidx)
        g.state = new_state.take(kidx)
        g.c_user = g.c_user[kidx]
        g.shift = g.shift[kidx]
        g.tickets = [g.tickets[i] for i in keep]
        g.remaining = [g.remaining[i] for i in keep]
        g.done = [g.done[i] for i in keep]
        g.true_n = [g.true_n[i] for i in keep]

    def _retire(self, g: _Group, rows: List[int], status: np.ndarray, obj: torch.Tensor,
                x: torch.Tensor, completed: List[int]) -> None:
        """Finish rows: the pdhg post-passes, uncanonicalize, one result per ticket."""
        dev = g.batch.a.device
        ridx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        sub = g.batch.take(ridx)
        sol = LPSolution(
            objective=obj[ridx], x=x[ridx],
            status=torch.as_tensor(status[rows], device=dev),
            iterations=torch.as_tensor(np.asarray([g.done[i] for i in rows], np.int32),
                                       device=dev))
        if g.options.backend == "pdhg":
            # The once-per-row post-passes solve_canonical applies to its
            # merged solution; both are per-row, so a retired sub-batch gets
            # what the one-shot batch gives the same rows.
            sol = _pdhg.confirm_certificates(sub, sol, g.options)
            if g.options.crossover:
                sol = _pdhg.crossover(sub, sol, g.options)
        canon = Canonicalized(batch=sub, c_user=g.c_user[ridx], shift=g.shift[ridx], n=g.cn,
                              sign=g.sign, split=g.split)
        out = uncanonicalize(canon, sol)
        for row, i in enumerate(rows):
            self._finish(g.tickets[i], LPSolution(
                objective=out.objective[row:row + 1], x=out.x[row:row + 1, :g.true_n[i]],
                status=out.status[row:row + 1], iterations=out.iterations[row:row + 1]),
                completed)

    def _finish(self, ticket: int, sol: LPSolution, completed: List[int]) -> None:
        deadline, _, _ = self._meta.pop(ticket, (None, 0, 0))
        if deadline is not None and self.clock() > deadline:
            self.deadline_misses += 1
        self._results[ticket] = sol
        self._inflight.pop(ticket, None)
        completed.append(ticket)

    def _drain(self) -> int:
        """Run the in-flight groups to empty (no admission); count the retired."""
        done = 0
        while self._groups:
            completed: List[int] = []
            self._advance(completed)
            done += len(completed)
        return done

    # -- flush mode ---------------------------------------------------------

    def flush(self) -> int:
        """Complete everything: drain the in-flight groups, megabatch the rest.

        Pending requests solve through one bucketed megabatch.  Returns
        the number of requests completed.  A raising solve keeps every
        pending request.
        """
        done = self._drain()
        if not self._pending:
            return done
        tickets = [t for t, _ in self._pending]
        sols = self.session.solve([p for _, p in self._pending])
        # Clear only after the solve succeeded: a raising solve must not drop
        # the other queued requests.
        self._pending = []
        self._pending_ids.clear()
        completed: List[int] = []
        for t, s in zip(tickets, sols):
            self._finish(t, s, completed)
        return done + len(completed)

    def result(self, ticket: int) -> LPSolution:
        """Redeem a ticket, running the engine forward if it must.

        An in-flight ticket is stepped to completion, a pending one
        flushed.  An unknown or already redeemed ticket raises
        ``KeyError`` at once, with no flush and no step.
        """
        if ticket in self._results:
            return self._results.pop(ticket)
        if ticket in self._inflight:
            while ticket not in self._results:
                self.step()
            return self._results.pop(ticket)
        if ticket in self._pending_ids:
            self.flush()
            if ticket in self._results:
                return self._results.pop(ticket)
            self._pending_ids.discard(ticket)
        raise KeyError(f"ticket {ticket} unknown or already redeemed")
