"""Open-loop Poisson load generation and replay for the LP serve loop.

Follows ``repro/serve/loadgen.py``.  Arrivals follow their own clock, a
Poisson process at a fixed offered rate, whatever the server's pace, so
queueing delay shows in the latency distribution instead of throttling
the generator (the closed-loop coordination-omission trap).
:func:`poisson_trace` builds such a trace up front, deterministic given
its seed; :func:`replay` plays it against an
:class:`~repro_torch.serve.engine.LPEngine` in either mode and records
each request's latency from its SCHEDULED arrival to its completion, so
a request that waits behind a flush is charged the whole wait.
:func:`lp_request_mix` makes the same LPs as the reference's for the
same ``(dims, seed)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.lp import LPSolution, random_lp_batch
from ..core.problem import LPProblem
from .engine import LPEngine


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request of an open-loop trace.

    ``t`` is the arrival time in seconds from the trace's start,
    ``deadline`` (optional) the completion deadline on the same scale
    (made absolute on the engine's clock at replay), ``priority`` the
    admission priority (larger wins among equal deadlines).
    """

    t: float
    problem: LPProblem
    deadline: Optional[float] = None
    priority: int = 0


def lp_request_mix(dims: Sequence, seed: int = 0, dtype=np.float32,
                   device=None) -> Callable[[int], LPProblem]:
    """A deterministic request mix over (m, n) shapes: ``make(i) -> LPProblem``.

    Request i is a random feasible-start LP of ``dims[i % len(dims)]``
    (the paper's generator, one LP a request), drawn from one numpy
    generator a shape seeded by ``[seed, m, n]``.  Problems are built on
    ``device`` (None = the card; requests that arrive on the host use
    ``device="cpu"``, and the engine moves each admitted wave).
    """
    dims = [tuple(d) for d in dims]
    rngs = {d: np.random.default_rng([seed, d[0], d[1]]) for d in dims}

    def make(i: int) -> LPProblem:
        m, n = dims[i % len(dims)]
        return LPProblem.from_batch(random_lp_batch(rngs[(m, n)], 1, m, n, True, dtype,
                                                    device=device))

    return make


def poisson_trace(rate: float, n_requests: int, make_problem: Callable[[int], LPProblem],
                  seed: int = 0, deadline_slack: Optional[float] = None,
                  priority: Callable[[int], int] = lambda i: 0) -> List[Arrival]:
    """An open-loop Poisson arrival trace at ``rate`` requests a second.

    Inter-arrival gaps are exponential with mean ``1 / rate``, drawn from
    ``np.random.default_rng(seed)`` (independent of the request mix).
    With ``deadline_slack`` every request carries ``deadline = t +
    slack``.  Returns the arrivals in time order.
    """
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    return [
        Arrival(t=float(times[i]), problem=make_problem(i),
                deadline=None if deadline_slack is None else float(times[i]) + deadline_slack,
                priority=int(priority(i)))
        for i in range(n_requests)
    ]


@dataclasses.dataclass
class ReplayResult:
    """Per-request latencies and solutions of one :func:`replay`.

    ``latencies[i]`` is seconds from ``arrivals[i].t`` (the scheduled
    arrival) to completion; ``solutions[i]`` the redeemed result;
    ``makespan`` the seconds from the trace's start to the last
    completion.
    """

    latencies: np.ndarray
    solutions: List[LPSolution]
    makespan: float


def replay(engine: LPEngine, arrivals: Sequence[Arrival], mode: str = "continuous",
           sleep: Callable[[float], None] = time.sleep) -> ReplayResult:
    """Play a trace against an engine and measure open-loop latencies.

    ``mode="continuous"``: between arrivals the loop drives
    ``engine.step()``, so requests complete the round they finish.
    ``mode="flush"``: the loop only submits (the engine's
    ``flush_every`` auto-flush is the policy) and flushes the tail once
    the trace is exhausted: the stop-the-world baseline.  ``sleep`` is
    the idle wait of flush mode (injectable for tests).
    """
    if mode not in ("continuous", "flush"):
        raise ValueError(f'replay mode must be "continuous" or "flush", got {mode!r}')
    clock = engine.clock
    n = len(arrivals)
    tickets: List[Optional[int]] = [None] * n
    outstanding = {}  # ticket -> request index, until it completes
    finish: List[Optional[float]] = [None] * n
    start = clock()

    def harvest(now: float) -> None:
        for tk in [tk for tk in outstanding if engine.done(tk)]:
            idx = outstanding.pop(tk)
            finish[idx] = now - arrivals[idx].t

    i = 0
    while i < n or outstanding:
        now = clock() - start
        while i < n and arrivals[i].t <= now:
            a = arrivals[i]
            tk = engine.submit(a.problem,
                               deadline=None if a.deadline is None else start + a.deadline,
                               priority=a.priority)
            tickets[i] = tk
            outstanding[tk] = i
            i += 1
            # submit may auto-flush (the flush-mode policy): everything
            # outstanding completes at this instant.
            harvest(clock() - start)
        if mode == "continuous":
            engine.step()
            harvest(clock() - start)
        elif i >= n:
            engine.flush()
            harvest(clock() - start)
        else:
            sleep(min(max(arrivals[i].t - (clock() - start), 0.0), 1e-3))
    makespan = max(f + a.t for f, a in zip(finish, arrivals)) if n else 0.0
    solutions = [engine.result(tk) for tk in tickets]
    return ReplayResult(latencies=np.asarray(finish, np.float64), solutions=solutions,
                        makespan=float(makespan))
