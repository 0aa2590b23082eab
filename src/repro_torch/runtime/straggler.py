"""Straggler mitigation: deadline-based speculative re-dispatch of work units.

Follows ``repro/runtime/straggler.py`` (the port keeps its own copy).  A
batch of LPs is split into work units handed to workers; a unit that
misses ``deadline = alpha * median(done unit times)`` is re-executed on
another worker, and the first result wins.  LP solves are deterministic,
so the duplicate computes the same answer and the loser is discarded.

Here the workers are host threads.  ``core/dispatch.py:
_speculative_chunks`` gives each thread its own CUDA stream, so the
chunks of one round run side by side on the card.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class UnitResult:
    unit: int
    worker: int
    elapsed: float
    speculative: bool
    value: object = None


@dataclasses.dataclass
class ScheduleReport:
    results: List[UnitResult]
    respawned: int
    wall_time: float


def run_with_speculation(
    units: Sequence,
    solve_fn: Callable[[object, int], object],  # (unit_payload, worker_id)
    n_workers: int = 4,
    alpha: float = 3.0,
    min_done_for_deadline: int = 2,
    poll: float = 0.01,
    max_speculative: Optional[int] = None,
) -> ScheduleReport:
    """Dispatch units to workers; re-dispatch stragglers past the deadline.

    Returns the results in unit order (the first attempt of each unit to
    finish), the number of speculative re-dispatches and the wall time.
    An exception in an attempt propagates.
    """
    t_start = time.perf_counter()
    done_times: List[float] = []
    results: Dict[int, UnitResult] = {}
    respawned = 0

    def task(unit_idx: int, payload, worker: int, speculative: bool):
        t0 = time.perf_counter()
        value = solve_fn(payload, worker)
        return UnitResult(unit_idx, worker, time.perf_counter() - t0, speculative, value)

    pending: Dict[Future, Tuple[int, float, bool]] = {}
    # No context manager: a straggling first attempt must not hold up the
    # return once its twin delivered the result.
    pool = ThreadPoolExecutor(max_workers=n_workers + 2, thread_name_prefix="lp-straggler")
    try:
        next_worker = 0
        for i, payload in enumerate(units):
            f = pool.submit(task, i, payload, next_worker % n_workers, False)
            pending[f] = (i, time.perf_counter(), False)
            next_worker += 1

        while len(results) < len(units):
            done, _ = wait(list(pending), timeout=poll, return_when=FIRST_COMPLETED)
            for f in done:
                unit_idx, _, _ = pending.pop(f)
                res = f.result()
                if unit_idx not in results:
                    results[unit_idx] = res
                    done_times.append(res.elapsed)
            if len(done_times) >= min_done_for_deadline:
                deadline = alpha * float(np.median(done_times))
                now = time.perf_counter()
                for f, (unit_idx, t0, spec) in list(pending.items()):
                    if spec or unit_idx in results or now - t0 <= deadline:
                        continue
                    if max_speculative is not None and respawned >= max_speculative:
                        continue
                    nf = pool.submit(task, unit_idx, units[unit_idx], next_worker % n_workers,
                                     True)
                    pending[nf] = (unit_idx, now, True)
                    next_worker += 1
                    respawned += 1
    finally:
        # Return without waiting on a straggling loser, but do not strand
        # its thread either: cancel what never started and let a daemon
        # reaper join the pool once the last attempt ends.
        pool.shutdown(wait=False, cancel_futures=True)
        threading.Thread(target=pool.shutdown, kwargs={"wait": True}, daemon=True,
                         name="lp-straggler-reaper").start()

    ordered = [results[i] for i in range(len(units))]
    return ScheduleReport(ordered, respawned, time.perf_counter() - t_start)
