"""Deterministic, seedable fault injection for the dispatch pipeline.

Follows ``repro/runtime/chaos.py``.  A :class:`ChaosMonkey` installed
with :func:`inject` is consulted by ``core/dispatch.py:dispatch_round``
at three points:

  * **before the round** (:meth:`ChaosMonkey.on_round`): an artificial
    delay and/or a :class:`ChaosError` (a backend failure of the whole
    dispatch);
  * **before each chunk** (:meth:`ChaosMonkey.on_chunk`): a
    :class:`ShardCrash` mid-round, after earlier chunks already solved;
  * **after the round** (:meth:`ChaosMonkey.poison_state`): NaN written
    into selected rows of the carried resume state, on whatever device
    the state lives (silent corruption the guardrails must catch).

Faults are scheduled deterministically (``fail_rounds``, ``crash_rounds``,
``poison_rows``, keyed by the monkey's round counter, which every
``dispatch_round`` call advances, retries included) or drawn from numpy
generators seeded by ``(seed, round, salt)`` (``error_rate``,
``crash_rate``, ``poison_rate``): the same configuration injects the same
fault sequence as the reference's.  ``max_faults`` bounds the raised
faults ("fail N times, then recover").

The port's one divergence is :data:`NON_TRANSIENT`: besides the
programming errors it holds :class:`~repro_torch.kernels.build.KernelError`,
so a kernel that does not build, load or launch propagates at once instead
of being retried and dead-lettered (no recovery path may hide a missing or
broken kernel).

The module imports nothing of ``repro_torch.core``: the dispatch layer
imports it, never the reverse.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.build import KernelError


class ChaosError(RuntimeError):
    """An injected backend failure (the whole dispatch round errored)."""


class ShardCrash(ChaosError):
    """An injected mid-round crash: one chunk of the round died."""


#: Exception types the recovery layer never retries: re-dispatching the
#: same arguments cannot fix a bad argument, a kernel that failed to build
#: or load will not build on the next attempt, and a launch that returned a
#: CUDA error may have left a sticky error or points at a broken kernel.
NON_TRANSIENT = (ValueError, TypeError, KeyError, NotImplementedError, KernelError)


def is_transient(exc: BaseException) -> bool:
    """Whether a dispatch failure is worth a retry from the carried state.

    Injected faults (:class:`ChaosError`) and other runtime errors are
    transient: the round's inputs are intact, so the same carried state
    can be dispatched again.  :data:`NON_TRANSIENT` types, a kernel's
    build, load and launch errors among them, propagate.
    """
    return not isinstance(exc, NON_TRANSIENT)


@dataclasses.dataclass
class ChaosMonkey:
    """One seeded fault schedule and its injection counters.

    Parameters
    ----------
    seed : int, default 0
        Seed of the per-round generators behind the rates.
    fail_rounds : sequence of int
        Round indices that raise :class:`ChaosError` before any chunk.
        Indices count every ``dispatch_round`` call (retries included),
        so ``fail_rounds=(1,)`` fails the second dispatch once and its
        retry, round 2, succeeds.
    crash_rounds : sequence of int
        Round indices that raise :class:`ShardCrash` before chunk 1: they
        fire only on rounds the chunking splits (``chunk_size``).
    poison_rows : mapping {int: sequence of int}
        ``round -> rows`` of the carried state written with NaN after
        that round's dispatch (rows past the round's batch are ignored).
    delay_rounds : sequence of int
        Rounds to sleep ``delay_s`` before; empty with ``delay_s > 0``
        delays every round.
    delay_s : float, default 0.0
        Artificial pre-round delay in seconds.
    error_rate, crash_rate, poison_rate : float, default 0.0
        Seeded per-round probabilities of the three fault kinds;
        ``poison_rate`` poisons each state row independently.
    max_faults : int, optional
        Stop raising faults after this many (delays and poisoning do not
        count).
    """

    seed: int = 0
    fail_rounds: Sequence[int] = ()
    crash_rounds: Sequence[int] = ()
    poison_rows: Dict[int, Sequence[int]] = dataclasses.field(default_factory=dict)
    delay_rounds: Sequence[int] = ()
    delay_s: float = 0.0
    error_rate: float = 0.0
    crash_rate: float = 0.0
    poison_rate: float = 0.0
    max_faults: Optional[int] = None
    # -- counters (read by tests and chip_smoke.py) ---------------------------
    rounds_seen: int = 0
    faults_injected: int = 0
    rows_poisoned: int = 0
    delays_injected: int = 0
    # The hooks run on the speculative chunks' worker threads too.
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False,
                                              compare=False)

    def _rng(self, round_idx: int, salt: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, round_idx, salt))

    def _take_fault(self) -> bool:
        """Count one raised fault unless ``max_faults`` are spent."""
        with self._lock:
            if self.max_faults is not None and self.faults_injected >= self.max_faults:
                return False
            self.faults_injected += 1
            return True

    def on_round(self, backend_name: str) -> int:
        """Pre-round hook: count the round, maybe delay, maybe raise."""
        with self._lock:
            r = self.rounds_seen
            self.rounds_seen += 1
        if self.delay_s > 0 and (not self.delay_rounds or r in self.delay_rounds):
            with self._lock:
                self.delays_injected += 1
            time.sleep(self.delay_s)
        scheduled = r in self.fail_rounds
        rolled = self.error_rate > 0 and self._rng(r, 0).random() < self.error_rate
        if (scheduled or rolled) and self._take_fault():
            raise ChaosError(
                f"chaos: injected backend failure on {backend_name} dispatch round {r}")
        return r

    def on_chunk(self, round_idx: int, chunk_no: int) -> None:
        """Per-chunk hook: raise :class:`ShardCrash` mid-round."""
        if chunk_no == 0:
            return  # "mid-round" means at least one chunk already solved
        scheduled = round_idx in self.crash_rounds
        rolled = self.crash_rate > 0 and self._rng(round_idx, chunk_no).random() < self.crash_rate
        if (scheduled or rolled) and self._take_fault():
            raise ShardCrash(
                f"chaos: injected shard crash at chunk {chunk_no} of dispatch round {round_idx}")

    def poison_state(self, round_idx: int, state) -> Tuple[object, int]:
        """Post-round hook: NaN in the scheduled rows of every floating field.

        Returns ``(state, rows_poisoned)``; the state comes back unchanged
        (the same object) when nothing is scheduled for this round, else
        as a new record whose floating tensors are poisoned copies on
        their own device.
        """
        bsz = int(state.batch)
        rows = [r for r in self.poison_rows.get(round_idx, ()) if r < bsz]
        if self.poison_rate > 0:
            mask = self._rng(round_idx, 2).random(bsz) < self.poison_rate
            rows = sorted(set(rows) | set(np.nonzero(mask)[0].tolist()))
        if not rows:
            return state, 0

        def nan_rows(leaf: torch.Tensor) -> torch.Tensor:
            if not leaf.is_floating_point():
                return leaf
            out = leaf.clone()
            out[torch.as_tensor(rows, device=leaf.device)] = float("nan")
            return out

        with self._lock:
            self.rows_poisoned += len(rows)
        poisoned = {f.name: nan_rows(getattr(state, f.name)) for f in dataclasses.fields(state)}
        return dataclasses.replace(state, **poisoned), len(rows)


_ACTIVE: Optional[ChaosMonkey] = None


def active() -> Optional[ChaosMonkey]:
    """The installed monkey, or None (the clean path)."""
    return _ACTIVE


@contextlib.contextmanager
def inject(monkey: ChaosMonkey) -> Iterator[ChaosMonkey]:
    """Install ``monkey`` as the active fault source for the block.

    Every ``dispatch_round`` under the block consults its hooks; the
    previous monkey (usually None) is restored on exit::

        with chaos.inject(chaos.ChaosMonkey(fail_rounds=(1,))) as monkey:
            sol = repro_torch.solve(batch, options)
        assert monkey.faults_injected == 1
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = monkey
    try:
        yield monkey
    finally:
        _ACTIVE = prev
