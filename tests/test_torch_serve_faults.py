"""The port's serve loop under injected faults (``tests/test_serve_faults.py``).

The engine degrades, it does not die: a transient fault is absorbed by
the round's retry (``dispatch_round_safe``); a fault that exhausts the
retry budget retires only its own shape-class group through the
dead-letter path (tickets complete ``NUMERICAL``) while the other groups
keep advancing, bit-identical to the fault-free run; poisoned input is
refused at ``submit``.  The fault-free run is also held against the
reference engine's.  Port-only: a kernel that does not build propagates
out of ``LPEngine.step`` at once: no retry, no dead letter, no answer
from a plain version.
"""

import contextlib

import numpy as np
import pytest
import torch

import repro
from repro.runtime import chaos as jchaos
from repro.serve.engine import LPEngine as JLPEngine
from repro.core.problem import LPProblem as JLPProblem
from repro_torch import SolveOptions
from repro_torch.core.lp import NUMERICAL, OPTIMAL
from repro_torch.core.problem import LPProblem
from repro_torch.kernels import build
from repro_torch.runtime import chaos
from repro_torch.serve.engine import LPEngine

from test_torch_chaos import (  # noqa: F401  (fixtures)
    assert_parity, broken_simplex_build, failing_simplex_launch)


def _arrays(n, m, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, size=(1, m, n))
    for j in range(min(m, n)):
        a[:, j, j] = abs(a[:, j, j]) + 1.0
    b = rng.uniform(1.0, 10.0, size=(1, m))
    c = rng.uniform(0.1, 1.0, size=(1, n))
    return c, a, b


def _problem(n, m, seed):
    c, a, b = _arrays(n, m, seed)
    return LPProblem.make(c=c, a=a, bu=b, device="cpu")


def _reorder(cab):
    c, a, b = cab
    return dict(c=c, a=a, bu=b)


SEEDS = [(4, 6, s) for s in range(3)] + [(6, 9, 10 + s) for s in range(3)]


def _run_engine(monkey=None, retry_budget=2, backend="cuda"):
    """Two shape classes, three LPs each; returns (engine, results)."""
    opts = SolveOptions(backend=backend, retry_budget=retry_budget, retry_backoff=0.0)
    eng = LPEngine(opts, flush_every=10**9, step_iters=8, device="cpu")
    tickets = [eng.submit(_problem(*s)) for s in SEEDS]
    with chaos.inject(monkey) if monkey is not None else contextlib.nullcontext():
        for _ in range(200):
            eng.step()
            if all(eng.done(t) for t in tickets):
                break
    return eng, [eng.result(t) for t in tickets]


def _assert_same(r, o, fields=("objective", "x", "status", "iterations")):
    for f in fields:
        assert torch.equal(getattr(r, f), getattr(o, f)), f


# -- submit validation ----------------------------------------------------


def test_submit_rejects_nan_payload_naming_field():
    eng = LPEngine(SolveOptions(), flush_every=10**9, device="cpu")
    bad = LPProblem.make(c=np.array([[1.0, np.nan]]), a=np.ones((1, 2, 2)),
                         bu=np.ones((1, 2)), validate=False, device="cpu")
    with pytest.raises(ValueError, match=r"submit: problem\.c contains NaN"):
        eng.submit(bad)
    assert eng.pending_count == 0  # refused before a ticket existed


def test_submit_rejects_bad_deadline():
    eng = LPEngine(SolveOptions(), flush_every=10**9, device="cpu")
    p = _problem(4, 6, 0)
    with pytest.raises(ValueError, match="deadline"):
        eng.submit(p, deadline=-1.0)
    with pytest.raises(ValueError, match="deadline"):
        eng.submit(p, deadline=float("nan"))
    assert eng.pending_count == 0


# -- group isolation and the dead-letter path ------------------------------


def test_fault_isolated_to_one_group_dead_letters():
    _, ref = _run_engine()
    assert all(int(s.status[0]) == OPTIMAL for s in ref)
    # Budget 0 and exactly one fault: the first group's round fails once and
    # dead-letters; the other group never sees a fault.
    monkey = chaos.ChaosMonkey(error_rate=1.0, max_faults=1)
    eng, out = _run_engine(monkey, retry_budget=0)
    assert monkey.faults_injected == 1
    assert len(eng.dead_letters) == 3
    assert eng.stats.dead_lettered == 3
    numerical = [i for i, s in enumerate(out) if int(s.status[0]) == NUMERICAL]
    assert len(numerical) == 3
    for i in numerical:
        assert np.isnan(float(out[i].objective[0]))
        assert bool((out[i].x == 0.0).all())
    for i, (r, o) in enumerate(zip(ref, out)):
        if i not in numerical:
            _assert_same(r, o)
    # The same schedule on the reference's engine dead-letters the same group.
    jeng = JLPEngine(repro.SolveOptions(backend="xla", retry_budget=0, retry_backoff=0.0,
                                        autotune="off"), flush_every=10**9, step_iters=8)
    jt = [jeng.submit(JLPProblem.make(**_reorder(_arrays(*s)))) for s in SEEDS]
    with jchaos.inject(jchaos.ChaosMonkey(error_rate=1.0, max_faults=1)):
        for _ in range(200):
            jeng.step()
            if all(jeng.done(t) for t in jt):
                break
    assert sorted(jt.index(t) for t in jeng.dead_letters) == numerical


def test_group_retry_recovers_bit_identical():
    _, ref = _run_engine()
    monkey = chaos.ChaosMonkey(error_rate=1.0, max_faults=2)
    eng, out = _run_engine(monkey, retry_budget=2)
    assert eng.stats.dead_lettered == 0
    assert eng.stats.retries == 2
    for r, o in zip(ref, out):
        _assert_same(r, o)
    # And the fault-free answers hold against the reference engine's.
    jeng = JLPEngine(repro.SolveOptions(backend="xla", autotune="off"), flush_every=10**9,
                     step_iters=8)
    jt = [jeng.submit(JLPProblem.make(**_reorder(_arrays(*s)))) for s in SEEDS]
    for o, t in zip(out, jt):
        assert_parity(o, jeng.result(t), dtype=np.float64, basis=False)


def test_poisoned_row_retires_numerical_in_serve_loop():
    """A NaN in a carried-state row is caught by the guardrails inside
    ``resume_round`` and retires that ticket ``NUMERICAL``; the rest match
    the fault-free run."""
    _, ref = _run_engine()
    monkey = chaos.ChaosMonkey(poison_rows={0: (0,)})
    eng, out = _run_engine(monkey)
    assert monkey.rows_poisoned == 1
    assert eng.stats.dead_lettered == 0
    assert eng.stats.faults_injected == 1
    statuses = [int(s.status[0]) for s in out]
    assert statuses.count(NUMERICAL) == 1
    poisoned = statuses.index(NUMERICAL)
    assert np.isnan(float(out[poisoned].objective[0]))
    for i, (r, o) in enumerate(zip(ref, out)):
        if i != poisoned:
            _assert_same(r, o, ("objective", "x"))


def test_dead_letter_keeps_engine_serviceable():
    """After a dead-lettered group the engine still serves new work."""
    monkey = chaos.ChaosMonkey(error_rate=1.0, max_faults=1)
    eng, _ = _run_engine(monkey, retry_budget=0)
    sol = eng.result(eng.submit(_problem(4, 6, 99)))
    assert int(sol.status[0]) == OPTIMAL


# -- port-only: a kernel that does not build ------------------------------


def test_kernel_build_error_propagates_out_of_step(broken_simplex_build):  # noqa: F811
    """No retry, no dead letter, no result: the error leaves ``step``."""
    eng = LPEngine(SolveOptions(retry_backoff=0.0), flush_every=10**9, step_iters=8,
                   device="cpu")
    tickets = [eng.submit(_problem(*s)) for s in SEEDS[:2]]
    with pytest.raises(build.KernelBuildError):
        eng.step()
    assert eng.stats.retries == 0
    assert eng.dead_letters == [] and eng.stats.dead_lettered == 0
    assert not any(eng.done(t) for t in tickets)
    # The flush path raises the same way and keeps the pending requests.
    eng2 = LPEngine(SolveOptions(), flush_every=10**9, device="cpu")
    eng2.submit(_problem(4, 6, 5))
    with pytest.raises(build.KernelBuildError):
        eng2.flush()
    assert eng2.pending_count == 1


def test_kernel_launch_error_propagates_out_of_step(failing_simplex_launch):  # noqa: F811
    """A launch that returned a CUDA error leaves ``step`` and ``flush`` after
    one attempt: no retry, no dead letter, no ticket completed."""
    eng = LPEngine(SolveOptions(retry_backoff=0.0), flush_every=10**9, step_iters=8,
                   device="cpu")
    tickets = [eng.submit(_problem(*s)) for s in SEEDS[:2]]
    with pytest.raises(build.KernelLaunchError):
        eng.step()
    assert failing_simplex_launch.calls == 1
    assert eng.stats.retries == 0
    assert eng.dead_letters == [] and eng.stats.dead_lettered == 0
    assert not any(eng.done(t) for t in tickets)
    eng2 = LPEngine(SolveOptions(), flush_every=10**9, device="cpu")
    eng2.submit(_problem(4, 6, 5))
    with pytest.raises(build.KernelLaunchError):
        eng2.flush()
    assert eng2.pending_count == 1 and failing_simplex_launch.calls == 2
