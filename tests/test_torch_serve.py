"""The port's LP serve loop against ``repro``'s (``tests/test_serve.py``).

The load-bearing property is the exact-resume contract carried into
serving: any interleaving of submit/step/result returns, per LP, the
bits of a one-shot ``repro_torch.solve`` of the same problems, on every
backend that splices (``cuda``'s plain version, ``torch``, ``pdhg`` with
and without crossover).  The port's answers are also held against the
reference's one-shot solve of the same requests (status and iterations
equal; objective and x to the float32 tolerance), and the admission
policy, the deadline counter, the specialisation counters and the flush
contracts are those of the reference.  Everything runs with
``device="cpu"``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro
import repro_torch
from repro.core import dispatch as jdispatch
from repro.serve import loadgen as jloadgen
from repro_torch import SolveOptions, SolveStats
from repro_torch.core import dispatch
from repro_torch.core import lp
from repro_torch.core.problem import LPProblem
from repro_torch.serve.engine import LPEngine
from repro_torch.serve.loadgen import lp_request_mix, poisson_trace, replay

from test_torch_chaos import assert_parity

DIMS = [(4, 6), (6, 4)]


def _mk_problems(n, dims=DIMS, seed=11):
    make = lp_request_mix(dims, seed=seed, device="cpu")
    return [make(i) for i in range(n)]


def _ref_problems(n, dims=DIMS, seed=11):
    make = jloadgen.lp_request_mix(dims, seed=seed)
    return [make(i) for i in range(n)]


def _engine(opts=None, **kw):
    return LPEngine(opts, device="cpu", **kw)


def _bit_same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("objective", "x", "status", "iterations"))


def _run_interleaved(opts, step_iters, problems, **engine_kw):
    """Submit one problem a step; redeem tickets as they complete."""
    stats = SolveStats()
    eng = _engine(opts, flush_every=1 << 30, stats=stats, step_iters=step_iters, **engine_kw)
    tickets, done = [], {}
    for p in problems:
        tickets.append(eng.submit(p))
        for t in eng.step():
            done[t] = eng.result(t)
    while len(done) < len(problems):
        for t in eng.step():
            done[t] = eng.result(t)
    return [done[t] for t in tickets], stats, eng


def _ref_options(opts):
    kw = {"cuda": "xla", "torch": "xla"}
    return repro.SolveOptions(backend=kw.get(opts.backend, opts.backend), autotune="off",
                              max_iters=opts.max_iters, route_frontier=opts.route_frontier,
                              crossover=opts.crossover)


# ---------------------------------------------------------------------------
# bit-identity: continuous against one-shot, on every backend that splices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,opts,step_iters",
    [
        ("cuda", SolveOptions(), 8),
        ("torch", SolveOptions(backend="torch"), 8),
        ("pdhg", SolveOptions(backend="auto", route_frontier=2), 4096),
        ("pdhg-crossover", SolveOptions(backend="auto", route_frontier=2, crossover=True), 4096),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_continuous_bit_identical_to_oneshot(name, opts, step_iters):
    # Two shape classes, one submit a round: later arrivals splice into
    # rounds that already carry survivors.
    problems = _mk_problems(10)
    oneshot = repro_torch.solve(problems, opts)
    sols, stats, _ = _run_interleaved(opts, step_iters, problems)
    for i, (o, s) in enumerate(zip(oneshot, sols)):
        assert _bit_same(o, s), f"request {i} diverged from the one-shot solve"
    assert stats.resumed >= len(problems)
    refs = repro.solve(_ref_problems(10), _ref_options(opts))
    for s, r in zip(sols, refs):
        if name.startswith("pdhg") and not opts.crossover:
            assert np.array_equal(s.status.numpy(), np.asarray(r.status))
            assert np.array_equal(s.iterations.numpy(), np.asarray(r.iterations))
            np.testing.assert_allclose(s.x.numpy(), np.asarray(r.x), rtol=0, atol=1e-4)
        else:
            assert_parity(s, r)


def test_splice_joins_inflight_round_bitwise():
    problems = _mk_problems(6, dims=[(4, 6)])
    oneshot = repro_torch.solve(problems, SolveOptions())
    sols, stats, _ = _run_interleaved(SolveOptions(), 2, problems)
    # quantum 2 on a class that needs several pivots: later arrivals join
    # rounds that carry survivors.
    assert stats.spliced > 0
    for o, s in zip(oneshot, sols):
        assert _bit_same(o, s)


def test_budget_exhaustion_iter_limit_bitwise():
    # A cap small enough that some LPs retire ITER_LIMIT: the budgets must
    # sum to the cap exactly, so truncated rows match too.
    opts = SolveOptions(max_iters=4)
    problems = _mk_problems(8)
    oneshot = repro_torch.solve(problems, opts)
    assert any(int(s.status[0]) == lp.ITER_LIMIT for s in oneshot)
    assert any(int(s.status[0]) == lp.OPTIMAL for s in oneshot)
    sols, _, _ = _run_interleaved(opts, 2, problems)
    for o, s in zip(oneshot, sols):
        assert _bit_same(o, s)
    for s, r in zip(sols, repro.solve(_ref_problems(8), _ref_options(opts))):
        assert_parity(s, r)


# ---------------------------------------------------------------------------
# admission policy: EDF, priority, starvation bound (fake clock)
# ---------------------------------------------------------------------------


def _fake_clock():
    t = [0.0]

    def clock():
        return t[0]

    return t, clock


def test_edf_admits_earliest_deadline_first():
    _, clock = _fake_clock()
    eng = _engine(flush_every=1 << 30, max_inflight=1, clock=clock)
    probs = _mk_problems(3, dims=[(4, 6)])
    t_late = eng.submit(probs[0], deadline=30.0)
    t_soon = eng.submit(probs[1], deadline=10.0)
    t_mid = eng.submit(probs[2], deadline=20.0)
    order = []
    while len(order) < 3:
        order.extend(eng.step())
    assert order == [t_soon, t_mid, t_late]


def test_priority_breaks_deadline_ties():
    eng = _engine(flush_every=1 << 30, max_inflight=1)
    probs = _mk_problems(3, dims=[(4, 6)])
    t_lo = eng.submit(probs[0], priority=0)
    t_hi = eng.submit(probs[1], priority=5)
    t_mid = eng.submit(probs[2], priority=3)
    order = []
    while len(order) < 3:
        order.extend(eng.step())
    assert order == [t_hi, t_mid, t_lo]


def test_starvation_bound_ages_stale_requests():
    # One admission slot and a fresh high-priority arrival every round: the
    # priority-0 request is admitted once it has waited starvation_rounds.
    rounds = 3
    eng = _engine(flush_every=1 << 30, max_inflight=1, starvation_rounds=rounds)
    probs = _mk_problems(12, dims=[(4, 6)])
    starved = eng.submit(probs[0], priority=0)
    finished_at = None
    for i in range(1, 10):
        eng.submit(probs[i], priority=100)
        if starved in eng.step():
            finished_at = i
            break
    assert finished_at is not None and finished_at <= rounds + 2


def test_deadline_miss_counter_uses_engine_clock():
    t, clock = _fake_clock()
    eng = _engine(flush_every=1 << 30, clock=clock)
    probs = _mk_problems(2, dims=[(4, 6)])
    tk_ok = eng.submit(probs[0], deadline=100.0)
    tk_miss = eng.submit(probs[1], deadline=5.0)
    t[0] = 50.0  # past the second deadline before any work happens
    while not (eng.done(tk_ok) and eng.done(tk_miss)):
        eng.step()
    assert eng.deadline_misses == 1


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.one_of(st.none(), st.floats(0, 100, allow_nan=False)),
                          st.integers(-3, 3), st.integers(0, 12)), max_size=12),
       st.integers(0, 20), st.integers(0, 10))
def test_admission_order_equals_the_reference(reqs, now, starvation_rounds):
    requests = [(i, d, p, s) for i, (d, p, s) in enumerate(reqs)]
    assert dispatch.admission_order(requests, now, starvation_rounds) == \
        jdispatch.admission_order(requests, now, starvation_rounds)


# ---------------------------------------------------------------------------
# specialisation counters: the steady state uses no new one
# ---------------------------------------------------------------------------


def test_steady_state_compiles_zero_after_warmup():
    stats = SolveStats()
    eng = _engine(SolveOptions(), flush_every=1 << 30, stats=stats, step_iters=8)

    def traffic(seed):
        probs = _mk_problems(10, seed=seed)
        done = {}
        tickets = [eng.submit(p) for p in probs]
        while not all(t in done for t in tickets):
            for t in eng.step():
                done[t] = eng.result(t)

    traffic(seed=21)
    compiles0, hits0 = stats.compiles, stats.cache_hits
    traffic(seed=22)  # the same shape classes, other data
    assert stats.compiles == compiles0, "steady-state traffic used a new specialisation"
    assert stats.cache_hits > hits0


# ---------------------------------------------------------------------------
# flush-mode error contracts and the ticket store
# ---------------------------------------------------------------------------


def _single_lp(rng, m=3, n=3):
    b = lp.random_lp_batch(rng, 1, m, n, True, dtype=np.float64, device="cpu")
    return LPProblem.make(b.c, b.a, bu=b.b, device="cpu")


def _two_lp_problem(rng):
    bad = lp.random_lp_batch(rng, 2, 3, 3, True, dtype=np.float64, device="cpu")
    return LPProblem(bad.c, bad.a, -bad.b, bad.b, torch.zeros_like(bad.c),
                     torch.full_like(bad.c, np.inf))


def test_failed_flush_retains_all_pending():
    rng = np.random.default_rng(7)
    eng = _engine(flush_every=100)
    t_good = eng.submit(_single_lp(rng))
    t_bad = eng.submit(_two_lp_problem(rng))
    with pytest.raises(ValueError):
        eng.flush()
    assert eng.pending_count == 2
    assert {t for t, _ in eng._pending} == {t_good, t_bad}


def test_result_unknown_ticket_raises_without_flush(monkeypatch):
    eng = _engine(flush_every=100)
    eng.submit(_single_lp(np.random.default_rng(8)))
    calls = []
    real_flush = eng.flush
    monkeypatch.setattr(eng, "flush", lambda: calls.append(1) or real_flush())
    with pytest.raises(KeyError, match="unknown or already redeemed"):
        eng.result(9999)
    assert not calls, "an unknown ticket must not trigger a flush"
    assert eng.pending_count == 1


def test_result_double_redeem_raises_without_flush(monkeypatch):
    eng = _engine(flush_every=100)
    tk = eng.submit(_single_lp(np.random.default_rng(9)))
    eng.flush()
    eng.result(tk)
    calls = []
    real_flush = eng.flush
    monkeypatch.setattr(eng, "flush", lambda: calls.append(1) or real_flush())
    with pytest.raises(KeyError, match="unknown or already redeemed"):
        eng.result(tk)
    assert not calls


def test_redeeming_large_queue_flushes_exactly_once():
    rng = np.random.default_rng(10)
    eng = _engine(flush_every=1 << 30)
    tickets = [eng.submit(_single_lp(rng)) for _ in range(64)]
    solve_calls = []
    real_solve = eng.session.solve
    eng.session.solve = lambda ps: solve_calls.append(len(ps)) or real_solve(ps)
    eng.result(tickets[7])  # the first redeem flushes the whole queue once
    assert solve_calls == [64]
    for tk in tickets:
        if tk != tickets[7]:
            eng.result(tk)
    assert solve_calls == [64], "redeeming solved tickets flushed again"


def test_cancel_pending_only():
    rng = np.random.default_rng(12)
    eng = _engine(flush_every=1 << 30)
    tk = eng.submit(_single_lp(rng))
    assert eng.cancel(tk) is True
    assert eng.pending_count == 0
    with pytest.raises(KeyError):
        eng.result(tk)
    tk2 = eng.submit(_single_lp(rng))
    eng.step()  # admitted (and likely completed): too late to cancel
    assert eng.cancel(tk2) is False
    assert int(eng.result(tk2).status[0]) == lp.OPTIMAL


def test_step_reports_each_completion_exactly_once():
    eng = _engine(flush_every=1 << 30, step_iters=4)
    tickets = [eng.submit(p) for p in _mk_problems(7)]
    seen = []
    while len(seen) < len(tickets):
        seen.extend(eng.step())
    assert sorted(seen) == sorted(tickets)
    assert len(seen) == len(set(seen))


def test_rejects_multi_lp_requests_on_step():
    rng = np.random.default_rng(13)
    eng = _engine(flush_every=1 << 30)
    good = eng.submit(_single_lp(rng))
    eng.submit(_two_lp_problem(rng))
    with pytest.raises(ValueError, match="batch == 1"):
        eng.step()
    # the failed admission did not drop the good request
    assert good in eng._pending_ids


# ---------------------------------------------------------------------------
# property: random interleavings match the one-shot solve
# ---------------------------------------------------------------------------


@st.composite
def _schedules(draw):
    n = draw(st.integers(1, 6))
    steps_after = [draw(st.integers(0, 2)) for _ in range(n)]
    redeem = draw(st.permutations(list(range(n))))
    seed = draw(st.integers(0, 2**31 - 1))
    return n, steps_after, redeem, seed


@given(_schedules())
@settings(max_examples=12, deadline=None)
def test_random_interleavings_match_oneshot(sched):
    n, steps_after, redeem, seed = sched
    problems = _mk_problems(n, dims=[(3, 4), (4, 3)], seed=seed)
    oneshot = repro_torch.solve(problems, SolveOptions())
    eng = _engine(SolveOptions(), flush_every=1 << 30, step_iters=8)
    tickets = []
    for p, k in zip(problems, steps_after):
        tickets.append(eng.submit(p))
        for _ in range(k):
            eng.step()
    # Redeem in any order: result() steps an in-flight ticket, flushes a
    # pending one, and pays each ticket out exactly once.
    sols = {i: eng.result(tickets[i]) for i in redeem}
    for i in range(n):
        assert _bit_same(oneshot[i], sols[i])
    with pytest.raises(KeyError):
        eng.result(tickets[redeem[0]])


# ---------------------------------------------------------------------------
# port-only: the load generator and the replay
# ---------------------------------------------------------------------------


def test_request_mix_and_trace_equal_the_reference():
    make = lp_request_mix([(5, 7), (12, 12)], seed=3, device="cpu")
    jmake = jloadgen.lp_request_mix([(5, 7), (12, 12)], seed=3)
    trace = poisson_trace(50.0, 6, make, seed=17, deadline_slack=0.5, priority=lambda i: i % 3)
    jtrace = jloadgen.poisson_trace(50.0, 6, jmake, seed=17, deadline_slack=0.5,
                                    priority=lambda i: i % 3)
    for ours, theirs in zip(trace, jtrace):
        assert (ours.t, ours.deadline, ours.priority) == (theirs.t, theirs.deadline,
                                                          theirs.priority)
        for f in ("c", "a", "bl", "bu", "lo", "hi"):
            assert np.array_equal(getattr(ours.problem, f).numpy(),
                                  np.asarray(getattr(theirs.problem, f)))


@pytest.mark.parametrize("mode", ["continuous", "flush"])
def test_replay_matches_oneshot_in_both_modes(mode):
    problems = _mk_problems(12)
    trace = poisson_trace(2000.0, 12, lambda i: problems[i], seed=17)
    eng = _engine(SolveOptions(), flush_every=5 if mode == "flush" else 1 << 30, step_iters=4)
    res = replay(eng, trace, mode=mode)
    assert res.latencies.shape == (12,) and np.all(res.latencies >= 0)
    assert res.makespan >= max(a.t for a in trace)
    for o, s in zip(repro_torch.solve(problems, SolveOptions()), res.solutions):
        assert _bit_same(o, s)
    with pytest.raises(ValueError, match="replay mode"):
        replay(eng, trace, mode="sometimes")


def test_auto_with_crossover_serves_both_sides_of_the_frontier():
    """``"auto"`` with ``crossover=True`` on traffic below and past the
    frontier: the simplex leg drops the polish (its answers are vertices)
    instead of raising, as the reference's option check does."""
    opts = SolveOptions(backend="auto", route_frontier=8, crossover=True, max_iters=300)
    problems = _mk_problems(6, dims=[(3, 3), (6, 6)])  # classes 4x4 (cuda) and 8x8 (pdhg)
    with pytest.raises(ValueError, match="crossover"):
        repro.solve(_ref_problems(6, dims=[(3, 3), (6, 6)]), _ref_options(opts))
    oneshot = repro_torch.solve(problems, opts)
    assert dispatch.resolve_backend(opts, shape=(4, 4)).crossover is False
    assert dispatch.resolve_backend(opts, shape=(8, 8)).backend == "pdhg"
    sols, _, _ = _run_interleaved(opts, 64, problems)
    for o, s in zip(oneshot, sols):
        assert _bit_same(o, s)
    small = repro_torch.solve(problems[0::2], SolveOptions())
    for o, s in zip(oneshot[0::2], small):
        assert _bit_same(o, s)


def _lower_bounded(n_req, seed=21):
    """Requests ``max c.x, A x <= b, x >= lo`` with a finite non-zero ``lo``
    (some entries 0, some negative): the rows whose ``b`` takes ``A lo``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_req):
        m, n = DIMS[i % len(DIMS)]
        a = rng.uniform(-1.0, 1.0, (m, n))
        b = rng.uniform(1.0, 10.0, m)
        c = rng.uniform(0.1, 1.0, n)
        lo = rng.uniform(-0.3, 0.3, n) * (rng.uniform(size=n) < 0.8)
        out.append((a, b, c, lo, lo + 5.0))
    return out


def test_lower_bounds_serve_bit_identical_to_oneshot_and_match_the_reference():
    """``canonicalize``'s ``A lo`` is summed row by row (``core/lp.py:row_sum``),
    so a request with non-zero lower bounds gets the same bits served a few
    at a time as in the one-shot batch, and agrees with ``repro.solve``."""
    raw = _lower_bounded(10)
    problems = [LPProblem.make(c, a, bu=b, lo=lo, hi=hi, dtype=np.float32, device="cpu")
                for a, b, c, lo, hi in raw]
    assert all(bool((p.lo != 0).any()) for p in problems)
    opts = SolveOptions()
    oneshot = repro_torch.solve(problems, opts)
    sols, stats, _ = _run_interleaved(opts, 2, problems)
    for i, (o, s) in enumerate(zip(oneshot, sols)):
        assert _bit_same(o, s), f"request {i} diverged from the one-shot solve"
    assert stats.spliced > 0 and stats.autotuned >= 1
    refs = repro.solve([repro.LPProblem.make(c, a, bu=b, lo=lo, hi=hi, dtype=np.float32)
                        for a, b, c, lo, hi in raw], _ref_options(opts))
    for s, r in zip(sols, refs):
        assert_parity(s, r)
