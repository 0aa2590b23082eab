"""The port's round scheduler against ``repro``'s (``tests/test_compaction.py``).

The seed-42 mixed 12x6 batch (feasible- and infeasible-start, unbounded
and infeasible LPs) goes through ``repro_torch.solve`` and
``repro.solve``.  Every compaction mode must equal ``compaction="off"``
bit for bit in the port (status, objective, x, iterations; under
``resume="basis"`` the basis too), and hold against the reference's
compacted solve: status, iterations and basis equal, the objective within
1e-9 in float64 and rtol 1e-5 in float32.  The guardrails, the quarantine
and the legacy ``first_cap`` two-pass are held against the reference's on
the same numpy arrays.  Only the plain versions run here.
"""

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import dispatch as jdispatch
from repro.core import lp as jlp
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import lp as tlp
from repro_torch.core import simplex as tsimplex

from test_torch_simplex import RTOL

MODES = [("chunked", "scratch"), ("every_k", "scratch"), ("chunked", "basis"),
         ("every_k", "basis")]


def _mixed_arrays(dtype=np.float64):
    """The mixed batch of ``tests/test_compaction.py``, as numpy arrays."""
    rng = np.random.default_rng(42)
    m, n = 12, 6
    easy = jlp.random_lp_batch(rng, 24, m, n, True, dtype=dtype)
    hard = jlp.random_lp_batch(rng, 8, m, n, False, dtype=dtype)
    a_unb = -np.abs(rng.uniform(0.1, 1.0, size=(2, m, n)))
    b_unb = np.ones((2, m))
    c_unb = np.abs(rng.uniform(0.1, 1.0, size=(2, n)))
    a_inf = np.zeros((2, m, n))
    b_inf = np.ones((2, m))
    a_inf[:, 0, 0] = 1.0
    b_inf[:, 0] = 1.0
    a_inf[:, 1, 0] = -1.0
    b_inf[:, 1] = -3.0
    c_inf = np.ones((2, n))
    return tuple(np.concatenate(parts).astype(dtype) for parts in (
        [np.asarray(easy.a), np.asarray(hard.a), a_unb, a_inf],
        [np.asarray(easy.b), np.asarray(hard.b), b_unb, b_inf],
        [np.asarray(easy.c), np.asarray(hard.c), c_unb, c_inf]))


def _batches(dtype=np.float64):
    a, b, c = _mixed_arrays(dtype)
    return jlp.LPBatch(a, b, c), tlp.LPBatch.from_numpy(a, b, c, device="cpu")


def _assert_bit_identical(ref, sol, fields=("status", "objective", "x", "iterations")):
    for f in fields:
        assert torch.equal(getattr(ref, f), getattr(sol, f)), f


def _assert_matches_reference(sol_t, sol_j, dtype, basis=True):
    status = np.asarray(sol_j.status)
    assert np.array_equal(sol_t.status.numpy(), status)
    assert np.array_equal(sol_t.iterations.numpy(), np.asarray(sol_j.iterations))
    if basis:
        assert np.array_equal(sol_t.basis.numpy(), np.asarray(sol_j.basis))
    ok = status == jlp.OPTIMAL
    obj_t, obj_j = sol_t.objective.numpy(), np.asarray(sol_j.objective)
    if dtype == np.float64:
        np.testing.assert_allclose(obj_t[ok], obj_j[ok], rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(obj_t[ok], obj_j[ok], rtol=RTOL[dtype])
    assert np.array_equal(obj_t[~ok], obj_j[~ok])


def test_the_batch_is_mixed():
    _, tb = _batches()
    st = repro_torch.solve(tb).status.numpy()
    for code in (tlp.OPTIMAL, tlp.UNBOUNDED, tlp.INFEASIBLE):
        assert (st == code).any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rule", ["lpc", "bland"])
@pytest.mark.parametrize("mode,resume", MODES)
def test_compaction_bit_identical_to_off_and_matches_reference(mode, resume, rule, dtype):
    jb, tb = _batches(dtype)
    kw = dict(rule=rule, compaction=mode, resume=resume, compact_every=8, chunk_size=16)
    off = repro_torch.solve(tb, repro_torch.SolveOptions(rule=rule))
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(**kw))
    _assert_bit_identical(off, sol)
    if resume == "basis":
        assert torch.equal(off.basis, sol.basis)
    ref = repro.solve(jb, repro.SolveOptions(backend="xla", autotune="off", **kw))
    _assert_matches_reference(sol, ref, dtype)


@pytest.mark.parametrize("backend", ["cuda", "torch", "reference"])
@pytest.mark.parametrize("resume", ["scratch", "basis"])
def test_compaction_honoured_by_every_backend(backend, resume):
    _, tb = _batches()
    off = repro_torch.solve(tb, repro_torch.SolveOptions(backend=backend))
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(
        backend=backend, compaction="every_k", compact_every=8, resume=resume))
    _assert_bit_identical(off, sol, ("status", "objective"))


@pytest.mark.parametrize("mode", ["chunked", "every_k"])
def test_compaction_auto_knobs(mode):
    _, tb = _batches()
    off = repro_torch.solve(tb)
    _assert_bit_identical(off, repro_torch.solve(tb, repro_torch.SolveOptions(compaction=mode)))


def test_unknown_modes_raise():
    with pytest.raises(ValueError, match="compaction"):
        repro_torch.SolveOptions(compaction="sometimes")
    with pytest.raises(ValueError, match="resume"):
        repro_torch.SolveOptions(resume="tableau")


@pytest.mark.parametrize("resume", ["scratch", "basis"])
def test_compaction_reduces_lockstep_work(resume):
    _, tb = _batches()
    off_stats, comp_stats = repro_torch.SolveStats(), repro_torch.SolveStats()
    repro_torch.solve(tb, stats=off_stats)
    repro_torch.solve(tb, repro_torch.SolveOptions(compaction="every_k", compact_every=8,
                                                   resume=resume), stats=comp_stats)
    assert comp_stats.lockstep_iterations < off_stats.lockstep_iterations
    assert comp_stats.rounds > off_stats.rounds
    assert (comp_stats.resumed > 0) == (resume == "basis")
    if resume == "basis":  # no pivot is repeated
        assert comp_stats.simplex_iterations == off_stats.simplex_iterations


def test_stats_match_reference_round_by_round():
    jb, tb = _batches()
    kw = dict(compaction="every_k", compact_every=8, resume="basis")
    jst, tst = repro.SolveStats(), repro_torch.SolveStats()
    repro.solve(jb, repro.SolveOptions(backend="xla", autotune="off", **kw), stats=jst)
    repro_torch.solve(tb, repro_torch.SolveOptions(**kw), stats=tst)
    for f in ("lps", "rounds", "simplex_iterations", "lockstep_iterations", "resumed"):
        assert getattr(tst, f) == getattr(jst, f), f


@pytest.mark.parametrize("first_cap", [0, 5])
def test_first_cap_two_pass_matches_reference(first_cap):
    jb, tb = _batches()
    ref = repro.solve(jb, repro.SolveOptions(backend="xla", autotune="off", first_cap=first_cap))
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(first_cap=first_cap))
    _assert_matches_reference(sol, ref, np.float64)


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("opts", [dict(compaction="chunked"), dict(compaction="every_k"),
                                  dict(compaction="every_k", compact_every=5, max_iters=90),
                                  dict(first_cap=0), dict()])
def test_round_plan_matches_reference(opts, incremental):
    jb, tb = _batches()
    caps_j = jdispatch._round_plan(jb, repro.SolveOptions(**opts), incremental=incremental)
    caps_t = tdispatch._round_plan(tb, repro_torch.SolveOptions(**opts), incremental=incremental)
    assert list(caps_t[0]) == list(caps_j[0]) and caps_t[1] == caps_j[1]


# ---------------------------------------------------------------------------
# guardrails and quarantine
# ---------------------------------------------------------------------------


def test_guardrails_bit_identical_on_a_healthy_batch():
    _, tb = _batches()
    for kw in (dict(), dict(compaction="every_k", compact_every=8, resume="basis")):
        on = repro_torch.solve(tb, repro_torch.SolveOptions(guardrails=True, **kw))
        off = repro_torch.solve(tb, repro_torch.SolveOptions(guardrails=False, **kw))
        _assert_bit_identical(on, off)


def test_nan_state_row_retires_numerical_as_in_the_reference():
    # The same numpy arrays through both packages' apply_guardrails: an
    # OPTIMAL row with a NaN objective, an UNBOUNDED row with its -inf
    # objective (passes), and a row whose carried tableau holds a NaN.
    rng = np.random.default_rng(5)
    bsz, m, n = 6, 3, 4
    q = 1 + n + m
    obj = rng.uniform(size=bsz)
    obj[1] = np.nan
    obj[2] = -np.inf
    x = rng.uniform(size=(bsz, n))
    status = np.array([1, 1, 2, 1, 4, 1], np.int32)
    iters = np.arange(bsz, dtype=np.int32)
    tab = rng.uniform(size=(bsz, m + 1, q))
    tab[4, 2, 3] = np.nan
    basis = np.tile(np.arange(1, m + 1, dtype=np.int32), (bsz, 1))
    phase = np.full(bsz, 2, np.int32)
    ref = jdispatch.apply_guardrails(
        jlp.LPSolution(objective=obj, x=x, status=status, iterations=iters),
        jlp.ResumeState(tab, basis, phase))
    got = tdispatch.apply_guardrails(
        tlp.LPSolution(*(torch.from_numpy(v) for v in (obj, x, status, iters))),
        tlp.ResumeState(*(torch.from_numpy(v) for v in (tab, basis, phase))))
    assert np.array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.status.tolist() == [1, 5, 2, 1, 5, 1]
    np.testing.assert_array_equal(got.objective.numpy(), np.asarray(ref.objective))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(ref.x))


def _poisoned_round(quarantine: bool, guardrails: bool = True):
    """Solve the mixed batch in basis-resume rounds with row 26's carried
    tableau poisoned after round 0, as a fault would."""
    _, tb = _batches()
    opts = repro_torch.SolveOptions(compaction="every_k", compact_every=8, resume="basis",
                                    guardrails=guardrails, quarantine=quarantine)
    real = tdispatch.dispatch_round

    def poisoning(batch, options, stats=None, state=None, want_state=False):
        sol, out = real(batch, options, stats, state=state, want_state=want_state)
        if out is not None and state is None:
            out.tab[26, 0, 0] = float("nan")
        return sol, out

    tdispatch.dispatch_round = poisoning
    try:
        stats = repro_torch.SolveStats()
        sol = repro_torch.solve(tb, opts, stats=stats)
    finally:
        tdispatch.dispatch_round = real
    return tb, sol, stats


def test_poisoned_row_retires_and_the_rest_stay_bit_equal():
    tb, sol, stats = _poisoned_round(quarantine=False)
    off = repro_torch.solve(tb)
    assert int(off.status[26]) == tlp.OPTIMAL and int(off.iterations[26]) > 8
    assert int(sol.status[26]) == tlp.NUMERICAL
    assert torch.isnan(sol.objective[26]) and not sol.x[26].any()
    rest = torch.arange(tb.batch) != 26
    for f in ("status", "objective", "x", "iterations"):
        assert torch.equal(getattr(sol, f)[rest], getattr(off, f)[rest]), f
    assert stats.quarantined == 0


def test_quarantine_resolves_the_poisoned_row_on_the_oracle():
    tb, sol, stats = _poisoned_round(quarantine=True)
    assert stats.quarantined == 1
    assert int(sol.status[26]) == tlp.OPTIMAL
    off = repro_torch.solve(tb)
    np.testing.assert_allclose(float(sol.objective[26]), float(off.objective[26]), rtol=1e-9)


def test_resume_state_take_and_concat():
    _, tb = _batches()
    _, state = tsimplex.solve_batched(tb.a, tb.b, tb.c, max_iters=3, want_state=True)
    idx = torch.tensor([5, 1, 30])
    part = state.take(idx)
    assert torch.equal(part.tab, state.tab[idx]) and torch.equal(part.basis, state.basis[idx])
    both = tlp.concat_states([state.take(slice(0, 10)), state.take(slice(10, None))])
    for f in ("tab", "basis", "phase"):
        assert torch.equal(getattr(both, f), getattr(state, f))
