"""The port's sessions, dense warm sweep and solver shim against ``repro``.

``SolveSession`` on the CPU: solves through the pinned options, the
``compiles``/``cache_hits`` counters (kernel specialisations in the
port), and the serve loop's primitives (``init_state``, capped
``resume_round`` quanta, a splice) landing bit-identical to one solve.
``sweep_problems`` must equal the per-step loop ``Polytope.step_sweep``
bit for bit (supports and pivots), and the reference's compiled sweep
within 1e-9 in float64.  ``BatchedLPSolver.solve_adaptive`` must match the
reference's: status, iterations and basis equal, objective within 1e-9.
Only the plain versions run here.
"""

import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import lp as jlp
from repro.core import session as jsession
from repro.core import solver as jsolver
from repro_torch.core import lp as tlp
from repro_torch.core import session as tsession
from repro_torch.core import solver as tsolver
from repro_torch.core import support as tsupport
from repro_torch.core.lp import concat_states

from test_torch_compaction import _batches


def test_session_solves_through_its_options_and_counts_specialisations():
    _, tb = _batches()
    sess = repro_torch.SolveSession(repro_torch.SolveOptions(rule="bland"), device="cpu")
    first = sess.solve(tb)
    after_first = sess.stats.compiles
    for _ in range(2):
        again = sess.solve(tb)
        for f in ("status", "objective", "x", "iterations", "basis"):
            assert torch.equal(getattr(again, f), getattr(first, f)), f
    assert sess.stats.compiles == after_first
    assert sess.stats.cache_hits >= 2
    ref = repro_torch.solve(tb, repro_torch.SolveOptions(rule="bland"))
    assert torch.equal(first.objective, ref.objective)
    assert sess.stats.lps == 3 * tb.batch


def test_a_new_specialisation_counts_as_a_compile():
    from repro_torch.kernels import build

    _, tb = _batches()
    key = ("simplex", str(torch.float64), "plain")
    build.SPECIALIZATIONS.discard(key)
    sess = repro_torch.SolveSession(device="cpu")
    sess.solve(tb)
    assert sess.stats.compiles == 1 and key in build.SPECIALIZATIONS


def test_session_moves_inputs_to_its_device():
    jb, _ = _batches()
    sess = repro_torch.SolveSession(device="cpu")
    tb = tlp.LPBatch.from_numpy(np.asarray(jb.a), np.asarray(jb.b), np.asarray(jb.c),
                                device="cpu")
    assert sess.solve(tb).status.device.type == "cpu"
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(0), 5, 3, device="cpu")
    assert sess.solve_hyperbox(lo, hi, d).objective.shape == (5,)


@pytest.mark.parametrize("backend", ["cuda", "torch", "pdhg"])
def test_resume_round_splice_bit_identical_to_one_solve(backend):
    # The serve loop's sequence: iteration-0 states, capped rounds, and a
    # second wave spliced into the in-flight round.  pdhg runs 400 steps
    # a row (its confirmation post-pass belongs to solve_canonical), so
    # it is held against the raw kernel solve on the first wave.
    from repro_torch.kernels import ops

    _, tb = _batches()
    first, second = tb.take(slice(0, 20)), tb.take(slice(20, None))
    pdhg = backend == "pdhg"
    opts = repro_torch.SolveOptions(backend=backend)
    sess = repro_torch.SolveSession(opts, device="cpu")
    batch, state, sol = first, sess.init_state(first), None
    for step in range(8 if pdhg else 400):
        if step == 2:
            batch = tb
            state = concat_states([state, sess.init_state(second)])
        sol, state = sess.resume_round(batch, state, cap=50 if pdhg else 3)
        if not bool((sol.status == tlp.ITER_LIMIT).any()):
            break
    assert batch.batch == tb.batch and sess.stats.resumed > 0
    if pdhg:
        oneshot = ops.pdhg_solve(tb.a, tb.b, tb.c, max_iters=400)
        for f in ("x", "y"):
            assert torch.equal(getattr(sol, f)[:20], getattr(oneshot, f)[:20]), f
        return
    oneshot = repro_torch.solve(tb, opts)
    for f in ("objective", "x", "status"):
        assert torch.equal(getattr(sol, f), getattr(oneshot, f)), f


def test_resolve_options_pins_auto_per_shape():
    sess = repro_torch.SolveSession(repro_torch.SolveOptions(backend="auto"), device="cpu")
    assert sess.resolve_options(12, 6, torch.float32).backend == "cuda"
    assert sess.resolve_options(600, 600, torch.float32).backend == "pdhg"
    assert sess.resolve_options(12, 6, torch.float32) is sess.resolve_options(12, 6,
                                                                              torch.float32)


def test_init_state_without_a_hook_raises():
    _, tb = _batches()
    sess = repro_torch.SolveSession(repro_torch.SolveOptions(backend="reference"), device="cpu")
    with pytest.raises(ValueError, match="init_canonical"):
        sess.init_state(tb)


# ---------------------------------------------------------------------------
# the dense warm sweep
# ---------------------------------------------------------------------------


def _polytope_and_stack(dtype=np.float64, steps=12, k=8, dim=4):
    rng = np.random.default_rng(11)
    a = np.concatenate([np.eye(dim), -np.eye(dim), rng.uniform(0, 1, (4, dim))])
    b = np.concatenate([np.ones(dim), np.ones(dim), rng.uniform(2, 4, 4)])
    rng = np.random.default_rng(3)
    base = rng.normal(size=(k, dim))
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    rot = np.eye(dim)
    rot[0, 0] = rot[1, 1] = np.cos(0.15)
    rot[0, 1], rot[1, 0] = -np.sin(0.15), np.sin(0.15)
    out = np.empty((steps, k, dim))
    cur = base
    for s in range(steps):
        out[s] = cur
        cur = cur @ rot
    return a, b, out.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_sweep_problems_equals_the_per_step_loop(backend, dtype):
    a, b, stack = _polytope_and_stack(dtype)
    poly = tsupport.Polytope(a, b)
    opts = repro_torch.SolveOptions(backend=backend)
    loop_stats, sweep_stats = repro_torch.SolveStats(), repro_torch.SolveStats()
    loop = poly.step_sweep(stack, opts, stats=loop_stats, device="cpu")
    sweep = poly.support_sweep(stack, opts, stats=sweep_stats, device="cpu")
    assert torch.equal(sweep, loop)
    for f in ("lps", "rounds", "simplex_iterations", "lockstep_iterations", "warm_started",
              "tableau_bytes"):
        assert getattr(sweep_stats, f) == getattr(loop_stats, f), f
    cold = repro_torch.SolveStats()
    poly.support_sweep(stack, opts, warm_start=False, stats=cold, device="cpu")
    assert sweep_stats.simplex_iterations < cold.simplex_iterations


def test_sweep_problems_matches_the_reference():
    a, b, stack = _polytope_and_stack()
    ref = jsession.sweep_polytope_supports(a, b, stack,
                                           repro.SolveOptions(backend="xla", autotune="off"))
    got = tsession.sweep_polytope_supports(a, b, stack, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-9)


def test_sweep_supported_follows_the_options():
    ok = repro_torch.SolveOptions()
    assert tsession.sweep_supported(ok)
    assert tsession.sweep_supported(ok.replace(backend="auto"))
    for bad in (dict(backend="pdhg"), dict(compaction="every_k"), dict(first_cap=0),
                dict(chunk_size=4), dict(backend="reference")):
        assert not tsession.sweep_supported(ok.replace(**bad)), bad
    a, b, stack = _polytope_and_stack()
    with pytest.raises(ValueError, match="sweep_problems"):
        tsession.sweep_polytope_supports(a, b, stack, repro_torch.SolveOptions(chunk_size=4),
                                         device="cpu")


# ---------------------------------------------------------------------------
# the deprecated solver shim
# ---------------------------------------------------------------------------


def _shim(module):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return module.BatchedLPSolver()


def test_shim_warns():
    with pytest.warns(DeprecationWarning, match="repro_torch.solve"):
        tsolver.BatchedLPSolver()


@pytest.mark.parametrize("first_cap", [25, 0])
def test_solve_adaptive_matches_the_reference(first_cap):
    args = (64, 30, 30, True)
    jb = jlp.random_lp_batch(np.random.default_rng(21), *args, dtype=np.float64)
    tb = tlp.random_lp_batch(np.random.default_rng(21), *args, dtype=np.float64, device="cpu")
    ref = _shim(jsolver).solve_adaptive(jb, first_cap=first_cap)
    shim = _shim(tsolver)
    got = shim.solve_adaptive(tb, first_cap=first_cap)
    assert np.array_equal(got.status.numpy(), np.asarray(ref.status))
    assert np.array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    assert np.array_equal(got.basis.numpy(), np.asarray(ref.basis))
    ok = np.asarray(ref.status) == jlp.OPTIMAL
    np.testing.assert_allclose(got.objective.numpy()[ok], np.asarray(ref.objective)[ok],
                               rtol=0, atol=1e-9)
    full = shim.solve(tb)
    assert torch.equal(full.status, got.status)
    np.testing.assert_allclose(got.objective.numpy()[ok], full.objective.numpy()[ok],
                               rtol=1e-9)


def test_shim_hyperbox_matches_the_front_door():
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(4), 16, 5, device="cpu")
    got = _shim(tsolver).solve_hyperbox(lo, hi, d, device="cpu")
    assert torch.equal(got.objective, repro_torch.solve_hyperbox(lo, hi, d,
                                                                 device="cpu").objective)


@pytest.mark.parametrize("script,args", [("torch_quickstart.py", []),
                                         ("torch_reachability.py", ["--steps", "10"])])
def test_examples_run_on_the_cpu(script, args):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(root / "examples" / script), "--device", "cpu",
                           *args], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "identical to one round: True" in proc.stdout or "LP/s" in proc.stdout
