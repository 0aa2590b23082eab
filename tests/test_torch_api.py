"""``repro_torch.solve`` against ``repro.solve`` through the front door.

General-form problems (equality rows, free variables, two-sided bounds,
minimize), boxlike problems, heterogeneous lists, the ``reference``
backend, and a round trip through ``core/convert.py`` in which a JAX
``ResumeState`` continues in the port.  Tolerances as in
``tests/test_torch_simplex.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import lp as jlp
from repro.core import simplex as jsimplex
from repro_torch.core import convert
from repro_torch.core import lp as tlp
from repro_torch.core import simplex as tsimplex
from repro_torch.kernels import hyperbox_cuda

from test_torch_simplex import RTOL, _batches, assert_matches_reference

JAX_XLA = repro.SolveOptions(backend="xla", autotune="off")


def _general_form(seed, bsz=6, m=4, n=5, dtype=np.float64):
    """Random feasible general-form data with every kind of bound."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, size=(bsz, m, n))
    x0 = rng.uniform(0.2, 1.0, size=(bsz, n))
    ax0 = np.einsum("bmn,bn->bm", a, x0)
    bl = ax0 - rng.uniform(0.1, 1.0, size=(bsz, m))
    bu = ax0 + rng.uniform(0.1, 1.0, size=(bsz, m))
    bl[:, 0] = bu[:, 0] = ax0[:, 0]  # equality row
    bl[:, 1] = -np.inf  # one-sided row
    lo = np.zeros((bsz, n))
    lo[:, 0] = -np.inf  # free variable
    lo[:, 1] = -0.5  # shifted bound
    hi = np.full((bsz, n), np.inf)
    hi[:, 1:3] = 2.0  # two-sided variable bounds
    c = rng.uniform(-1.0, 1.0, size=(bsz, n))
    return [np.asarray(v, dtype) for v in (c, a, bl, bu, lo, hi)]


def _compare(sol_t, sol_j, dtype=np.float64):
    status = np.asarray(sol_j.status)
    assert np.array_equal(sol_t.status.cpu().numpy(), status)
    assert np.array_equal(sol_t.iterations.cpu().numpy(), np.asarray(sol_j.iterations))
    ok = status == jlp.OPTIMAL
    rtol = RTOL[dtype]
    obj_t, obj_j = sol_t.objective.cpu().numpy(), np.asarray(sol_j.objective)
    np.testing.assert_allclose(obj_t[ok], obj_j[ok], rtol=rtol, atol=rtol)
    assert np.array_equal(obj_t[~ok], obj_j[~ok])
    np.testing.assert_allclose(sol_t.x.cpu().numpy(), np.asarray(sol_j.x), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_general_form_matches_reference(maximize, backend):
    c, a, bl, bu, lo, hi = _general_form(3)
    pj = repro.LPProblem.make(c, a, bl=bl, bu=bu, lo=lo, hi=hi, maximize=maximize)
    pt = repro_torch.LPProblem.make(c, a, bl=bl, bu=bu, lo=lo, hi=hi, maximize=maximize,
                                    device="cpu")
    assert (pt.split, pt.boxlike, pt.row_lower, pt.var_upper) == (
        pj.split, pj.boxlike, pj.row_lower, pj.var_upper)
    sol_j = repro.solve(pj, JAX_XLA)
    sol_t = repro_torch.solve(pt, repro_torch.SolveOptions(backend=backend))
    assert (sol_t.status.numpy() == jlp.OPTIMAL).any()
    _compare(sol_t, sol_j)


def test_canonical_batch_and_chunking_match_reference():
    jb, tb = _batches(8, 28, 28, True, np.float32)
    sol_j = repro.solve(jb, JAX_XLA)
    stats = repro_torch.SolveStats()
    sol_t = repro_torch.solve(tb, repro_torch.SolveOptions(chunk_size=3), stats=stats)
    assert_matches_reference(sol_t, sol_j, np.float32)
    assert (stats.lps, stats.rounds) == (8, 3)
    assert stats.simplex_iterations == int(np.asarray(sol_j.iterations).sum())
    assert stats.tableau_bytes == 3 * 29 * (1 + 28 + 28) * 4


@pytest.mark.parametrize("backend", ["cuda", "torch", "reference"])
@pytest.mark.parametrize("maximize", [True, False])
def test_boxlike_problems(backend, maximize):
    rng = np.random.default_rng(8)
    lo = rng.uniform(-2.0, 0.0, size=(9, 6))
    hi = lo + rng.uniform(0.0, 3.0, size=(9, 6))
    hi[4, 2] = lo[4, 2] - 1.0  # empty box: INFEASIBLE
    c = rng.normal(size=(9, 6))
    pj = repro.LPProblem.make(c, lo=lo, hi=hi, maximize=maximize)
    pt = repro_torch.LPProblem.make(c, lo=lo, hi=hi, maximize=maximize, device="cpu")
    assert pt.boxlike
    sol_j = repro.solve(pj)
    before = hyperbox_cuda.launches
    sol_t = repro_torch.solve(pt, repro_torch.SolveOptions(backend=backend))
    assert hyperbox_cuda.launches == before
    _compare(sol_t, sol_j)
    assert int(sol_t.status[4]) == jlp.INFEASIBLE


def test_solve_hyperbox_entry_point():
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(2), 40, 7, device="cpu")
    lo_j, hi_j, d_j = jlp.random_hyperbox_batch(np.random.default_rng(2), 40, 7)
    sol_t = repro_torch.solve_hyperbox(lo, hi, d, device="cpu")
    sol_j = repro.solve_hyperbox(lo_j, hi_j, d_j)
    np.testing.assert_allclose(sol_t.objective.numpy(), np.asarray(sol_j.objective),
                               rtol=1e-6, atol=1e-6)
    assert np.array_equal(sol_t.x.numpy(), np.asarray(sol_j.x))


def test_heterogeneous_list_matches_reference():
    rng_j, rng_t = np.random.default_rng(21), np.random.default_rng(21)
    pj, pt = [], []
    for m, n in [(5, 5), (28, 28), (3, 5), (12, 9), (5, 5)]:
        jb = jlp.random_lp_batch(rng_j, 1, m, n, True, dtype=np.float64)
        tlp.random_lp_batch(rng_t, 1, m, n, True, dtype=np.float64, device="cpu")
        a, b, c = (np.asarray(v)[0] for v in (jb.a, jb.b, jb.c))
        pj.append(repro.LPProblem.make(c, a, bu=b))
        pt.append(repro_torch.LPProblem.make(c, a, bu=b, device="cpu"))
    box = dict(c=[1.0, -2.0, 0.5], lo=[0.0, -1.0, 0.0], hi=[1.0, 1.0, 2.0])
    pj.append(repro.LPProblem.make(**box))
    pt.append(repro_torch.LPProblem.make(**box, device="cpu"))
    sols_j = repro.solve(pj, JAX_XLA)
    sols_t = repro_torch.solve(pt)
    assert len(sols_t) == len(sols_j)
    for st, sj in zip(sols_t, sols_j):
        assert st.x.shape == np.asarray(sj.x).shape
        _compare(st, sj)


def test_reference_backend_matches_reference():
    jb, tb = _batches(6, 10, 10, True, np.float64)
    sol_j = repro.solve(jb, repro.SolveOptions(backend="reference", autotune="off"))
    sol_t = repro_torch.solve(tb, repro_torch.SolveOptions(backend="reference"))
    for f in ("objective", "x", "status", "iterations"):
        assert np.array_equal(getattr(sol_t, f).numpy(), np.asarray(getattr(sol_j, f)))


def test_jax_resume_state_continues_in_the_port():
    jb, tb = _batches(8, 20, 10, False, np.float32)
    _, jstate = jsimplex.solve_batched(jb.a, jb.b, jb.c, max_iters=12, want_state=True)
    state = convert.from_numpy(tlp.ResumeState, convert.to_numpy(jstate), device="cpu")
    assert state.basis.dtype == torch.int32
    batch = convert.from_numpy(tlp.LPBatch, convert.to_numpy(jb), device="cpu")
    sol_t = tsimplex.resume_batched(batch.b, batch.c, state, max_iters=60, want_state=False)
    sol_j = jsimplex.resume_batched(jb.b, jb.c, jstate, max_iters=60, want_state=False)
    assert_matches_reference(sol_t, sol_j, np.float32)
    out = convert.to_numpy(sol_t)
    assert set(out) == {"objective", "x", "status", "iterations", "basis", "y"}
    assert out["y"] is None  # the dual point is pdhg's only
    assert out["status"].dtype == np.int32 and out["basis"].dtype == np.int32


def test_problem_round_trip_keeps_structure_flags():
    c, a, bl, bu, lo, hi = _general_form(5)
    pj = repro.LPProblem.make(c, a, bl=bl, bu=bu, lo=lo, hi=hi, maximize=False)
    pt = convert.from_numpy(repro_torch.LPProblem, convert.to_numpy(pj), device="cpu")
    assert (pt.maximize, pt.split, pt.row_lower, pt.var_upper) == (False, True, True, True)
    _compare(repro_torch.solve(pt, repro_torch.SolveOptions(backend="torch")),
             repro.solve(pj, JAX_XLA))


def test_empty_and_invalid_inputs():
    p = repro_torch.LPProblem.make(np.zeros((0, 3)), device="cpu")
    assert repro_torch.solve(p).x.shape == (0, 3)
    with pytest.raises(ValueError, match="LPProblem.c contains NaN"):
        repro_torch.LPProblem.make([1.0, np.nan], device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        repro_torch.solve(tlp.LPBatch.from_numpy(np.ones((1, 1, 1)), np.ones((1, 1)),
                                                 np.ones((1, 1)), device="cpu"),
                          repro_torch.SolveOptions(backend="xla"))
    with pytest.raises(ValueError, match="pivot rule"):
        repro_torch.SolveOptions(rule="steepest")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.LPProblem.make([1.0, 2.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlp.LPBatch.from_numpy(np.ones((1, 1, 1)), np.ones((1, 1)), np.ones((1, 1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.solve_hyperbox(np.zeros((1, 2)), np.ones((1, 2)), np.ones((1, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlp.random_lp_batch(np.random.default_rng(0), 1, 2, 2)
    assert repro_torch.SolveOptions().backend == "cuda"


def test_import_hygiene():
    code = (
        "import sys, repro_torch, repro_torch.kernels.ops, repro_torch.core.convert, "
        "repro_torch.core.oracle, repro_torch.core.revised, repro_torch.core.support, "
        "repro_torch.core.reach, repro_torch.kernels.revised_cuda, repro_torch.core.pdhg, "
        "repro_torch.kernels.pdhg_cuda\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
