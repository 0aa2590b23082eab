"""Support functions and reachability in the port against ``repro.core.support``/``reach``.

The same directions go through both packages (``device="cpu"``).  The
support values agree to 1e-5 absolute (float32 supports of O(1)
polytopes; a warm search may end at another vertex of a non-unique
optimum, never at another value), statuses and pivot totals exactly.
"""

import numpy as np
import pytest
import torch

from repro.core import reach as jreach
from repro.core import support as jsupport
from repro.core.backends import SolveOptions as JOptions
from repro.core.backends import SolveStats as JStats
from repro_torch.core import reach as treach
from repro_torch.core import support as tsupport
from repro_torch.core.backends import SolveOptions, SolveStats
from repro_torch.kernels import hyperbox_cuda

ATOL = 1e-5
JAX_BACKEND = {"cuda": "xla", "torch": "xla", "cuda-shared": "xla-shared",
               "torch-shared": "xla-shared", "reference": "reference"}


def _jopts(backend):
    return JOptions(backend=JAX_BACKEND[backend], autotune="off")


def _simplex_polytope(n):
    a = np.concatenate([-np.eye(n), np.ones((1, n))], axis=0).astype(np.float32)
    b = np.concatenate([np.zeros(n), np.ones(1)]).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kind", ["box", "oct", "uniform:9"])
def test_template_directions_match_reference(kind):
    assert np.array_equal(tsupport.template_directions(4, kind),
                          jsupport.template_directions(4, kind))


@pytest.mark.parametrize("backend", ["cuda", "torch", "reference", "cuda-shared"])
def test_box_support_matches_reference(backend):
    rng = np.random.default_rng(3)
    lo = rng.uniform(-2.0, 0.0, size=6)
    hi = lo + rng.uniform(0.5, 2.0, size=6)
    dirs = rng.normal(size=(11, 6)).astype(np.float32)
    got = tsupport.Box(lo, hi).support(dirs, SolveOptions(backend=backend), device="cpu")
    want = jsupport.Box(lo, hi).support(dirs, _jopts(backend))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    stats = SolveStats()
    tsupport.Box(lo, hi).support(dirs, stats=stats, device="cpu")
    assert (stats.lps, stats.simplex_iterations) == (11, 0)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_polytope_support_and_solutions_match_reference(backend):
    a, b = _simplex_polytope(5)
    dirs = np.random.default_rng(61).normal(size=(9, 5)).astype(np.float32)
    tp, jp = tsupport.Polytope(a, b), jsupport.Polytope(a, b)
    sol_t = tp.support_solutions(dirs, SolveOptions(backend=backend), device="cpu")
    sol_j = jp.support_solutions(dirs, _jopts(backend))
    assert np.array_equal(sol_t.status.numpy(), np.asarray(sol_j.status))
    assert np.array_equal(sol_t.iterations.numpy(), np.asarray(sol_j.iterations))
    np.testing.assert_allclose(sol_t.objective.numpy(), np.asarray(sol_j.objective), atol=ATOL)
    np.testing.assert_allclose(tp.support(dirs, SolveOptions(backend=backend), device="cpu"),
                               np.asarray(sol_j.objective), atol=ATOL)
    shared = tp.to_shared_batch(dirs, device="cpu").densify()
    dense = tp.to_lp_batch(dirs, device="cpu")
    for f in ("a", "b", "c"):
        assert torch.equal(getattr(shared, f), getattr(dense, f))
    ref = jp.to_shared_batch(dirs)
    assert np.array_equal(tp.to_shared_batch(dirs, device="cpu").a.numpy(), np.asarray(ref.a))


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("backend", ["cuda-shared", "torch-shared", "cuda"])
def test_support_sweep_matches_reference(backend, warm):
    a, b = _simplex_polytope(6)
    stack = np.random.default_rng(51).normal(size=(4, 16, 6)).astype(np.float32)
    ts, js = SolveStats(), JStats()
    got = tsupport.Polytope(a, b).support_sweep(stack, SolveOptions(backend=backend),
                                                warm_start=warm, stats=ts, device="cpu")
    want = np.asarray(jsupport.Polytope(a, b).support_sweep(stack, _jopts(backend),
                                                            warm_start=warm, stats=js))
    assert tuple(got.shape) == (4, 16)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got.numpy()), finite)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], atol=ATOL)
    assert (ts.lps, ts.simplex_iterations) == (js.lps, js.simplex_iterations)
    assert ts.warm_started == js.warm_started
    assert (ts.warm_started > 0) == warm


def test_shared_sweep_rejects_a_dense_only_backend():
    a, b = _simplex_polytope(3)
    stack = np.ones((2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shared sweep"):
        tsupport.Polytope(a, b).support_sweep(stack, SolveOptions(backend="reference"),
                                              shared=True, device="cpu")


@pytest.mark.parametrize("backend", ["cuda-shared", "cuda"])
@pytest.mark.parametrize("model,kind", [("five_dim_model", "oct"), ("helicopter_model", "box")])
def test_reach_supports_match_reference(model, kind, backend):
    jm, tm = getattr(jreach, model)(), getattr(treach, model)()
    assert np.array_equal(tm.a, jm.a)
    dirs = jsupport.template_directions(jm.dim, kind)
    steps = 10
    js, ts = JStats(), SolveStats()
    want, _ = jreach.reach_supports(jm, 0.02, steps, directions=dirs, options=_jopts(backend),
                                    use_hyperbox=False, warm_start=True, stats=js)
    before = hyperbox_cuda.launches
    got, got_dirs = treach.reach_supports(tm, 0.02, steps, directions=dirs,
                                          options=SolveOptions(backend=backend),
                                          use_hyperbox=False, warm_start=True, stats=ts,
                                          device="cpu")
    assert hyperbox_cuda.launches == before  # CPU tensors: the plain versions
    assert np.array_equal(got_dirs, dirs)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (ts.lps, ts.simplex_iterations, ts.warm_started) == (
        js.lps, js.simplex_iterations, js.warm_started)
    box, _ = treach.reach_supports(tm, 0.02, steps, directions=dirs, device="cpu")
    np.testing.assert_allclose(got, box, atol=ATOL * max(1.0, float(np.abs(box).max())))
    want_box, _ = jreach.reach_supports(jm, 0.02, steps, directions=dirs)
    np.testing.assert_allclose(box, want_box, rtol=1e-6, atol=1e-7)


def test_count_lps_and_cold_reach():
    assert treach.count_lps(200, 50, False) == jreach.count_lps(200, 50, False) == 20_000
    m = treach.five_dim_model()
    dirs = tsupport.template_directions(5, "box")
    got, _ = treach.reach_supports(m, 0.02, 4, directions=dirs,
                                   options=SolveOptions(backend="torch"), use_hyperbox=False,
                                   device="cpu")
    want, _ = jreach.reach_supports(jreach.five_dim_model(), 0.02, 4, directions=dirs,
                                    options=_jopts("torch"), use_hyperbox=False)
    np.testing.assert_allclose(got, want, atol=ATOL)
