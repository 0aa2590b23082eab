"""The port's first-order path against ``repro.core.pdhg`` and ``repro.solve``.

The inputs are ``tests/test_engine.py:_fixture_batch`` (22 LPs of 12x6:
feasible, two-phase, unbounded, infeasible and degenerate rows) and the
numpy-seeded cases of ``tests/test_pdhg.py``, in float32 and float64,
through both packages (``device="cpu"``: the PDHG kernel's plain
version).

Tolerances:

* ``step_sizes``: rtol 1e-6 (float32) / 1e-12 (float64); the power
  iteration's products reduce in another order in torch than in XLA.
* the iterates: status and step count per LP are equal; ``x`` and ``y``
  within an absolute XTOL = 1e-4 (float32) / 1e-9 (float64), the
  reference's own kernel-against-XLA tolerance; ``ax``, the running sums
  and the growth norms, which reach ``restart`` times the iterates'
  size, within STATE_RTOL = 1e-6 / 1e-12 of their largest magnitude
  (measured: at most 1.3e-7 in float32 at cap 400 on the fixture).
* crossover in float64: the objective within 1e-9 of the float64
  oracle (relative to 1 + |obj|, as the reference's test).

The long runs are capped where the reference runs to its auto cap: the
plain loop costs about a millisecond a step on the CPU.  Each such cap
is the smallest that still reaches the case's decisions, and the JAX
side runs at the same cap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import lp as jlp
from repro.core import pdhg as jpdhg
from repro_torch.core import backends as tbackends
from repro_torch.core import convert
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import lp as tlp
from repro_torch.core import oracle as toracle
from repro_torch.core import pdhg as tpdhg
from repro_torch.core import simplex as tsimplex
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pdhg_cuda

import test_torch_simplex  # noqa: F401  (one intra-op thread per test process)
from test_engine import _fixture_batch

XTOL = {np.float32: 1e-4, np.float64: 1e-9}
STATE_RTOL = {np.float32: 1e-6, np.float64: 1e-12}
STEP_RTOL = {np.float32: 1e-6, np.float64: 1e-12}
STATE_FIELDS = ("x", "y", "ax", "x_sum", "y_sum", "ax_sum", "inner", "x_grow", "y_grow")
JAX_PDHG = repro.SolveOptions(backend="pdhg", autotune="off")


def _fixture(dtype):
    jb = _fixture_batch(dtype=dtype)
    tb = tlp.LPBatch.from_numpy(*(np.asarray(v) for v in (jb.a, jb.b, jb.c)), device="cpu")
    return jb, tb


def _assert_states_close(ts, js, dtype):
    for f in STATE_FIELDS:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        if f == "inner":
            assert np.array_equal(got, want)
        elif f in ("x", "y"):
            np.testing.assert_allclose(got, want, rtol=0, atol=XTOL[dtype], err_msg=f)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=STATE_RTOL[dtype] * scale,
                                       err_msg=f)


def _assert_same_bits(x, y, fields):
    for f in fields:
        assert torch.equal(getattr(x, f), getattr(y, f)), f


@pytest.fixture(scope="module")
def full_solves():
    """The fixture through ``repro_torch.solve(..., backend="pdhg")`` at the auto cap."""
    out = {}
    for dtype in (np.float32, np.float64):
        jb, tb = _fixture(dtype)
        out[dtype] = (jb, tb, repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg")))
    return out


# ---------------------------------------------------------------------------
# the plain loop against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_step_sizes_match_reference(dtype):
    jb, tb = _fixture(dtype)
    jtau, jsigma, jscales = jpdhg.step_sizes(jb.a, jb.b, jb.c)
    ttau, tsigma, tscales = tpdhg.step_sizes(tb.a, tb.b, tb.c)
    for got, want in zip((ttau, tsigma, *tscales), (jtau, jsigma, *jscales)):
        assert got.dtype == tb.a.dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEP_RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_step_from_a_random_state_matches_reference(dtype):
    jb, tb = _fixture(dtype)
    bsz, m, n = tb.a.shape
    rng = np.random.default_rng(11)
    st = dict(x=rng.uniform(0, 3, (bsz, n)), y=rng.uniform(0, 3, (bsz, m)),
              ax=rng.normal(size=(bsz, m)), x_sum=rng.uniform(0, 30, (bsz, n)),
              y_sum=rng.uniform(0, 30, (bsz, m)), ax_sum=rng.normal(size=(bsz, m)),
              x_grow=rng.uniform(0, 3, bsz), y_grow=rng.uniform(0, 3, bsz))
    st = {k: v.astype(dtype) for k, v in st.items()}
    st["inner"] = rng.integers(0, 64, bsz).astype(np.int32)
    st["inner"][:6] = 63  # these rows restart in this step
    jstate = jpdhg.PDHGResumeState(**{k: jnp.asarray(v) for k, v in st.items()})
    tstate = convert.from_numpy(tpdhg.PDHGResumeState, st, device="cpu")
    status = np.zeros(bsz, np.int32)
    status[:2] = tlp.OPTIMAL  # frozen rows
    jtau, jsigma, jscales = jpdhg.step_sizes(jb.a, jb.b, jb.c)
    ttau, tsigma, tscales = tpdhg.step_sizes(tb.a, tb.b, tb.c)
    jout = jpdhg.pdhg_step(jb.a, jb.b, jb.c, *(getattr(jstate, f) for f in STATE_FIELDS),
                           jnp.asarray(status), jnp.zeros(bsz, jnp.int32), jtau, jsigma,
                           jscales, tol=1e-4, restart=64)
    tout = tpdhg.pdhg_step(tb.a, tb.b, tb.c, *(getattr(tstate, f) for f in STATE_FIELDS),
                           torch.as_tensor(status), torch.zeros(bsz, dtype=torch.int32), ttau,
                           tsigma, tscales, tol=1e-4, restart=64)
    assert np.array_equal(tout[-2].numpy(), np.asarray(jout[-2]))  # status
    assert np.array_equal(tout[-1].numpy(), np.asarray(jout[-1]))  # iterations
    _assert_states_close(tpdhg.PDHGResumeState(*tout[:9]),
                         jpdhg.PDHGResumeState(*jout[:9]), dtype)
    assert torch.equal(tout[0][:2], tstate.x[:2])  # frozen rows keep their state


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_capped_solve_matches_reference(dtype):
    jb, tb = _fixture(dtype)
    jsol, jstate = jpdhg.solve_batched(jb.a, jb.b, jb.c, max_iters=400, want_state=True)
    tsol, tstate = tpdhg.solve_batched(tb.a, tb.b, tb.c, max_iters=400, want_state=True)
    assert np.array_equal(tsol.status.numpy(), np.asarray(jsol.status))
    assert np.array_equal(tsol.iterations.numpy(), np.asarray(jsol.iterations))
    _assert_states_close(tstate, jstate, dtype)
    ok = tsol.status.numpy() == tlp.OPTIMAL
    assert ok.any() and (~ok).any()
    np.testing.assert_allclose(tsol.objective.numpy()[ok], np.asarray(jsol.objective)[ok],
                               rtol=XTOL[dtype])
    assert np.all(np.isneginf(tsol.objective.numpy()[~ok]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_full_solve_statuses_match_oracle_and_reference(full_solves, dtype):
    jb, tb, sol = full_solves[dtype]
    obj, _, st, _ = toracle.solve_batch(tb.a.double().numpy(), tb.b.double().numpy(),
                                        tb.c.double().numpy())
    jsol = repro.solve(jb, JAX_PDHG)
    assert np.array_equal(sol.status.numpy(), st)
    assert np.array_equal(sol.status.numpy(), np.asarray(jsol.status))
    assert np.array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    ok = st == tlp.OPTIMAL
    rel = np.abs(sol.objective.numpy()[ok] - obj[ok]) / (1 + np.abs(obj[ok]))
    assert rel.max() < 5e-3  # the reference's bound for pdhg_tol 1e-4
    # the fixture's genuine certificates survive confirmation
    assert np.any(st == tlp.UNBOUNDED) and np.any(st == tlp.INFEASIBLE)
    assert sol.y is not None and tuple(sol.y.shape) == (tb.batch, tb.m)
    assert sol.basis is None


def test_resume_chain_is_bit_identical():
    _, tb = _fixture(np.float32)
    full, full_state = tops.pdhg_solve(tb.a, tb.b, tb.c, max_iters=400, want_state=True)
    part, state = tops.pdhg_solve(tb.a, tb.b, tb.c, max_iters=150, want_state=True)
    kept = {f: getattr(state, f).clone() for f in STATE_FIELDS}
    rest, rest_state = tops.pdhg_resume(tb.a, tb.b, tb.c, state, max_iters=250)
    _assert_same_bits(rest, full, ("objective", "x", "y", "status"))
    _assert_same_bits(rest_state, full_state, STATE_FIELDS)
    assert torch.equal(part.iterations + rest.iterations, full.iterations)
    for f in STATE_FIELDS:  # the resume ran on a copy
        assert torch.equal(getattr(state, f), kept[f]), f
    # the compaction contract: a subset of the carried rows replays exactly
    idx = torch.tensor([0, 3, 7, 16, 18, 20])
    sub = tpdhg.resume_batched(tb.a[idx], tb.b[idx], tb.c[idx], state.take(idx),
                               max_iters=250, want_state=False)
    for f in ("x", "y", "status"):
        assert torch.equal(getattr(sub, f), getattr(rest, f)[idx]), f


def test_jax_resume_state_continues_in_the_port():
    jb, tb = _fixture(np.float32)
    _, jstate = jpdhg.solve_batched(jb.a, jb.b, jb.c, max_iters=300, want_state=True)
    jfull, jfull_state = jpdhg.solve_batched(jb.a, jb.b, jb.c, max_iters=700, want_state=True)
    state = convert.from_numpy(tpdhg.PDHGResumeState, convert.to_numpy(jstate), device="cpu")
    assert state.inner.dtype == torch.int32
    jrest = jpdhg.resume_batched(jb.a, jb.b, jb.c, jstate, max_iters=400, want_state=False)
    rest, rest_state = tops.pdhg_resume(tb.a, tb.b, tb.c, state, max_iters=400)
    assert np.array_equal(rest.status.numpy(), np.asarray(jrest.status))
    assert np.array_equal(rest.iterations.numpy(), np.asarray(jrest.iterations))
    assert np.array_equal(rest.status.numpy(), np.asarray(jfull.status))
    _assert_states_close(rest_state, jfull_state, np.float32)


def test_wrapper_raises_on_a_non_contiguous_state():
    _, tb = _fixture(np.float32)
    bsz, m, n = tb.a.shape
    state = tpdhg.init_state(bsz, m, n, tb.a.dtype)
    tau, sigma, scales = tpdhg.step_sizes(tb.a, tb.b, tb.c)
    bad = tpdhg.PDHGResumeState(**{**{f: getattr(state, f) for f in STATE_FIELDS},
                                   "x": torch.zeros(n, bsz).t()})
    with pytest.raises(ValueError, match="not contiguous"):
        pdhg_cuda.pdhg(tb.a, tb.b, tb.c, bad, tau, sigma, scales, 10, tol=1e-4, restart=64)
    with pytest.raises(ValueError, match="inner"):
        pdhg_cuda.pdhg(tb.a, tb.b, tb.c, dataclasses.replace(state, inner=state.inner.long()),
                       tau, sigma, scales, 10, tol=1e-4, restart=64)


# ---------------------------------------------------------------------------
# certificates
# ---------------------------------------------------------------------------


def test_false_divergence_flags_are_revoked():
    # Bounded "long valley" LPs flagged UNBOUNDED by the in-loop heuristic
    # (row 24 at step 959 in both packages): confirmation on the oracle
    # must revoke them.  Capped at 1,000 steps (the reference runs to
    # 20,000; its other flag fires at step 12,927).
    rng = np.random.default_rng(7)
    jb = jlp.random_lp_batch(rng, 32, 50, 50, feasible_start=True)
    tb = tlp.LPBatch.from_numpy(*(np.asarray(v) for v in (jb.a, jb.b, jb.c)), device="cpu")
    jraw = jpdhg.solve_batched(jb.a, jb.b, jb.c, max_iters=1000)
    raw = tpdhg.solve_batched(tb.a, tb.b, tb.c, max_iters=1000)
    assert np.array_equal(raw.status.numpy(), np.asarray(jraw.status))
    assert np.any(raw.status.numpy() == tlp.UNBOUNDED)  # the heuristic fires
    sol = tdispatch.solve_canonical(tb, repro_torch.SolveOptions(backend="pdhg", max_iters=1000))
    ref = repro_torch.solve(tb, repro_torch.SolveOptions(backend="torch"))
    st, rf = sol.status.numpy(), ref.status.numpy()
    assert not np.any((st == tlp.UNBOUNDED) & (rf != tlp.UNBOUNDED))
    assert not np.any((st == tlp.INFEASIBLE) & (rf != tlp.INFEASIBLE))
    assert np.all(st[raw.status.numpy() == tlp.UNBOUNDED] == tlp.ITER_LIMIT)
    ok = st == tlp.OPTIMAL
    assert np.array_equal(rf[ok], st[ok])


def test_genuine_flags_at_scale_are_kept():
    # 4 LPs of 100x100, rows 0 and 1 unbounded by construction (a positive
    # d with A d <= -0.1 and c . d > 0).  Both packages flag them at steps
    # 3,455 and 3,583; capped at 4,000 (the reference runs to 20,000).
    rng = np.random.default_rng(3)
    m = n = 100
    bsz = 4
    a = rng.standard_normal((bsz, m, n)).astype(np.float32)
    b = (np.abs(rng.standard_normal((bsz, m))) + 0.5).astype(np.float32)
    c = rng.standard_normal((bsz, n)).astype(np.float32)
    for i in (0, 1):
        d = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        a[i] -= np.outer(a[i] @ d + 0.1, d / (d @ d))
        c[i] = np.abs(c[i])
    jsol = jpdhg.solve_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), max_iters=4000)
    tb = tlp.LPBatch.from_numpy(a, b, c, device="cpu")
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg", max_iters=4000))
    st = sol.status.numpy()
    assert st[0] == tlp.UNBOUNDED and st[1] == tlp.UNBOUNDED
    assert np.array_equal(st, np.asarray(jsol.status))
    _, _, exact, _ = toracle.solve_batch(a.astype(np.float64), b.astype(np.float64),
                                         c.astype(np.float64))
    flagged = (st == tlp.UNBOUNDED) | (st == tlp.INFEASIBLE)
    assert np.array_equal(st[flagged], exact[flagged])


# ---------------------------------------------------------------------------
# crossover
# ---------------------------------------------------------------------------


def test_crossover_recovers_exact_vertices(full_solves):
    jb, tb, pdhg_sol = full_solves[np.float64]
    obj, _, st, _ = toracle.solve_batch(tb.a.numpy(), tb.b.numpy(), tb.c.numpy())
    sol = tpdhg.crossover(tb, pdhg_sol)
    jsol = jpdhg.crossover(jb, repro.solve(jb, JAX_PDHG))
    assert np.array_equal(sol.status.numpy(), st)
    ok = st == tlp.OPTIMAL
    rel = np.abs(sol.objective.numpy()[ok] - obj[ok]) / (1 + np.abs(obj[ok]))
    assert rel.max() < 1e-9  # an exact vertex, not a 1e-4-accurate point
    assert np.array_equal(sol.basis.numpy(), np.asarray(jsol.basis))
    assert np.array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    rows = torch.as_tensor(np.nonzero(ok)[0])
    warm = tsimplex.solve_batched(tb.a[rows], tb.b[rows], tb.c[rows], basis0=sol.basis[rows])
    assert bool((warm.status == tlp.OPTIMAL).all())
    assert bool((warm.iterations == 0).all())


def test_crossover_through_solve_matches_reference():
    jb, tb = _fixture(np.float64)
    opts = dict(backend="pdhg", crossover=True, max_iters=400)
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(**opts))
    jsol = repro.solve(jb, repro.SolveOptions(autotune="off", **opts))
    assert np.array_equal(sol.status.numpy(), np.asarray(jsol.status))
    assert np.array_equal(sol.basis.numpy(), np.asarray(jsol.basis))
    assert np.array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    ok = sol.status.numpy() == tlp.OPTIMAL
    assert ok.sum() >= 10
    np.testing.assert_allclose(sol.objective.numpy()[ok], np.asarray(jsol.objective)[ok],
                               rtol=1e-9)


@pytest.mark.parametrize("tile", [8, None])  # the reference's tile and the port's default
def test_crossover_polishes_a_row_alone_as_in_the_batch(full_solves, tile):
    tile = tile or tpdhg.CROSSOVER_TILE
    _, tb, pdhg_sol = full_solves[np.float64]
    batch_sol = tpdhg.crossover(tb, pdhg_sol, tile=tile)
    for row in (0, 9, 21):
        one = tpdhg.crossover(tb.take(slice(row, row + 1)), _take_solution(pdhg_sol, row),
                              tile=tile)
        for f in ("objective", "x", "iterations", "basis"):
            assert torch.equal(getattr(one, f)[0], getattr(batch_sol, f)[row]), (row, f)


def _take_solution(sol, row):
    return tlp.LPSolution(objective=sol.objective[row:row + 1], x=sol.x[row:row + 1],
                          status=sol.status[row:row + 1],
                          iterations=sol.iterations[row:row + 1], y=sol.y[row:row + 1])


@pytest.mark.parametrize("case", ["pinned", "random"])
def test_crossover_basis_breaks_ties_as_top_k(case):
    if case == "pinned":
        # [x | b - Ax] = [0, 3, 0, 1, 0, 3, 0]: torch.topk returns [1, 5, 3, 2],
        # jax.lax.top_k (and the stable sort) [1, 5, 3, 0].
        a = np.zeros((1, 4, 3))
        b = np.array([[1.0, 0.0, 3.0, 0.0]])
        x = np.array([[0.0, 3.0, 0.0]])
    else:
        rng = np.random.default_rng(5)
        a = rng.integers(-1, 2, (16, 9, 7)).astype(np.float64)
        x = np.maximum(rng.integers(-3, 3, (16, 7)), 0).astype(np.float64)
        b = np.einsum("bmn,bn->bm", a, x) + np.maximum(rng.integers(-3, 3, (16, 9)), 0)
    got = tpdhg.crossover_basis(*(torch.as_tensor(v) for v in (a, b, x)))
    want = jpdhg.crossover_basis(*(jnp.asarray(v) for v in (a, b, x)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if case == "pinned":
        assert got.tolist() == [[2, 6, 4, 1]]
        assert np.asarray(jax.lax.top_k(jnp.asarray([[0, 3, 0, 1, 0, 3, 0.0]]), 4)[1]).tolist() \
            == [[1, 5, 3, 0]]


# ---------------------------------------------------------------------------
# routing and options
# ---------------------------------------------------------------------------


def test_route_shape_frontier():
    assert tbackends.route_shape(12, 6) == "cuda"
    assert tbackends.route_shape(499, 499) == "cuda"
    assert tbackends.route_shape(500, 500) == "pdhg"
    assert tbackends.route_shape(1000, 100) == "pdhg"
    assert tbackends.route_shape(12, 6, repro_torch.SolveOptions(route_frontier=8)) == "pdhg"
    assert tbackends.route_shape(1000, 1000, shared=True) == "cuda-shared"
    opts = repro_torch.SolveOptions(backend="auto", rule="rpc", layout="dense")
    big = tdispatch.resolve_backend(opts, shape=(600, 20))
    assert (big.backend, big.rule, big.layout) == ("pdhg", "lpc", None)
    small = tdispatch.resolve_backend(opts, shape=(20, 20))
    assert (small.backend, small.rule, small.layout) == ("cuda", "rpc", "dense")
    assert tdispatch.resolve_backend(opts, shared=True).backend == "cuda-shared"
    with pytest.raises(ValueError, match="shape"):
        tdispatch.resolve_backend(opts)


def test_auto_backend_below_the_frontier_is_the_simplex_kernel():
    _, tb = _fixture(np.float64)
    auto = repro_torch.solve(tb, repro_torch.SolveOptions(backend="auto"))
    ref = repro_torch.solve(tb, repro_torch.SolveOptions(backend="cuda"))
    _assert_same_bits(auto, ref, ("objective", "x", "status", "iterations", "basis"))
    assert auto.y is None


def test_auto_backend_past_the_frontier_is_pdhg():
    jb, tb = _fixture(np.float64)
    stats = repro_torch.SolveStats()
    # rule is a simplex knob: on the pdhg leg it is reset, not rejected.
    auto = repro_torch.solve(tb, repro_torch.SolveOptions(
        backend="auto", route_frontier=5, rule="rpc", max_iters=400), stats=stats)
    pdhg_sol = repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg", max_iters=400))
    _assert_same_bits(auto, pdhg_sol, ("objective", "x", "y", "status", "iterations"))
    jsol = repro.solve(jb, repro.SolveOptions(backend="pdhg", autotune="off", max_iters=400))
    assert np.array_equal(auto.status.numpy(), np.asarray(jsol.status))
    assert stats.tableau_bytes == tb.batch * tpdhg.state_bytes_per_lp(12, 6, torch.float64)
    assert stats.simplex_iterations == int(auto.iterations.sum())


@pytest.mark.parametrize("backend", ["auto", "pdhg"])
def test_box_problems_take_the_hyperbox_path(backend):
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(2), 64, 5, device="cpu")
    problem = repro_torch.LPProblem.make(d, lo=lo, hi=hi, device="cpu")
    got = repro_torch.solve(problem, repro_torch.SolveOptions(backend=backend))
    ref = repro_torch.solve(problem, repro_torch.SolveOptions(backend="cuda"))
    _assert_same_bits(got, ref, ("objective", "x", "status", "iterations"))
    box = repro_torch.solve_hyperbox(lo, hi, d, repro_torch.SolveOptions(backend=backend),
                                     device="cpu")
    assert torch.equal(box.objective, tops.hyperbox_support(lo, hi, d))


def test_chunked_pdhg_solve_carries_y():
    _, tb = _fixture(np.float32)
    one = repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg", max_iters=300))
    chunks = repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg", max_iters=300,
                                                            chunk_size=8))
    _assert_same_bits(one, chunks, ("status", "iterations"))
    assert tuple(chunks.y.shape) == (tb.batch, tb.m)
    np.testing.assert_allclose(chunks.y.numpy(), one.y.numpy(), rtol=0, atol=XTOL[np.float32])


@pytest.mark.parametrize(
    "kw",
    [
        dict(backend="pdhg", rule="bland"),
        dict(backend="pdhg", rule="rpc"),
        dict(backend="pdhg", layout="dense"),
        dict(backend="torch", crossover=True),
        dict(backend="cuda", crossover=True),
        dict(pdhg_tol=-1.0),
        dict(pdhg_restart=-3),
        dict(route_frontier=-1),
    ],
)
def test_options_validation_rejects_meaningless_combos(kw):
    with pytest.raises(ValueError):
        repro_torch.SolveOptions(**kw)


def test_options_pdhg_knobs_accepted():
    opts = repro_torch.SolveOptions(backend="pdhg", pdhg_tol=1e-6, pdhg_restart=128,
                                    crossover=True)
    assert (opts.pdhg_tol, opts.pdhg_restart, opts.crossover) == (1e-6, 128, True)
    opts = repro_torch.SolveOptions(backend="auto", crossover=True, route_frontier=100)
    assert opts.route_frontier == 100
    assert "pdhg" in repro_torch.available_backends()


@pytest.mark.parametrize("mode", ["every_k", "chunked"])
def test_pdhg_compaction_with_basis_resume_equals_off(mode):
    # The PDHG state resumes exactly, so basis-resumed rounds equal one
    # uninterrupted solve: statuses and steps, and x and y bit for bit.
    # Held against the reference's compacted solve as the plain loop is.
    jb, tb = _fixture(np.float32)
    kw = dict(max_iters=400, compaction=mode, compact_every=64, resume="basis")
    off = repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg", max_iters=400))
    stats = repro_torch.SolveStats()
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(backend="pdhg", **kw), stats=stats)
    _assert_same_bits(sol, off, ("status", "iterations", "x", "y", "objective"))
    assert stats.rounds > 1 and stats.resumed > 0
    ref = repro.solve(jb, JAX_PDHG.replace(**kw))
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
