"""The port's lockstep simplex against ``repro.core.simplex`` (the ``xla`` backend).

The fixtures are those of ``tests/test_kernels.py`` (5x5 up to 60x60,
and the infeasible-start 20x10 and 24x12), under every pivot rule, in
float32 and float64.  Status, iteration count and final basis must be
equal per LP; the objective agrees to rtol 1e-5 (float32) or 1e-9
(float64).  The float bits differ because XLA sums the phase-II pricing
in another order, and in float32 because its fused loop contracts the
rank-1 update ``tab - col * npr`` into a fused multiply-add, which the
port follows through float64 (rounded once, but a double rounding away
from an FMA in rare last bits).  At 100x100 the same trajectories hold
(``test_float32_trajectories_match_at_the_paper_size``).  x is compared to an absolute error of XTOL times the largest |x|:
on the 60x60 fixture under rpc and bland in float32 each package's x
is off the float64 solution for the same basis by up to 1.4e-5 of max|x|
(measured), so the two may differ by about twice that.
"""

import numpy as np
import pytest
import torch

from repro.core import lp as jlp
from repro.core import simplex as jsimplex
from repro_torch.core import lp as tlp
from repro_torch.core import simplex as tsimplex

# The batches here are tiny.  One intra-op thread per test process keeps
# torch's idle OpenMP workers from spinning beside pytest-xdist's other
# processes; the test_torch_* modules that import this one share it.
torch.set_num_threads(1)

FIXTURES = [
    (16, 5, 5, True),
    (16, 10, 10, True),
    (8, 28, 28, True),
    (4, 60, 60, True),
    (8, 20, 10, False),
    (5, 24, 12, False),
]
RTOL = {np.float32: 1e-5, np.float64: 1e-9}
XTOL = {np.float32: 1e-4, np.float64: 1e-9}


def _batches(batch, m, n, feasible, dtype):
    seed = batch * 1000003 + m * 101 + n
    jb = jlp.random_lp_batch(np.random.default_rng(seed), batch, m, n, feasible, dtype=dtype)
    tb = tlp.random_lp_batch(np.random.default_rng(seed), batch, m, n, feasible, dtype=dtype,
                             device="cpu")
    return jb, tb


def assert_matches_reference(sol_t, sol_j, dtype):
    status = np.asarray(sol_j.status)
    assert np.array_equal(sol_t.status.numpy(), status)
    assert np.array_equal(sol_t.iterations.numpy(), np.asarray(sol_j.iterations))
    assert np.array_equal(sol_t.basis.numpy(), np.asarray(sol_j.basis))
    ok = status == jlp.OPTIMAL
    rtol = RTOL[dtype]
    obj_t, obj_j = sol_t.objective.numpy(), np.asarray(sol_j.objective)
    np.testing.assert_allclose(obj_t[ok], obj_j[ok], rtol=rtol)
    assert np.array_equal(obj_t[~ok], obj_j[~ok])  # -inf where not optimal
    x_j = np.asarray(sol_j.x)
    np.testing.assert_allclose(sol_t.x.numpy(), x_j, rtol=rtol,
                               atol=XTOL[dtype] * max(1.0, float(np.abs(x_j).max())))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("batch,m,n,feasible", FIXTURES)
def test_solve_batched_matches_reference(batch, m, n, feasible, rule, dtype):
    jb, tb = _batches(batch, m, n, feasible, dtype)
    sol_j = jsimplex.solve_batched(jb.a, jb.b, jb.c, rule=rule, seed=7)
    sol_t = tsimplex.solve_batched(tb.a, tb.b, tb.c, rule=rule, seed=7)
    assert_matches_reference(sol_t, sol_j, dtype)


@pytest.mark.parametrize("layout", ["compact", "dense"])
@pytest.mark.parametrize("rule", ["lpc", "rpc"])
def test_resume_chain_matches_reference_and_one_solve(layout, rule):
    batch, m, n, feasible = 8, 20, 10, False
    jb, tb = _batches(batch, m, n, feasible, np.float32)
    k1, k2 = 9, 40
    full = tsimplex.solve_batched(tb.a, tb.b, tb.c, rule=rule, seed=3, max_iters=k1 + k2,
                                  layout=layout)
    part, state = tsimplex.solve_batched(tb.a, tb.b, tb.c, rule=rule, seed=3, max_iters=k1,
                                         want_state=True, layout=layout)
    assert (part.status.numpy() == jlp.ITER_LIMIT).any()
    # The RPC counter restarts at 0 in a resumed round, in both packages.
    rest, _ = tsimplex.resume_batched(tb.b, tb.c, state, rule=rule, seed=3, max_iters=k2)
    if rule == "lpc":
        assert torch.equal(rest.status, full.status)
        assert torch.equal(part.iterations + rest.iterations, full.iterations)
        assert torch.equal(rest.objective, full.objective)
        assert torch.equal(rest.x, full.x)
    _, jstate = jsimplex.solve_batched(jb.a, jb.b, jb.c, rule=rule, seed=3, max_iters=k1,
                                       want_state=True, layout=layout)
    jrest, _ = jsimplex.resume_batched(jb.b, jb.c, jstate, rule=rule, seed=3, max_iters=k2)
    assert_matches_reference(rest, jrest, np.float32)


def test_init_batched_then_resume_equals_cold_solve():
    _, tb = _batches(8, 10, 10, True, np.float64)
    state = tsimplex.init_batched(tb.a, tb.b, tb.c)
    resumed = tsimplex.resume_batched(tb.b, tb.c, state, want_state=False)
    cold = tsimplex.solve_batched(tb.a, tb.b, tb.c)
    for f in ("objective", "x", "status", "iterations", "basis"):
        assert torch.equal(getattr(resumed, f), getattr(cold, f))


def test_resolve_cap_auto_rule():
    assert tsimplex.resolve_cap(0, 10, 20) == jsimplex.resolve_cap(0, 10, 20) == 1500
    assert tsimplex.resolve_cap(7, 10, 20) == 7


@pytest.mark.parametrize("rule", ["bland", "rpc", "lpc"])
def test_float32_trajectories_match_at_the_paper_size(rule):
    # 8 LPs of 100x100: the port's rank-1 update is rounded once in float32,
    # as XLA's contracted update is; rounded twice, this fixture diverged
    # on 8, 3 and 1 of the 8 LPs under bland, rpc and lpc.
    args = (8, 100, 100, True)
    jb = jlp.random_lp_batch(np.random.default_rng(1808), *args)
    tb = tlp.random_lp_batch(np.random.default_rng(1808), *args, device="cpu")
    sol_j = jsimplex.solve_batched(jb.a, jb.b, jb.c, rule=rule, seed=7)
    sol_t = tsimplex.solve_batched(tb.a, tb.b, tb.c, rule=rule, seed=7)
    assert np.array_equal(sol_t.status.numpy(), np.asarray(sol_j.status))
    assert np.array_equal(sol_t.iterations.numpy(), np.asarray(sol_j.iterations))
    assert np.array_equal(sol_t.basis.numpy(), np.asarray(sol_j.basis))
