"""The float64 reference on hand-solved LPs, against HiGHS, and its TF32 control."""

import numpy as np
import pytest
import torch

from bench.reference import simplex64 as ref


def solve_one(a, b, c, **kw):
    t = [torch.tensor(v, dtype=torch.float64)[None] for v in (a, b, c)]
    out = ref.solve(*t, **kw)
    return float(out.objective[0]), out.x[0].tolist(), int(out.status[0]), int(out.iterations[0])


def test_a_feasible_start_reaches_the_vertex():
    # max x + 2y, x <= 2, y <= 3, x + y <= 4: the optimum (1, 3), value 7.
    obj, x, status, iters = solve_one([[1, 0], [0, 1], [1, 1]], [2, 3, 4], [1, 2])
    assert status == ref.OPTIMAL and obj == pytest.approx(7.0) and x == pytest.approx([1, 3])
    assert iters == 2


def test_phase_one_finds_a_start_then_phase_two_the_optimum():
    # max x + y, x <= 3, y <= 2, x + y >= 1 (as -x - y <= -1): the optimum (3, 2).
    obj, x, status, _ = solve_one([[1, 0], [0, 1], [-1, -1]], [3, 2, -1], [1, 1])
    assert status == ref.OPTIMAL and obj == pytest.approx(5.0) and x == pytest.approx([3, 2])


def test_an_unbounded_lp():
    # max x, -x + y <= 1: x grows without end.
    _, x, status, _ = solve_one([[-1, 1]], [1], [1, 0])
    assert status == ref.UNBOUNDED and x == [0, 0]


def test_an_infeasible_lp():
    # x <= 1 and x >= 2.
    _, _, status, _ = solve_one([[1], [-1]], [1, -2], [1])
    assert status == ref.INFEASIBLE


def test_a_batch_agrees_with_highs():
    from scipy.optimize import linprog

    rng = np.random.default_rng(4)
    bsz, m, n = 12, 9, 7
    a = rng.uniform(-1, 1, (bsz, m, n))
    a[:, np.arange(n), np.arange(n)] = np.abs(a[:, np.arange(n), np.arange(n)]) + 1
    b = rng.uniform(-1, 10, (bsz, m))
    c = rng.uniform(-0.5, 1, (bsz, n))
    out = ref.solve(*(torch.tensor(v) for v in (a, b, c)))
    codes = {0: ref.OPTIMAL, 2: ref.INFEASIBLE, 3: ref.UNBOUNDED}
    for k in range(bsz):
        hs = linprog(-c[k], A_ub=a[k], b_ub=b[k], bounds=[(0, None)] * n, method="highs")
        assert int(out.status[k]) == codes[hs.status], k
        if hs.status == 0:
            assert float(out.objective[k]) == pytest.approx(-hs.fun, rel=1e-9, abs=1e-9)
            assert out.x[k].numpy() == pytest.approx(hs.x, abs=1e-7)


def test_tf32_keeps_ten_mantissa_bits():
    one = torch.tensor([1.0, 1.0 + 2**-12, 1.0 + 2**-10, -(1.0 + 2**-12), 3.0])
    assert ref.tf32(one).tolist() == [1.0, 1.0, 1.0 + 2**-10, -1.0, 3.0]


def test_the_control_computes_in_float32_with_tf32_products():
    rng = np.random.default_rng(2)
    a, b, c = (torch.tensor(v) for v in (rng.uniform(0.1, 1, (4, 6, 5)),
                                          rng.uniform(1, 2, (4, 6)), rng.uniform(0.1, 1, (4, 5))))
    exact, ctl = ref.solve(a, b, c), ref.solve(a, b, c, control=True)
    assert torch.equal(exact.status, ctl.status)
    gap = (exact.objective - ctl.objective).abs().max()
    assert 0 < float(gap) < 1e-2
