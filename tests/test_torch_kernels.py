"""The port's kernel entry points on CPU tensors against ``repro.kernels.ops``.

On the CPU the wrappers run the kernels' plain versions (the reference's
wrappers run Pallas in interpret mode).  Tolerances as in
``tests/test_torch_simplex.py``; the hyperbox sums agree to rtol 1e-6.
The kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import lp as jlp
from repro.kernels import ops as jops
from repro_torch.core import lp as tlp
from repro_torch.core import simplex as tsimplex
from repro_torch.kernels import hyperbox_cuda, ops, simplex_cuda

from test_torch_simplex import _batches, assert_matches_reference


@pytest.mark.parametrize("batch,m,n,feasible,rule,dtype", [
    (8, 10, 10, True, "lpc", np.float32),
    (8, 20, 10, False, "bland", np.float32),
    (6, 12, 12, True, "rpc", np.float64),
    (5, 24, 12, False, "lpc", np.float64),
])
def test_simplex_solve_matches_pallas_interpret(batch, m, n, feasible, rule, dtype):
    jb, tb = _batches(batch, m, n, feasible, dtype)
    sol_j = jops.simplex_solve(jb.a, jb.b, jb.c, rule=rule, seed=5)
    before = simplex_cuda.launches
    sol_t = ops.simplex_solve(tb.a, tb.b, tb.c, rule=rule, seed=5)
    assert simplex_cuda.launches == before  # CPU tensors: the plain version ran
    assert_matches_reference(sol_t, sol_j, dtype)


@pytest.mark.parametrize("layout", ["compact", "dense"])
def test_simplex_resume_chain_equals_one_solve(layout):
    jb, tb = _batches(8, 20, 10, False, np.float32)
    full = ops.simplex_solve(tb.a, tb.b, tb.c, max_iters=30, layout=layout)
    part, state = ops.simplex_solve(tb.a, tb.b, tb.c, max_iters=11, want_state=True,
                                    layout=layout)
    tab_before = state.tab.clone()
    rest, state2 = ops.simplex_resume(tb.b, tb.c, state, max_iters=19)
    assert torch.equal(state.tab, tab_before)  # the caller's state is not consumed
    assert state2.tab.shape == state.tab.shape
    assert torch.equal(rest.status, full.status)
    assert torch.equal(part.iterations + rest.iterations, full.iterations)
    assert torch.equal(rest.objective, full.objective)
    assert torch.equal(rest.x, full.x)
    assert torch.equal(rest.basis, full.basis)
    jsol = jops.simplex_resume(jb.b, jb.c, jops.simplex_solve(
        jb.a, jb.b, jb.c, max_iters=11, want_state=True, layout=layout)[1], max_iters=19)[0]
    assert_matches_reference(rest, jsol, np.float32)


def test_simplex_plain_writes_state_in_place():
    _, tb = _batches(4, 10, 10, True, np.float64)
    ref_sol, ref_state = tsimplex.solve_batched(tb.a, tb.b, tb.c, want_state=True)
    sol, state = ops.simplex_solve(tb.a, tb.b, tb.c, want_state=True)
    assert torch.equal(state.tab, ref_state.tab)
    assert torch.equal(state.phase, ref_state.phase)
    assert torch.equal(sol.objective, ref_sol.objective)


def test_simplex_wrapper_checks_inputs():
    spec = tsimplex.TableauSpec(3, 2)
    tab = torch.zeros((2, 4, spec.q))
    good = dict(basis=torch.zeros((2, 3), dtype=torch.int32),
                phase=torch.ones(2, dtype=torch.int32), c_ext=torch.zeros((2, spec.q)),
                feas=torch.ones(2))
    bad = dict(good, basis=torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="basis"):
        simplex_cuda.simplex(tab, cap=5, spec=spec, **bad)
    with pytest.raises(ValueError, match="c_ext"):
        simplex_cuda.simplex(tab, cap=5, spec=spec, **dict(good, c_ext=torch.zeros((2, 3))))


@pytest.mark.parametrize("n", [3, 5, 28, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hyperbox_support_matches_pallas_interpret(n, dtype):
    rng_j, rng_t = np.random.default_rng(n), np.random.default_rng(n)
    lo_j, hi_j, d_j = jlp.random_hyperbox_batch(rng_j, 57, n, dtype=dtype)
    lo, hi, d = tlp.random_hyperbox_batch(rng_t, 57, n, dtype=dtype, device="cpu")
    assert np.array_equal(d.numpy(), np.asarray(d_j))
    ref = np.asarray(jops.hyperbox_support(lo_j, hi_j, d_j))
    np.testing.assert_allclose(ops.hyperbox_support(lo, hi, d).numpy(), ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))
    # One box for every direction (row stride 0 in the kernel).
    ref1 = np.asarray(jops.hyperbox_support(lo_j[0], hi_j[0], d_j))
    got1 = ops.hyperbox_support(lo[0], hi[0], d).numpy()
    np.testing.assert_allclose(got1, ref1, rtol=1e-6, atol=1e-6 * float(np.abs(ref1).max()))


def test_hyperbox_wrapper_checks_shapes():
    d = torch.zeros((4, 3), device="cpu")
    assert hyperbox_cuda._box_stride(torch.zeros(3), d, "lo") == 0
    assert hyperbox_cuda._box_stride(torch.zeros(4, 3), d, "lo") == 3
    with pytest.raises(ValueError, match="lo"):
        hyperbox_cuda._box_stride(torch.zeros(2, 3), d, "lo")
