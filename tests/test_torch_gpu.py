"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is
present and skips without one, so every worker collects the same tests.
Run them on a machine with an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The simplex and revised kernels must be bit-identical to their plain
versions in every output and in the terminal state; the hyperbox kernel
agrees to rtol 1e-6 (float32) or 1e-12 (float64) relative to the sum of
|terms|.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine
from repro_torch.core import lp as tlp
from repro_torch.core import revised
from repro_torch.core.simplex import phase2_costs
from repro_torch.core.tableau import TableauSpec, build_tableau
from repro_torch.kernels import hyperbox_cuda, ops, revised_cuda, simplex_cuda

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _same(x: torch.Tensor, y: torch.Tensor) -> bool:
    return torch.equal(_bits(x) if x.is_floating_point() else x,
                       _bits(y) if y.is_floating_point() else y)


def _run_both(batch, spec, rule, seed, cap):
    tab, basis, phase = build_tableau(batch.a, batch.b, batch.c, spec=spec)
    c_ext = phase2_costs(batch.c, spec)
    feas = engine.phase1_feasibility_tol(batch.b).contiguous()
    tol = engine.default_tolerance(tab.dtype)
    states = [(tab.clone(), basis.clone(), phase.clone()) for _ in range(2)]
    outs = []
    for fn, (t, b, p) in zip((simplex_cuda.simplex, simplex_cuda.simplex_plain), states):
        outs.append(fn(t, b, p, c_ext, feas, cap, spec=spec, rule=rule, seed=seed, tol=tol))
    torch.cuda.synchronize()
    return outs, states


@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible,layout", [(28, 28, True, "compact"),
                                                 (40, 20, False, "dense")])
def test_simplex_kernel_bit_identical_to_plain(rule, dtype, m, n, feasible, layout):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(m), 64, m, n, feasible, dtype=dtype)
    spec = TableauSpec(m, n, layout)
    before = simplex_cuda.launches
    (kern, plain), (sk, sp) = _run_both(batch, spec, rule, 7, 50 * (m + n))
    assert simplex_cuda.launches == before + 1
    for k, p in zip(kern + sk, plain + sp):
        assert torch.equal(_bits(k) if k.is_floating_point() else k,
                           _bits(p) if p.is_floating_point() else p)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 5, 28, 100])
def test_hyperbox_kernel_matches_plain(dtype, n):
    _need_card()
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(n), 10007, n, dtype=dtype)
    before = hyperbox_cuda.launches
    for box in ((lo, hi), (lo[0].contiguous(), hi[0].contiguous())):
        got = hyperbox_cuda.hyperbox(*box, d)
        ref = hyperbox_cuda.hyperbox_plain(*box, d)
        scale = (d * torch.where(d < 0, box[0], box[1])).abs().sum(dim=-1)
        rtol = 1e-6 if dtype == np.float32 else 1e-12
        assert bool(((got - ref).abs() <= rtol * scale).all())
    assert hyperbox_cuda.launches == before + 2


def test_main_path_goes_through_the_kernels():
    _need_card()
    rng = np.random.default_rng(0)
    batch = tlp.random_lp_batch(rng, 256, 30, 30)
    simplex_cuda.launches = hyperbox_cuda.launches = 0
    sol = repro_torch.solve(repro_torch.LPProblem.make(batch.c, batch.a, bu=batch.b))
    lo, hi, d = tlp.random_hyperbox_batch(rng, 1000, 5)
    box = repro_torch.solve(repro_torch.LPProblem.make(d, lo=lo, hi=hi))
    torch.cuda.synchronize()
    assert simplex_cuda.launches == 1 and hyperbox_cuda.launches == 1
    plain = repro_torch.solve(batch, repro_torch.SolveOptions(backend="torch"))
    assert torch.equal(sol.status, plain.status)
    assert torch.equal(sol.iterations, plain.iterations)
    assert (box.status == tlp.OPTIMAL).all()


def _revised_both(sb, rule, seed, basis0=None, cap=None):
    m, n = sb.a.shape
    state = revised.init_traced(sb.a, sb.b, basis0)
    feas = engine.phase1_feasibility_tol(sb.b).contiguous()
    tol = engine.default_tolerance(sb.a.dtype)
    cap = cap or 50 * (m + n)
    bufs = [[t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]
            for _ in range(2)]
    outs = [fn(sb.a, sb.b, sb.c, *buf, feas, cap, rule=rule, seed=seed, tol=tol)
            for fn, buf in zip((revised_cuda.revised, revised_cuda.revised_plain), bufs)]
    torch.cuda.synchronize()
    return outs, bufs


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible", [(28, 28, True), (40, 20, False)])
def test_revised_kernel_bit_identical_to_plain(rule, dtype, m, n, feasible, warm):
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(m), 64, m, n, feasible, dtype=dtype)
    basis0 = None
    if warm:
        basis0 = revised.solve_batched(sb.a, sb.b, sb.c, rule=rule, seed=7).basis.clone()
        basis0[:3, 1] = basis0[:3, 0]  # singular: these rows start cold
    before = revised_cuda.launches
    (kern, plain), (bk, bp) = _revised_both(sb, rule, 7, basis0)
    assert revised_cuda.launches == before + 1
    for k, p in zip(list(kern) + bk, list(plain) + bp):
        assert _same(k, p)


def test_revised_resume_chain_bit_identical():
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(3), 64, 40, 20, False)
    full, full_state = ops.revised_solve(sb.a, sb.b, sb.c, max_iters=200, want_state=True)
    part, state = ops.revised_solve(sb.a, sb.b, sb.c, max_iters=25, want_state=True)
    rest, rest_state = ops.revised_resume(sb.a, sb.b, sb.c, state, max_iters=175)
    plain = revised.solve_batched(sb.a, sb.b, sb.c, max_iters=200)
    for f in ("objective", "x", "status", "basis"):
        assert _same(getattr(rest, f), getattr(full, f))
        assert _same(getattr(plain, f), getattr(full, f))
    assert torch.equal(part.iterations + rest.iterations, full.iterations)
    for f in ("binv", "basis", "xb", "phase"):
        assert _same(getattr(rest_state, f), getattr(full_state, f))


@pytest.mark.parametrize("warm", [True, False])
def test_revised_sweep_matches_plain(warm):
    _need_card()
    from repro_torch.core import reach, support

    model = reach.helicopter_model()
    stack = reach.direction_stack(model, 0.02, 12).astype(np.float32)
    sb, c_stack = support.box_to_polytope(model.x0).shared_sweep_inputs(stack)
    before = revised_cuda.launches
    got = ops.revised_sweep(sb.a, sb.b, c_stack, warm=warm)
    assert revised_cuda.launches == before + 12
    want = revised.sweep_batched(sb.a, sb.b, c_stack, warm=warm)
    for g, w in zip(got, want):
        assert _same(g, w)


def test_shared_batch_default_options_launch_the_revised_kernel():
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(5), 256, 30, 20, True)
    revised_cuda.launches = simplex_cuda.launches = 0
    sol = repro_torch.solve(sb)
    torch.cuda.synchronize()
    assert revised_cuda.launches == 1 and simplex_cuda.launches == 0
    plain = repro_torch.solve(sb, repro_torch.SolveOptions(backend="torch"))
    for f in ("objective", "x", "status", "iterations", "basis"):
        assert _same(getattr(sol, f), getattr(plain, f))
