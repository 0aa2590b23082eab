"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is
present and skips without one, so every worker collects the same tests.
Run them on a machine with an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The simplex and revised kernels must be bit-identical to their plain
versions in every output and in the terminal state; the hyperbox kernel
agrees to rtol 1e-6 (float32) or 1e-12 (float64) relative to the sum of
|terms|.  The PDHG kernel agrees with its plain version in status and
step count per LP, and in the state within the tolerances of
``tests/test_torch_pdhg.py``; against itself (reruns, resume chains) it
is bit-identical.
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
from repro_torch.kernels import hyperbox_cuda, ops, pdhg_cuda, revised_cuda, simplex_cuda

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


# ---------------------------------------------------------------------------
# the PDHG kernel
# ---------------------------------------------------------------------------

PDHG_XTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
PDHG_STATE_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
PDHG_FIELDS = ("x", "y", "ax", "x_sum", "y_sum", "ax_sum", "inner", "x_grow", "y_grow")


def _pdhg_both(batch, cap):
    from repro_torch.core import pdhg

    a, b, c = batch.a, batch.b, batch.c
    bsz, m, n = a.shape
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    states = [pdhg.init_state(bsz, m, n, a.dtype, a.device) for _ in range(2)]
    outs = [fn(a, b, c, st, tau, sigma, scales, cap, tol=1e-4, restart=64)
            for fn, st in zip((pdhg_cuda.pdhg, pdhg_cuda.pdhg_plain), states)]
    torch.cuda.synchronize()
    return outs, states


def _pdhg_states_close(ks, ps, dtype):
    for f in PDHG_FIELDS:
        k, p = getattr(ks, f), getattr(ps, f)
        if f == "inner":
            assert torch.equal(k, p)
            continue
        tol = PDHG_XTOL[dtype] if f in ("x", "y") else \
            PDHG_STATE_RTOL[dtype] * max(1.0, float(p.abs().max()))
        assert float((k - p).abs().max()) <= tol, f


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible", [(60, 40, True), (40, 20, False), (12, 6, True)])
def test_pdhg_kernel_matches_plain_at_cap_400(dtype, m, n, feasible):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(m + n), 64, m, n, feasible, dtype=dtype)
    before = pdhg_cuda.launches
    ((ks, ki), (ps, pi)), (kst, pst) = _pdhg_both(batch, 400)
    assert pdhg_cuda.launches == before + 1
    assert torch.equal(ks, ps) and torch.equal(ki, pi)
    _pdhg_states_close(kst, pst, batch.a.dtype)


def test_pdhg_kernel_resume_chain_and_reruns_are_bit_identical():
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(9), 64, 60, 40, dtype=np.float32)
    a, b, c = batch.a, batch.b, batch.c
    full, full_state = ops.pdhg_solve(a, b, c, max_iters=400, want_state=True)
    again, again_state = ops.pdhg_solve(a, b, c, max_iters=400, want_state=True)
    part, state = ops.pdhg_solve(a, b, c, max_iters=150, want_state=True)
    rest, rest_state = ops.pdhg_resume(a, b, c, state, max_iters=250)
    for f in ("objective", "x", "y", "status", "iterations"):
        assert _same(getattr(again, f), getattr(full, f))
    for f in ("objective", "x", "y", "status"):
        assert _same(getattr(rest, f), getattr(full, f))
    assert torch.equal(part.iterations + rest.iterations, full.iterations)
    for f in PDHG_FIELDS:
        assert _same(getattr(again_state, f), getattr(full_state, f))
        assert _same(getattr(rest_state, f), getattr(full_state, f))


def test_pdhg_wrapper_raises_on_bad_buffers():
    _need_card()
    import dataclasses

    from repro_torch.core import pdhg

    batch = tlp.random_lp_batch(np.random.default_rng(1), 8, 12, 6)
    a, b, c = batch.a, batch.b, batch.c
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    state = pdhg.init_state(8, 12, 6, a.dtype, a.device)
    bad = dataclasses.replace(state, y=torch.zeros(12, 8, device=a.device).t())
    with pytest.raises(ValueError, match="not contiguous"):
        pdhg_cuda.pdhg(a, b, c, bad, tau, sigma, scales, 10, tol=1e-4, restart=64)
    cpu = dataclasses.replace(state, x=state.x.cpu())
    with pytest.raises(ValueError, match="cpu"):
        pdhg_cuda.pdhg(a, b, c, cpu, tau, sigma, scales, 10, tol=1e-4, restart=64)
    with pytest.raises(TypeError):
        pdhg_cuda.pdhg(a.half(), b, c, state, tau, sigma, scales, 10, tol=1e-4, restart=64)


def test_auto_at_500_launches_pdhg_once():
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(500), 8, 500, 500)
    pdhg_cuda.launches = simplex_cuda.launches = 0
    opts = repro_torch.SolveOptions(backend="auto", max_iters=2000)
    sol = repro_torch.solve(batch, opts)
    torch.cuda.synchronize()
    assert pdhg_cuda.launches == 1 and simplex_cuda.launches == 0
    assert sol.y is not None and tuple(sol.y.shape) == (8, 500)
    plain = repro_torch.solve(tlp.LPBatch(batch.a.cpu(), batch.b.cpu(), batch.c.cpu()),
                              repro_torch.SolveOptions(backend="pdhg", max_iters=2000))
    assert torch.equal(sol.status.cpu(), plain.status)


def test_pdhg_certificates_on_the_card():
    # tests/test_pdhg.py's construction: rows 0 and 1 unbounded.
    _need_card()
    rng = np.random.default_rng(3)
    m = n = 100
    a = rng.standard_normal((4, m, n)).astype(np.float32)
    b = (np.abs(rng.standard_normal((4, m))) + 0.5).astype(np.float32)
    c = rng.standard_normal((4, n)).astype(np.float32)
    for i in (0, 1):
        d = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        a[i] -= np.outer(a[i] @ d + 0.1, d / (d @ d))
        c[i] = np.abs(c[i])
    sol = repro_torch.solve(tlp.LPBatch.from_numpy(a, b, c),
                            repro_torch.SolveOptions(backend="pdhg", max_iters=20000))
    assert sol.status[:2].tolist() == [tlp.UNBOUNDED, tlp.UNBOUNDED]


@pytest.mark.parametrize("tile", [8, None])  # the reference's tile and the port's default
def test_crossover_polishes_a_row_alone_as_in_the_batch_on_the_card(tile):
    _need_card()
    from repro_torch.core import pdhg

    tile = tile or pdhg.CROSSOVER_TILE
    batch = tlp.random_lp_batch(np.random.default_rng(4), 80, 60, 40, dtype=np.float64)
    sol = ops.pdhg_solve(batch.a, batch.b, batch.c)
    before = simplex_cuda.launches
    whole = pdhg.crossover(batch, sol, tile=tile)
    n_opt = int((sol.status == tlp.OPTIMAL).sum())
    assert simplex_cuda.launches == before + -(-n_opt // tile)  # one a tile
    rows = (sol.status == tlp.OPTIMAL).nonzero().flatten()[:4].tolist()
    assert rows
    for r in rows:
        one_sol = tlp.LPSolution(objective=sol.objective[r:r + 1], x=sol.x[r:r + 1],
                                 status=sol.status[r:r + 1],
                                 iterations=sol.iterations[r:r + 1], y=sol.y[r:r + 1])
        one = pdhg.crossover(batch.take(slice(r, r + 1)), one_sol, tile=tile)
        for f in ("objective", "x", "iterations", "basis"):
            assert _same(getattr(one, f)[0], getattr(whole, f)[r]), (r, f)


def test_pdhg_plain_graph_replay_equals_the_eager_loop():
    _need_card()
    from repro_torch.core import pdhg

    batch = tlp.random_lp_batch(np.random.default_rng(6), 32, 30, 20)
    a, b, c = batch.a, batch.b, batch.c
    tau, sigma, scales = pdhg.step_sizes(a, b, c)

    def step(*loop):
        return pdhg.pdhg_step(a, b, c, *loop, tau, sigma, scales, tol=1e-4, restart=64)

    def start():
        st = pdhg.init_state(32, 30, 20, a.dtype, a.device)
        return (*(getattr(st, f) for f in PDHG_FIELDS),
                torch.zeros(32, dtype=torch.int32, device=a.device),
                torch.zeros(32, dtype=torch.int32, device=a.device))

    for cap in (300, 5000):  # stopped by the cap; run until every row stops
        graphed = pdhg._replay_loop(step, start(), cap)
        eager = pdhg._eager_loop(step, start(), cap)
        for g, e in zip(graphed, eager):
            assert _same(g, e)
