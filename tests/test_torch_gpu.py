"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is
present and skips without one, so every worker collects the same tests.
Run them on a machine with an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The simplex and revised kernels must be bit-identical to their plain
versions in every output and in the terminal state; the hyperbox kernel
agrees to rtol 1e-6 (float32) or 1e-12 (float64) relative to the sum of
|terms|, on offset views and on one box (row stride 0) too.  The PDHG
kernel agrees with its plain version in status and step count per LP,
and in the state within the tolerances of ``tests/test_torch_pdhg.py``;
against itself (reruns, resume chains) it is bit-identical.  The
simplex and PDHG kernels are also run at a forced cluster size (``_k``:
0 for the second variant, else the CTAs of the cluster variant) and
their shared-memory layouts held against ``kernels/cluster.py``; the
revised kernel and its one-launch sweep in both variants (``_variant``:
the resident default, or ``"global"``).
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 3, 5, 8, 28, 33, 100, 5000])
def test_hyperbox_kernel_on_offset_views_and_boxes(dtype, n):
    _need_card()
    bsz = 37 if n == 5000 else 3001  # not a multiple of a tile's rows
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(n + 1), bsz, n, dtype=dtype)

    def offset(t):  # the same values in a contiguous view one element past an aligned start
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    rtol = 1e-6 if dtype == np.float32 else 1e-12
    cases = [(lo, hi, d), (offset(lo), offset(hi), offset(d)),
             (lo[0].contiguous(), hi[0].contiguous(), d), (offset(lo[0]), hi[0:1], offset(d))]
    for case_lo, case_hi, case_d in cases:
        got = hyperbox_cuda.hyperbox(case_lo, case_hi, case_d)
        ref = hyperbox_cuda.hyperbox_plain(case_lo, case_hi, case_d)
        scale = (case_d * torch.where(case_d < 0, case_lo, case_hi)).abs().sum(dim=-1)
        assert bool(((got - ref).abs() <= rtol * scale).all())


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


def _revised_both(sb, rule, seed, basis0=None, cap=None, variant=None):
    m, n = sb.a.shape
    state = revised.init_traced(sb.a, sb.b, basis0)
    feas = engine.phase1_feasibility_tol(sb.b).contiguous()
    tol = engine.default_tolerance(sb.a.dtype)
    cap = cap or 50 * (m + n)
    bufs = [[t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]
            for _ in range(2)]
    kw = dict(rule=rule, seed=seed, tol=tol)
    outs = [revised_cuda.revised(sb.a, sb.b, sb.c, *bufs[0], feas, cap, _variant=variant, **kw),
            revised_cuda.revised_plain(sb.a, sb.b, sb.c, *bufs[1], feas, cap, **kw)]
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
    before = revised_cuda.launches, revised_cuda.variant_launches["resident"]
    (kern, plain), (bk, bp) = _revised_both(sb, rule, 7, basis0)
    assert (revised_cuda.launches, revised_cuda.variant_launches["resident"]) == \
        (before[0] + 1, before[1] + 1)
    for k, p in zip(list(kern) + bk, list(plain) + bp):
        assert _same(k, p)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible", [(28, 28, True), (40, 20, False)])
def test_revised_global_variant_bit_identical_to_plain(rule, dtype, m, n, feasible, warm):
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(m), 64, m, n, feasible, dtype=dtype)
    basis0 = None
    if warm:
        basis0 = revised.solve_batched(sb.a, sb.b, sb.c, rule=rule, seed=7).basis.clone()
        basis0[:3, 1] = basis0[:3, 0]  # singular: these rows start cold
    before = revised_cuda.variant_launches["global"]
    (kern, plain), (bk, bp) = _revised_both(sb, rule, 7, basis0, variant="global")
    assert revised_cuda.variant_launches["global"] == before + 1
    for k, p in zip(list(kern) + bk, list(plain) + bp):
        assert _same(k, p)


@pytest.mark.parametrize("m,n,dtype", [(300, 100, np.float32), (200, 60, np.float64)])
def test_revised_past_the_resident_limit_takes_the_global_variant(m, n, dtype):
    _need_card()
    import ctypes

    from repro_torch.kernels import build, cluster

    sb = tlp.random_shared_lp_batch(np.random.default_rng(m), 8, m, n, False, dtype=dtype)
    assert cluster.plan_revised(m, n, sb.a.dtype).variant == "global"
    before = revised_cuda.variant_launches["global"]
    (kern, plain), (bk, bp) = _revised_both(sb, "lpc", 0, cap=80)
    assert revised_cuda.variant_launches["global"] == before + 1
    for k, p in zip(list(kern) + bk, list(plain) + bp):
        assert _same(k, p)
    with pytest.raises(ValueError, match="shared memory"):
        _revised_both(sb, "lpc", 0, cap=10, variant="resident")
    fn = build.load("revised").revised_resident_smem
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    for mm, nn in [(100, 100), (200, 100), (10, 10), (56, 56), (7, 3), (235, 100), (300, 100)]:
        for item in (4, 8):
            assert fn(mm, nn, item) == cluster.revised_smem(mm, nn, item), (mm, nn, item)


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


@pytest.mark.parametrize("m,n,dtype,feasible", [(200, 100, np.float32, False),
                                                (170, 99, np.float32, True),
                                                (120, 100, np.float64, True)])
def test_revised_staged_pricing_bit_identical_to_plain(m, n, dtype, feasible):
    # One resident CTA an SM: A is staged through shared memory for the pricing.
    _need_card()
    from repro_torch.kernels import cluster

    item = np.dtype(dtype).itemsize
    assert cluster.revised_stage_rows(m, n, item) > 0
    sb = tlp.random_shared_lp_batch(np.random.default_rng(m + n), 16, m, n, feasible,
                                    dtype=dtype)
    before = revised_cuda.variant_launches["resident"]
    (kern, plain), (bk, bp) = _revised_both(sb, "lpc", 0)
    assert revised_cuda.variant_launches["resident"] == before + 1
    for k, p in zip(list(kern) + bk, list(plain) + bp):
        assert _same(k, p)
    rng = np.random.default_rng(1)
    stack = sb.c.cpu().numpy()[None] + 0.3 * rng.normal(size=(3, 16, n))
    c_stack = torch.as_tensor(stack.astype(dtype), device=sb.a.device)
    got = ops.revised_sweep(sb.a, sb.b, c_stack)
    want = revised.sweep_batched(sb.a, sb.b, c_stack)
    for g, w in zip(got, want):
        assert _same(g, w)


def test_revised_resume_chain_bit_identical_across_variants():
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(3), 64, 40, 20, False)
    state = revised.init_traced(sb.a, sb.b, None)
    feas = engine.phase1_feasibility_tol(sb.b).contiguous()
    tol = engine.default_tolerance(sb.a.dtype)
    results = []
    for variant in ("resident", "global"):
        one = [t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]
        chain = [t.clone() for t in one]
        full = revised_cuda.revised(sb.a, sb.b, sb.c, *one, feas, 200, tol=tol, _variant=variant)
        part = revised_cuda.revised(sb.a, sb.b, sb.c, *chain, feas, 25, tol=tol,
                                    _variant=variant)
        rest = revised_cuda.revised(sb.a, sb.b, sb.c, *chain, feas, 175, tol=tol,
                                    _variant=variant)
        torch.cuda.synchronize()
        for got, want in zip(list(rest[:3]) + chain, list(full[:3]) + one):
            assert _same(got, want)
        assert torch.equal(part[3] + rest[3], full[3])
        results.append(list(full) + one)
    for r, g in zip(*results):
        assert _same(r, g)


@pytest.mark.parametrize("warm", [True, False])
def test_revised_sweep_matches_plain(warm):
    _need_card()
    from repro_torch.core import reach, support

    model = reach.helicopter_model()
    stack = reach.direction_stack(model, 0.02, 12).astype(np.float32)
    sb, c_stack = support.box_to_polytope(model.x0).shared_sweep_inputs(stack)
    before = revised_cuda.launches, revised_cuda.variant_launches["resident"]
    got = ops.revised_sweep(sb.a, sb.b, c_stack, warm=warm)
    assert (revised_cuda.launches, revised_cuda.variant_launches["resident"]) == \
        (before[0] + 1, before[1] + 1)
    want = revised.sweep_batched(sb.a, sb.b, c_stack, warm=warm)
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.parametrize("variant", ["resident", "global"])
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("rule,dtype", [("lpc", np.float64), ("rpc", np.float32),
                                        ("bland", np.float32)])
def test_revised_sweep_variants_bit_identical_to_plain(variant, warm, rule, dtype):
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(8), 48, 24, 12, False, dtype=dtype)
    rng = np.random.default_rng(9)
    stack = sb.c.cpu().numpy()[None] + 0.3 * rng.normal(size=(6, 48, 12))
    c_stack = torch.as_tensor(stack.astype(dtype), device=sb.a.device)
    feas = engine.phase1_feasibility_tol(sb.b).contiguous()
    tol = engine.default_tolerance(sb.a.dtype)
    kw = dict(rule=rule, seed=5, tol=tol, warm=warm)
    before = revised_cuda.variant_launches[variant]
    got = revised_cuda.revised_sweep(sb.a, sb.b, c_stack, feas, 300, _variant=variant, **kw)
    assert revised_cuda.variant_launches[variant] == before + 1
    want = revised_cuda.revised_sweep_plain(sb.a, sb.b, c_stack, feas, 300, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same(g, w)
    assert int(got[2].eq(tlp.OPTIMAL).sum()) > 0


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


# ---------------------------------------------------------------------------
# the cluster variants at a forced cluster size, and the second variants
# ---------------------------------------------------------------------------


def _simplex_at_k(batch, spec, rule, cap, k):
    """The kernel at a forced ``k`` (0: the global variant) and the plain version."""
    tab, basis, phase = build_tableau(batch.a, batch.b, batch.c, spec=spec)
    c_ext = phase2_costs(batch.c, spec)
    feas = engine.phase1_feasibility_tol(batch.b).contiguous()
    tol = engine.default_tolerance(tab.dtype)
    kw = dict(spec=spec, rule=rule, seed=7, tol=tol)
    ks = (tab.clone(), basis.clone(), phase.clone())
    ps = (tab.clone(), basis.clone(), phase.clone())
    kern = simplex_cuda.simplex(*ks, c_ext, feas, cap, _k=k, **kw)
    plain = simplex_cuda.simplex_plain(*ps, c_ext, feas, cap, **kw)
    torch.cuda.synchronize()
    return list(kern) + list(ks), list(plain) + list(ps)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible,layout", [(60, 60, True, "compact"),
                                                 (24, 12, False, "dense")])
def test_simplex_variants_bit_identical_to_plain_at_forced_k(k, rule, dtype, m, n, feasible,
                                                             layout):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(m + k), 64, m, n, feasible, dtype=dtype)
    spec = TableauSpec(m, n, layout)
    variant = "cluster" if k else "global"
    before = simplex_cuda.variant_launches[variant]
    kern, plain = _simplex_at_k(batch, spec, rule, 50 * (m + n), k)
    assert simplex_cuda.variant_launches[variant] == before + 1
    for got, want in zip(kern, plain):
        assert _same(got, want)


@pytest.mark.parametrize("k", [2, 3])
def test_simplex_cluster_resume_chain_bit_identical(k):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(11), 64, 40, 20, False)
    spec = TableauSpec(40, 20, "dense")
    tab, basis, phase = build_tableau(batch.a, batch.b, batch.c, spec=spec)
    c_ext = phase2_costs(batch.c, spec)
    feas = engine.phase1_feasibility_tol(batch.b).contiguous()
    kw = dict(spec=spec, tol=engine.default_tolerance(tab.dtype), _k=k)
    one = (tab.clone(), basis.clone(), phase.clone())
    chain = (tab.clone(), basis.clone(), phase.clone())
    full = simplex_cuda.simplex(*one, c_ext, feas, 200, **kw)
    part = simplex_cuda.simplex(*chain, c_ext, feas, 25, **kw)
    rest = simplex_cuda.simplex(*chain, c_ext, feas, 175, **kw)
    torch.cuda.synchronize()
    for got, want in zip(list(rest[:3]) + list(chain), list(full[:3]) + list(one)):
        assert _same(got, want)
    assert torch.equal(part[3] + rest[3], full[3])


def _pdhg_at_k(batch, cap, k, state=None):
    from repro_torch.core import pdhg

    a, b, c = batch.a, batch.b, batch.c
    bsz, m, n = a.shape
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    state = state or pdhg.init_state(bsz, m, n, a.dtype, a.device)
    out = pdhg_cuda.pdhg(a, b, c, state, tau, sigma, scales, cap, tol=1e-4, restart=64, _k=k)
    return out, state


@pytest.mark.parametrize("k", [0, 2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible", [(60, 40, True), (40, 20, False)])
def test_pdhg_variants_match_plain_at_cap_400_at_forced_k(k, dtype, m, n, feasible):
    _need_card()
    from repro_torch.core import pdhg

    batch = tlp.random_lp_batch(np.random.default_rng(m + n), 64, m, n, feasible, dtype=dtype)
    variant = "cluster" if k else "streaming"
    before = pdhg_cuda.variant_launches[variant]
    (ks, ki), kst = _pdhg_at_k(batch, 400, k)
    assert pdhg_cuda.variant_launches[variant] == before + 1
    a, b, c = batch.a, batch.b, batch.c
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    pst = pdhg.init_state(64, m, n, a.dtype, a.device)
    ps, pi = pdhg_cuda.pdhg_plain(a, b, c, pst, tau, sigma, scales, 400, tol=1e-4, restart=64)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps) and torch.equal(ki, pi)
    _pdhg_states_close(kst, pst, a.dtype)


@pytest.mark.parametrize("k", [2, 4])
def test_pdhg_cluster_resume_chain_and_rerun_bit_identical_at_forced_k(k):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(9), 64, 60, 40, dtype=np.float32)
    (fs, fi), full = _pdhg_at_k(batch, 400, k)
    (gs, gi), again = _pdhg_at_k(batch, 400, k)
    (_, pi), chain = _pdhg_at_k(batch, 150, k)
    (rs, ri), chain = _pdhg_at_k(batch, 250, k, state=chain)
    torch.cuda.synchronize()
    assert torch.equal(gs, fs) and torch.equal(gi, fi)
    assert torch.equal(rs, fs) and torch.equal(pi + ri, fi)
    for f in PDHG_FIELDS:
        assert _same(getattr(again, f), getattr(full, f))
        assert _same(getattr(chain, f), getattr(full, f))


def test_cluster_layouts_match_the_kernels():
    _need_card()
    import ctypes

    from repro_torch.kernels import build, cluster

    for lib_name, fn_name, py in [("simplex", "simplex_cluster_smem", cluster.simplex_smem),
                                  ("pdhg", "pdhg_cluster_smem", cluster.pdhg_smem)]:
        fn = getattr(build.load(lib_name), fn_name)
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int] * 4
        for m, w in [(100, 201), (200, 301), (500, 1001), (500, 500), (24, 49), (7, 3)]:
            for item in (4, 8):
                for k in (1, 2, 3, 5, 10, 16):
                    assert fn(m, w, k, item) == py(m, w, item, k), (lib_name, m, w, item, k)


def test_main_path_shapes_take_the_cluster_variant_on_the_card():
    _need_card()
    dev = torch.device("cuda")
    f32 = torch.float32
    assert simplex_cuda.device_max_k(f32, dev) == 16
    assert pdhg_cuda.device_max_k(f32, dev) == 16
    assert simplex_cuda.plan(TableauSpec(100, 100), f32, dev).k == 1
    assert simplex_cuda.plan(TableauSpec(200, 100), f32, dev).k == 2
    assert simplex_cuda.plan(TableauSpec(500, 500), f32, dev).k == 10
    assert simplex_cuda.plan(TableauSpec(700, 700), f32, dev).variant == "global"
    assert pdhg_cuda.plan(500, 500, f32, dev).k == 5
    assert pdhg_cuda.plan(1000, 1000, f32, dev).variant == "streaming"


def test_wrappers_raise_on_a_cluster_the_card_cannot_take():
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(2), 4, 500, 500)
    with pytest.raises(ValueError, match="shared memory"):
        _pdhg_at_k(batch, 10, 1)
    with pytest.raises(ValueError, match="outside"):
        _pdhg_at_k(batch, 10, 17)
    spec = TableauSpec(500, 500)
    with pytest.raises(ValueError, match="shared memory"):
        _simplex_at_k(batch, spec, "lpc", 10, 2)


# ---------------------------------------------------------------------------
# compaction rounds on the card: every round a kernel launch
# ---------------------------------------------------------------------------


def _rounds_bit_equal(batch, backend, counter, fields, **kw):
    base = repro_torch.SolveOptions(backend=backend, **kw)
    off = repro_torch.solve(batch, base)
    for mode, resume in (("every_k", "basis"), ("chunked", "scratch"), ("every_k", "scratch")):
        before = counter.launches
        stats = repro_torch.SolveStats()
        sol = repro_torch.solve(batch, base.replace(compaction=mode, resume=resume,
                                                    compact_every=16), stats=stats)
        torch.cuda.synchronize()
        assert counter.launches - before == stats.rounds > 1, (mode, resume)
        for f in fields:
            assert _same(getattr(sol, f), getattr(off, f)), (mode, resume, f)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compaction_rounds_on_the_simplex_kernel(dtype):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(61), 96, 40, 20, False, dtype=dtype,
                                device="cuda")
    _rounds_bit_equal(batch, "cuda", simplex_cuda,
                      ("status", "iterations", "basis", "objective", "x"))


def test_compaction_rounds_on_the_revised_kernel():
    _need_card()
    sb = tlp.random_shared_lp_batch(np.random.default_rng(62), 96, 40, 20, False,
                                    device="cuda")
    _rounds_bit_equal(sb, "cuda-shared", revised_cuda,
                      ("status", "iterations", "basis", "objective", "x"))


def test_compaction_rounds_on_the_pdhg_kernel():
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(63), 32, 50, 50, True, device="cuda")
    base = repro_torch.SolveOptions(backend="pdhg", max_iters=400)
    off = repro_torch.solve(batch, base)
    before = pdhg_cuda.launches
    stats = repro_torch.SolveStats()
    sol = repro_torch.solve(batch, base.replace(compaction="every_k", compact_every=50,
                                                resume="basis"), stats=stats)
    torch.cuda.synchronize()
    assert pdhg_cuda.launches - before == stats.rounds > 1
    for f in ("status", "iterations", "x", "y"):
        assert _same(getattr(sol, f), getattr(off, f)), f


def test_a_poisoned_carried_row_retires_numerical_on_the_card():
    _need_card()
    from repro_torch.core import dispatch

    batch = tlp.random_lp_batch(np.random.default_rng(64), 64, 40, 20, False, device="cuda")
    off = repro_torch.solve(batch)
    row = int((off.iterations > 16).nonzero()[0])
    real = dispatch.dispatch_round

    def poisoning(b, options, stats=None, state=None, want_state=False):
        sol, out = real(b, options, stats, state=state, want_state=want_state)
        if out is not None and state is None:
            out.tab[row, 0, 0] = float("nan")
        return sol, out

    dispatch.dispatch_round = poisoning
    try:
        opts = repro_torch.SolveOptions(compaction="every_k", compact_every=16, resume="basis")
        sol = repro_torch.solve(batch, opts)
        fixed = repro_torch.solve(batch, opts.replace(quarantine=True))
    finally:
        dispatch.dispatch_round = real
    assert int(sol.status[row]) == tlp.NUMERICAL
    rest = torch.arange(batch.batch, device="cuda") != row
    for f in ("status", "iterations", "objective", "x"):
        assert _same(getattr(sol, f)[rest], getattr(off, f)[rest]), f
    assert int(fixed.status[row]) == int(off.status[row])


# ---------------------------------------------------------------------------
# slice 7: the serve loop, retries, speculation, row-local reductions
# ---------------------------------------------------------------------------


def test_row_local_reductions_do_not_depend_on_the_batch():
    """``row_sum`` and the tiled step sizes give a row the same bits in a batch
    of 2, 3 or 5 as in one of 300 (``Tensor.sum`` and ``einsum`` do not)."""
    _need_card()
    from repro_torch.core import pdhg
    from repro_torch.core.lp import row_sum

    gen = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn(300, 500, generator=gen).cuda()
    full = row_sum(v)
    a = torch.randn(300, 60, 50, generator=gen).cuda()
    b = torch.rand(300, 60, generator=gen).cuda() + 0.5
    c = torch.rand(300, 50, generator=gen).cuda()
    steps = pdhg.step_sizes(a, b, c)
    for k in (2, 3, 5):
        assert _same(row_sum(v[:k]), full[:k])
        part = pdhg.step_sizes(a[:k], b[:k], c[:k])
        assert _same(part[0], steps[0][:k]) and _same(part[1], steps[1][:k])
        for x, y in zip(part[2], steps[2]):
            assert _same(x, y[:k])


@pytest.mark.parametrize("name,opts,step_iters", [
    ("cuda", repro_torch.SolveOptions(), 16),
    ("pdhg", repro_torch.SolveOptions(backend="auto", route_frontier=40, max_iters=300), 70),
    ("pdhg-crossover", repro_torch.SolveOptions(backend="auto", route_frontier=40,
                                                max_iters=300, crossover=True), 70),
])
def test_continuous_serve_bit_identical_to_oneshot_on_the_card(name, opts, step_iters):
    _need_card()
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import lp_request_mix

    make = lp_request_mix([(28, 28), (40, 40)], seed=11, device="cpu")
    problems = [make(i) for i in range(40)]
    oneshot = repro_torch.SolveSession(opts, device="cuda").solve(problems)
    eng = LPEngine(opts, flush_every=1 << 30, step_iters=step_iters, device="cuda")
    before = (simplex_cuda.launches, pdhg_cuda.launches)
    tickets, done = [], {}
    for i in range(0, len(problems), 3):  # three arrivals a round: waves splice
        tickets += [eng.submit(p) for p in problems[i:i + 3]]
        for t in eng.step():
            done[t] = eng.result(t)
    while len(done) < len(problems):
        for t in eng.step():
            done[t] = eng.result(t)
    for o, t in zip(oneshot, tickets):
        for f in ("objective", "x", "status", "iterations"):
            assert _same(getattr(o, f), getattr(done[t], f)), f
    assert eng.stats.spliced > 0 and eng.stats.retries == 0 and eng.dead_letters == []
    launched = (simplex_cuda.launches - before[0], pdhg_cuda.launches - before[1])
    assert launched[1] > 0 if name.startswith("pdhg") else launched[0] > 0


def test_speculative_chunks_on_streams_bit_identical_on_the_card():
    _need_card()
    from repro_torch.core import dispatch

    batch = tlp.random_lp_batch(np.random.default_rng(5), 4000, 28, 28)
    opts = repro_torch.SolveOptions(chunk_size=500)
    ref = dispatch.solve_canonical(batch, opts)
    for _ in range(2):
        sol = dispatch.solve_canonical(batch, opts.replace(speculation=True))
        for f in ("objective", "x", "status", "iterations", "basis"):
            assert _same(getattr(ref, f), getattr(sol, f)), f


def test_retry_and_poison_on_the_card():
    _need_card()
    from repro_torch.core import dispatch
    from repro_torch.runtime import chaos

    batch = tlp.random_lp_batch(np.random.default_rng(6), 256, 28, 28)
    opts = repro_torch.SolveOptions(compaction="every_k", compact_every=8, resume="basis",
                                    chunk_size=64, retry_backoff=0.0)
    ref = dispatch.solve_canonical(batch, opts)
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=(0,), crash_rounds=(2,), max_faults=2)):
        sol = dispatch.solve_canonical(batch, opts, stats=stats)
    assert stats.retries == 2 and stats.faults_injected == 2
    for f in ("objective", "x", "status", "iterations", "basis"):
        assert _same(getattr(ref, f), getattr(sol, f)), f
    with chaos.inject(chaos.ChaosMonkey(poison_rows={0: (3,)})):
        bad = dispatch.solve_canonical(batch, opts)
    rest = torch.arange(256, device="cuda") != 3
    assert int(bad.status[3]) == tlp.NUMERICAL
    assert _same(bad.objective[rest], ref.objective[rest])


def test_a_kernel_that_does_not_build_leaves_the_serve_loop(monkeypatch, tmp_path):
    """A source that fails ``nvcc`` raises ``KernelBuildError`` out of
    ``LPEngine.step`` and ``repro_torch.solve``: no retry, no dead letter."""
    _need_card()
    from repro_torch.kernels import build
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import lp_request_mix

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "simplex.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    make = lp_request_mix([(28, 28)], seed=1, device="cpu")
    eng = LPEngine(repro_torch.SolveOptions(retry_backoff=0.0), flush_every=1 << 30,
                   device="cuda")
    eng.submit(make(0))
    with pytest.raises(build.KernelBuildError):
        eng.step()
    assert eng.stats.retries == 0 and eng.dead_letters == []
    stats = repro_torch.SolveStats()
    with pytest.raises(build.KernelBuildError):
        repro_torch.solve(tlp.random_lp_batch(np.random.default_rng(1), 4, 28, 28), stats=stats)
    assert stats.retries == 0


# ---------------------------------------------------------------------------
# the cost-model autotuner and the row-local A lo product (slice 8)
# ---------------------------------------------------------------------------

#: The main path's shape classes: (m, n, shared).
AUTOTUNE_CLASSES = [(5, 5, False), (28, 28, False), (100, 100, False), (200, 100, False),
                    (100, 100, True), (200, 100, True), (500, 500, False)]


@pytest.fixture
def card_tuner(tmp_path, monkeypatch):
    """A private tuner whose cache file lives in ``tmp_path``."""
    from repro_torch.runtime import autotune

    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    yield autotune.reset(cache_path=path)
    autotune._TUNER = None


@pytest.mark.parametrize("m,n,shared", AUTOTUNE_CLASSES)
def test_predict_equals_the_static_table_on_the_card(m, n, shared, card_tuner):
    _need_card()
    from repro_torch.core import dispatch

    for dtype in (torch.float32, torch.float64):
        for backend in ("auto", "cuda", "torch"):
            opts = repro_torch.SolveOptions(backend=backend)
            kw = dict(dtype=dtype, batch=4096, device="cuda")
            tuned = dispatch.resolve_backend(opts, shared, (m, n), **kw)
            static = dispatch.resolve_backend(opts.replace(autotune="off"), shared, (m, n), **kw)
            assert tuned.backend == static.backend
            assert tuned.effective_layout == static.effective_layout
    assert card_tuner.trials_run == 0


def test_trial_resolution_bit_equal_to_off_on_the_card(card_tuner):
    _need_card()
    from repro_torch.runtime import autotune

    rng = np.random.default_rng(0)
    dense = tlp.random_lp_batch(rng, 512, 100, 100)
    shared = tlp.random_shared_lp_batch(rng, 512, 28, 28)  # the plain revised loop is slow
    for batch in (dense, shared):
        for backend in ("auto", "cuda"):
            opts = repro_torch.SolveOptions(backend=backend, autotune="trial")
            stats = repro_torch.SolveStats()
            tuned = repro_torch.solve(batch, opts, stats=stats)
            static = repro_torch.solve(batch, opts.replace(autotune="off"))
            for f in ("objective", "x", "status", "iterations", "basis"):
                assert _same(getattr(tuned, f), getattr(static, f)), f
            assert stats.autotuned == 1 and stats.lps == 512
    trials = card_tuner.trials_run
    assert trials > 0
    fresh = autotune.reset(cache_path=card_tuner.cache.path)  # a new process: the file
    stats = repro_torch.SolveStats()
    repro_torch.solve(dense, repro_torch.SolveOptions(backend="auto", autotune="trial"),
                      stats=stats)
    assert fresh.trials_run == 0 and stats.autotune_log[0]["source"] == "cache"


def test_a_kernel_build_error_in_a_trial_leaves_resolve(monkeypatch, card_tuner):
    _need_card()
    import os

    from repro_torch.kernels import build
    from repro_torch.runtime import autotune

    def broken(name):
        raise build.KernelBuildError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(build, "compile_source", broken)
    monkeypatch.setattr(build, "_LIBS", {})
    opts = repro_torch.SolveOptions(backend="auto", autotune="trial")
    with pytest.raises(build.KernelBuildError):
        autotune.resolve(28, 28, torch.float32, opts, batch=64, device="cuda")
    assert not os.path.exists(card_tuner.cache.path)  # nothing ranked, nothing cached


def _lower_bounded_raw(rng, bsz, m, n):
    a = rng.uniform(-1.0, 1.0, (bsz, m, n))
    b = rng.uniform(1.0, 10.0, (bsz, m))
    c = rng.uniform(0.1, 1.0, (bsz, n))
    lo = rng.uniform(-0.3, 0.3, (bsz, n))
    return a, b, c, lo


def test_a_lo_product_is_row_local_on_the_card():
    """``canonicalize``'s ``A lo`` gives a row the same bits alone, in a few
    rows, and in a batch of 2,048 (a batched ``einsum`` does not)."""
    _need_card()
    from repro_torch.core.problem import LPProblem, canonicalize

    a, b, c, lo = _lower_bounded_raw(np.random.default_rng(3), 2048, 100, 100)

    def canon_b(rows):
        p = LPProblem.make(c[rows], a[rows], bu=b[rows], lo=lo[rows], dtype=np.float32,
                           device="cuda")
        return canonicalize(p).batch.b

    full = canon_b(slice(None))
    for rows in (slice(0, 1), slice(0, 2), slice(5, 8), slice(1000, 1016)):
        assert _same(canon_b(rows), full[rows])


def test_continuous_serve_with_lower_bounds_bit_identical_on_the_card():
    _need_card()
    from repro_torch.core.problem import LPProblem
    from repro_torch.serve.engine import LPEngine

    rng = np.random.default_rng(4)
    problems = []
    for i in range(40):
        a, b, c, lo = _lower_bounded_raw(rng, 1, *((28, 28) if i % 2 else (40, 40)))
        problems.append(LPProblem.make(c, a, bu=b, lo=lo, hi=lo + 5.0, dtype=np.float32,
                                       device="cpu"))
    opts = repro_torch.SolveOptions()
    oneshot = repro_torch.SolveSession(opts, device="cuda").solve(problems)
    eng = LPEngine(opts, flush_every=1 << 30, step_iters=4, device="cuda")
    tickets, done = [], {}
    for i in range(0, len(problems), 3):  # three arrivals a round: waves splice
        tickets += [eng.submit(p) for p in problems[i:i + 3]]
        for t in eng.step():
            done[t] = eng.result(t)
    while len(done) < len(problems):
        for t in eng.step():
            done[t] = eng.result(t)
    for o, t in zip(oneshot, tickets):
        for f in ("objective", "x", "status", "iterations"):
            assert _same(getattr(o, f), getattr(done[t], f)), f
    assert eng.stats.spliced > 0 and eng.dead_letters == []


# ---------------------------------------------------------------------------
# The LM serve path (no kernel of the port: plain PyTorch on the card)
# ---------------------------------------------------------------------------


def _lm_close(got, want, rtol=1e-5, atol=2e-5):
    """The LM parity tolerance of tests/test_torch_models.py."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    assert err <= atol * scale and rel <= rtol, (err, rel)


def _lm_pair(arch="gemma2-2b", seed=6):
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights

    cfg = configs.get_config(arch, reduced=True)
    tree = reference_weights(cfg, seed)
    card = load_reference_params(Model(cfg), tree)  # the card by default
    host = load_reference_params(Model(cfg, device="cpu"), tree)
    toks = configs.make_inputs(cfg, configs.Shape("t", 24, 2, "prefill"), 1, device="cpu")
    return card, host, toks["tokens"]


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-4b"])
def test_lm_reduced_on_the_card_matches_the_cpu(arch):
    _need_card()
    card, host, toks = _lm_pair(arch)
    assert card.device.type == "cuda"
    with torch.inference_mode():
        _lm_close(card.logits(card.forward({"tokens": toks.cuda()})),
                  host.logits(host.forward({"tokens": toks})))
    cc, hc = card.init_cache(2, 24), host.init_cache(2, 24)
    _lm_close(card.prefill({"tokens": toks[:, :16].cuda()}, cc)[0],
              host.prefill({"tokens": toks[:, :16]}, hc)[0])
    for t in range(16, 24):
        _lm_close(card.decode_step({"tokens": toks[:, t:t + 1].cuda()}, cc, t)[0],
                  host.decode_step({"tokens": toks[:, t:t + 1]}, hc, t)[0])


def test_lm_engine_on_the_card_by_default():
    _need_card()
    from repro_torch.serve.engine import Engine

    card, host, toks = _lm_pair()
    engine = Engine(card, max_len=34)
    assert engine.device.type == "cuda"
    out = engine.generate({"tokens": toks}, steps=10)
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert all(c["k"].device.type == "cuda" for c in engine.cache)
    ref = Engine(host, max_len=34, device="cpu").generate({"tokens": toks}, steps=10)
    # greedy picks agree until the first undecided one (random weights give
    # near-uniform logits; see tests/test_torch_lm_serve.py)
    agree = (out.cpu() == ref).int().cumprod(dim=1).sum(dim=1)
    assert int(agree.min()) >= 1
    sampled = engine.generate({"tokens": toks}, steps=10, temperature=1.0, seed=3)
    assert torch.equal(sampled, engine.generate({"tokens": toks}, steps=10, temperature=1.0,
                                                seed=3))


# ---------------------------------------------------------------------------
# The MoE path: the LP router's LPs on the simplex kernel
# ---------------------------------------------------------------------------


def _moe_pair(arch, router="lp", seed=6):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights

    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), router=router)
    tree = reference_weights(cfg, seed)
    card = load_reference_params(Model(cfg), tree)
    host = load_reference_params(Model(cfg, device="cpu"), tree)
    toks = configs.make_inputs(cfg, configs.Shape("t", 24, 2, "prefill"), 1, device="cpu")
    return card, host, toks["tokens"]


class _Captured:
    """``simplex_cuda.simplex`` wrapped: each call's inputs (cloned before
    the launch) and outputs, with the terminal basis."""

    def __init__(self, monkeypatch):
        self.records = []
        orig = simplex_cuda.simplex

        def spy(tab, basis, phase, c_ext, feas, cap, **kw):
            inputs = [t.clone() for t in (tab, basis, phase, c_ext, feas)]
            out = orig(tab, basis, phase, c_ext, feas, cap, **kw)
            self.records.append((inputs, cap, kw, list(out) + [basis.clone()]))
            return out

        monkeypatch.setattr(simplex_cuda, "simplex", spy)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_lp_router_launches_the_simplex_kernel_per_layer_per_call(arch, monkeypatch):
    _need_card()
    card, host, toks = _moe_pair(arch)
    n_moe = sum(kind.endswith("_moe") for kind in card.kinds())
    cap = _Captured(monkeypatch)
    before = simplex_cuda.launches
    with torch.inference_mode():
        card.forward({"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert simplex_cuda.launches - before == n_moe == len(cap.records)
    cc = card.init_cache(2, 24)
    card.prefill({"tokens": toks[:, :16].cuda()}, cc)
    for t in range(16, 24):
        card.decode_step({"tokens": toks[:, t:t + 1].cuda()}, cc, t)
    torch.cuda.synchronize()
    assert simplex_cuda.launches - before == 10 * n_moe == len(cap.records)
    assert all(r[0][0].is_cuda for r in cap.records)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_router_lps_on_the_card_bit_identical_to_plain(arch, monkeypatch):
    _need_card()
    card, _, toks = _moe_pair(arch)
    cap = _Captured(monkeypatch)
    cc = card.init_cache(2, 24)
    card.prefill({"tokens": toks[:, :16].cuda()}, cc)
    for t in range(16, 20):
        card.decode_step({"tokens": toks[:, t:t + 1].cuda()}, cc, t)
    assert cap.records
    for inputs, cap_iters, kw, out in cap.records:
        state = [t.clone() for t in inputs]
        plain = simplex_cuda.simplex_plain(*state, cap_iters, **kw)
        for a, b in zip(list(plain) + [state[1]], out):
            assert _same(a, b)


@pytest.mark.parametrize("router", ["topk", "lp"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_reduced_on_the_card_matches_the_cpu(arch, router):
    _need_card()
    card, host, toks = _moe_pair(arch, router)
    with torch.inference_mode():
        _lm_close(card.logits(card.forward({"tokens": toks.cuda()})),
                  host.logits(host.forward({"tokens": toks})))
    cc, hc = card.init_cache(2, 24), host.init_cache(2, 24)
    _lm_close(card.prefill({"tokens": toks[:, :16].cuda()}, cc)[0],
              host.prefill({"tokens": toks[:, :16]}, hc)[0])
    for t in range(16, 24):
        _lm_close(card.decode_step({"tokens": toks[:, t:t + 1].cuda()}, cc, t)[0],
                  host.decode_step({"tokens": toks[:, t:t + 1]}, hc, t)[0])
    for c_card, c_host in zip(cc, hc):
        for k in c_host:
            _lm_close(c_card[k], c_host[k])


# ---------------------------------------------------------------------------
# Training through the LP router, and the SSM, hybrid, encoder-decoder and
# M-RoPE families on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_backward_through_the_lp_router_raises_on_the_card(arch):
    """On CUDA tensors the router's LP runs on the kernel, which writes its
    solution through a raw pointer; backward still raises the reference's
    ``ValueError`` and no parameter moves.  ``topk`` backpropagates."""
    _need_card()
    card, _, toks = _moe_pair(arch, "lp")
    before = {n: p.detach().clone() for n, p in card.named_parameters()}
    opt = torch.optim.SGD(card.parameters(), lr=0.1)
    launched = simplex_cuda.launches
    loss = card.logits(card.forward({"tokens": toks.cuda()})).logsumexp(-1).mean()
    assert simplex_cuda.launches > launched
    with pytest.raises(ValueError, match="router='topk'"):
        loss.backward()
        opt.step()
    for n, p in card.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    topk, _, _ = _moe_pair(arch, "topk")
    topk.logits(topk.forward({"tokens": toks.cuda()})).logsumexp(-1).mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in topk.parameters())


@pytest.mark.parametrize("s", [100, 1])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_mamba_mixer_on_the_card_matches_the_cpu(arch, s):
    """The mixer's prefill (100 tokens at chunks of 64: two chunks and
    padding; 1 token: the decode branch) and four decode steps, outputs
    and both caches, at the parity tolerance."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import mamba2
    from repro_torch.models.convert import reference_weights

    _need_card()
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), ssm_chunk=64)
    params = {k: torch.as_tensor(v[0]) for k, v in reference_weights(cfg, 4)["g0"]["mixer"].items()}
    x = torch.as_tensor(np.random.default_rng(s).standard_normal((2, s + 4, cfg.d_model))
                        .astype(np.float32))
    caches = {dev: {k: torch.zeros(shape, dtype=getattr(torch, dt), device=dev)
                    for k, (shape, dt) in mamba2.mamba_cache_specs(cfg, 2, "float32").items()}
              for dev in ("cpu", "cuda")}
    card_params = {k: v.cuda() for k, v in params.items()}
    for lo, hi in [(0, s)] + [(t, t + 1) for t in range(s, s + 4)]:
        host, _ = mamba2.mamba_mixer(x[:, lo:hi], params, cfg, cache=caches["cpu"], cache_index=lo)
        card, _ = mamba2.mamba_mixer(x[:, lo:hi].cuda(), card_params, cfg, cache=caches["cuda"],
                                     cache_index=lo)
        assert card.is_cuda
        _lm_close(card, host)
        for k in ("conv", "state"):
            _lm_close(caches["cuda"][k], caches["cpu"][k])


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2",
                                  "qwen2-vl-72b"])
def test_family_engine_on_the_card_by_default(arch):
    """``Engine.generate`` on the card with the prompt's frames, patch
    embeddings and M-RoPE positions: the cache lives there, no kernel of
    the port is launched, and the first greedy picks agree with the CPU's
    (reduced random weights leave later picks undecided)."""
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights
    from repro_torch.serve.engine import Engine

    _need_card()
    cfg = configs.get_config(arch, reduced=True)
    tree = reference_weights(cfg, 6)
    card = load_reference_params(Model(cfg), tree)
    host = load_reference_params(Model(cfg, device="cpu"), tree)
    inputs = configs.make_inputs(cfg, configs.Shape("t", 24, 2, "prefill"), 1, device="cpu")
    if cfg.mrope_sections:
        inputs["positions"] = torch.as_tensor(configs.mrope_positions(2, 24, cfg.num_patches, 1))
    enc_len = inputs["frames"].shape[1] if "frames" in inputs else 0
    kernels = (simplex_cuda, hyperbox_cuda, revised_cuda, pdhg_cuda)
    before = [m.launches for m in kernels]
    engine = Engine(card, max_len=34, enc_len=enc_len)
    assert engine.device.type == "cuda"
    out = engine.generate(inputs, steps=10)
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert all(t.device.type == "cuda" for c in engine.cache for t in c.values())
    assert [m.launches for m in kernels] == before
    ref = Engine(host, max_len=34, enc_len=enc_len, device="cpu").generate(inputs, steps=10)
    agree = (out.cpu() == ref).int().cumprod(dim=1).sum(dim=1)
    assert int(agree.min()) >= 1


# ---------------------------------------------------------------------------
# Training (slice 12)
# ---------------------------------------------------------------------------

#: A train step on the card against the CPU, float32 with TF32 off: the two
#: devices sum in other orders, so the gradients differ at rounding level
#: (about 5e-5 relative on these configs) and Adam's first step moves an
#: element whose gradient lies within rounding of zero either way.  Gates:
#: the loss of each step, its grad_norm, and each parameter's change
#: without its most differing 0.1% of elements (relative L2).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-3
TRAIN_CHANGE_RTOL = 1e-2
TRAIN_ARCHS = ["gemma2-2b", "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
               "seamless-m4t-large-v2", "qwen2-vl-72b"]


def _train_inputs(cfg, step, device):
    from repro_torch import configs

    out = configs.make_inputs(cfg, configs.Shape("t", 24, 4, "train"), step, device="cpu")
    if cfg.mrope_sections:
        out["positions"] = torch.as_tensor(configs.mrope_positions(4, 24, cfg.num_patches, step))
    return {k: v.to(device) for k, v in out.items()}


def _train_two_steps(cfg, tree, device):
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import make_train_step

    model = load_reference_params(Model(cfg, device=device), tree)
    ocfg = optimizer.OptConfig(lr=1e-3, warmup_steps=2)
    state = optimizer.init(dict(model.named_parameters()), ocfg)
    step = make_train_step(model, ocfg, accum=2, remat=True)
    metrics = []
    for s in range(2):
        state, m = step(state, _train_inputs(cfg, s, device))
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state, metrics


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(arch):
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights, trimmed_rel

    _need_card()
    cfg = configs.get_config(arch, reduced=True)
    tree = reference_weights(cfg, 3)
    card, card_state, card_m = _train_two_steps(cfg, tree, torch.device("cuda"))
    host, host_state, host_m = _train_two_steps(cfg, tree, torch.device("cpu"))
    assert card.device.type == "cuda" and card_state.m["embed.embedding"].device.type == "cuda"
    for a, b in zip(card_m, host_m):
        assert abs(a["loss"] / b["loss"] - 1) <= TRAIN_LOSS_RTOL, (a, b)
        assert abs(a["grad_norm"] / b["grad_norm"] - 1) <= TRAIN_NORM_RTOL, (a, b)
        assert a["lr"] == b["lr"]
    start = dict(load_reference_params(Model(cfg, device="cpu"), tree).named_parameters())
    for (n, p), q in zip(card.named_parameters(), host.parameters()):
        p0 = start[n].detach()
        assert trimmed_rel((p.detach().cpu() - p0).numpy(), (q.detach() - p0).numpy(), 1e-3) \
            <= TRAIN_CHANGE_RTOL, n


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-lite-16b"])
def test_eval_step_under_lp_launches_the_simplex_kernel_per_moe_layer(arch):
    """``make_eval_step`` under ``router="lp"`` on the card: one simplex
    launch a MoE layer, all of the cluster variant, each launch's LP
    bit-identical on ``simplex_plain``, and the loss the CPU's within
    float32 rounding."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights
    from repro_torch.train.train_step import make_eval_step

    _need_card()
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), router="lp")
    tree = reference_weights(cfg, 3)
    card = load_reference_params(Model(cfg), tree)
    batch = _train_inputs(cfg, 0, torch.device("cuda"))
    records = []
    orig = simplex_cuda.simplex

    def spy(tab, basis, phase, c_ext, feas, cap, **kw):
        inputs = [t.clone() for t in (tab, basis, phase, c_ext, feas)]
        out = orig(tab, basis, phase, c_ext, feas, cap, **kw)
        records.append((inputs, cap, kw, basis.clone(), [t.clone() for t in out]))
        return out

    before, cluster = simplex_cuda.launches, simplex_cuda.variant_launches["cluster"]
    simplex_cuda.simplex = spy
    try:
        loss = float(make_eval_step(card)(batch))
    finally:
        simplex_cuda.simplex = orig
    n_moe = sum(k.endswith("_moe") for k in card.kinds())
    assert simplex_cuda.launches - before == len(records) == n_moe
    assert simplex_cuda.variant_launches["cluster"] - cluster == n_moe
    for inputs, cap, kw, basis, out in records:
        tab, b, ph, c_ext, feas = (t.clone() for t in inputs)
        plain = simplex_cuda.simplex_plain(tab, b, ph, c_ext, feas, cap, **kw)
        assert all(_same(x, y) for x, y in zip(list(plain) + [b], out + [basis]))
    host = load_reference_params(Model(cfg, device="cpu"), tree)
    want = float(make_eval_step(host)({k: v.cpu() for k, v in batch.items()}))
    assert abs(loss / want - 1) <= TRAIN_LOSS_RTOL


def test_checkpoint_written_on_the_card_restores_on_the_cpu(tmp_path):
    """The driver's checkpoint of a model and optimizer state on the card
    restores on the CPU with the same bits (bfloat16 parameters too)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models import Model
    from repro_torch.runtime.fault import DriverConfig, TrainDriver
    from repro_torch.train import optimizer

    _need_card()
    cfg = dataclasses.replace(configs.get_config("mamba2-130m", reduced=True), dtype="bfloat16")
    card = Model(cfg).init(torch.Generator(device="cuda").manual_seed(1))
    state = optimizer.init(dict(card.named_parameters()), optimizer.OptConfig())
    ckpt.save(str(tmp_path), 7, TrainDriver(DriverConfig(str(tmp_path)), card, None, None)
              .state(state))
    host = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    host_state = optimizer.init(dict(host.named_parameters()), optimizer.OptConfig())
    step, host_state = TrainDriver(DriverConfig(str(tmp_path)), host, None, None) \
        .resume_or_init(host_state)
    assert step == 7 and host_state.master["embed.embedding"].device.type == "cpu"
    dtypes = set()
    for (n, a), b in zip(card.named_parameters(), host.parameters()):
        assert a.dtype == b.dtype
        dtypes.add(a.dtype)
        width = {2: torch.int16, 4: torch.int32}[a.element_size()]
        assert torch.equal(a.detach().cpu().view(width), b.detach().view(width)), n
    assert torch.bfloat16 in dtypes
    for k in state.m:
        assert torch.equal(state.master[k].cpu(), host_state.master[k])


# -- the LP system over a mesh (ranks on the card) -----------------------------


@pytest.mark.parametrize("scenario,ranks", [("card_gloo", 2), ("card_nccl", 1)])
def test_mesh_ranks_on_the_card_solve_their_own_rows(scenario, ranks, tmp_path):
    """Gloo ranks sharing the card, or NCCL with one rank: every rank gets
    the whole answer, bit-equal to one process's, from kernel launches of
    its own, on the card.  The PDHG batch stays on the host: each rank's
    crossover polish must still run on its card (the simplex kernel)."""
    _need_card()
    import torch_mesh_worker as worker

    for r in worker.spawn(scenario, ranks, tmp_path):
        assert "error" not in r, r.get("error")
        for name, kernels in (("dense", (0,)), ("shared", (1,)), ("box", (2,)),
                              ("pdhg_crossover", (3, 0))):
            same, launches, device = r[name]
            assert same, name
            assert device.startswith("cuda"), (name, device)
            assert all(launches[k] >= 1 for k in kernels), (name, launches)
        assert r["int8"]


def test_lm_mesh_nccl_one_rank_is_bit_equal_to_no_mesh(tmp_path):
    """NCCL with one rank on the card: reduced deepseek under ``router="lp"``
    on a (1, 1) mesh (the mesh code path, every group of one rank) gives
    the meshless run's logits and tokens bit for bit, its router LPs on
    the simplex kernel's cluster variant (one a MoE layer a call)."""
    _need_card()
    import torch_lm_mesh_worker as lw
    import torch_mesh_worker as worker

    (r,) = worker.spawn("torch_lm_mesh_worker:card_nccl", 1, tmp_path)
    assert "error" not in r, r.get("error")
    plain, mesh = r["plain"], r["mesh"]
    assert mesh["device"].startswith("cuda")
    assert torch.equal(plain["logits"].view(torch.int32), mesh["logits"].view(torch.int32))
    assert torch.equal(plain["tokens"], mesh["tokens"])
    n_moe = lw.config("deepseek-v2-lite-16b", "lp").num_layers - 1
    calls = 1 + lw.FED_STEPS + lw.GEN_STEPS  # the fed run, then generate's
    launches, variants = mesh["launches"]
    assert launches == calls * n_moe == variants["cluster"], mesh["launches"]
    assert plain["lps"] == mesh["lps"]


def test_lm_mesh_gloo_ranks_on_the_card_match_one_process(tmp_path):
    """Two gloo ranks sharing the card, reduced gemma2 on the (1, 2) and (2, 1)
    meshes: every rank's greedy tokens equal the one-process run's under
    the abstract mesh of the same shape, and its logits lie within the LM
    CPU gates of them."""
    _need_card()
    import torch_lm_mesh_worker as lw
    import torch_mesh_worker as worker

    ranks = worker.spawn("torch_lm_mesh_worker:card_gloo", 2, tmp_path)
    for r in ranks:
        assert "error" not in r, r.get("error")
    for shape in ((1, 2), (2, 1)):
        one = ranks[0][("one",) + shape]
        blocks = {}
        for r in ranks:
            got = r[shape]
            assert got["device"].startswith("cuda")
            assert torch.equal(got["tokens"], one["tokens"]), shape
            blocks[got["rows"]] = got["logits"].numpy()
        whole = np.concatenate([blocks[k] for k in sorted(blocks)])
        ok, err, bound, rel = lw.gate(whole, one["logits"].numpy())
        assert ok, (shape, err, bound, rel)


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    _need_card()
    from repro_torch.launch import mesh as mesh_lib

    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="NCCL takes one rank a card"):
        mesh_lib.init_distributed("nccl", rank=0, world_size=torch.cuda.device_count() + 1)


def test_train_mesh_nccl_one_rank_is_bit_equal_to_no_mesh(tmp_path):
    """NCCL with one rank on the card: reduced gemma2 and deepseek (``topk``,
    MLA) train two steps on a (1, 1) mesh (the mesh code path, every group
    of one rank) to the meshless run's losses and parameters, bit for bit."""
    _need_card()
    import torch_mesh_worker as worker

    (r,) = worker.spawn("torch_train_mesh_worker:card_nccl", 1, tmp_path)
    assert "error" not in r, r.get("error")
    for arch in ("gemma2-2b", "deepseek-v2-lite-16b"):
        plain, mesh = r[(arch, "plain")], r[(arch, "mesh")]
        assert plain["loss"] == mesh["loss"] and plain["grad_norm"] == mesh["grad_norm"], arch
        assert plain["digest"] == mesh["digest"], arch


def test_train_mesh_gloo_ranks_on_the_card_match_one_process(tmp_path):
    """Four gloo ranks sharing the card on (2, 2): every family's train step
    against this process's run on the card under the abstract (2, 2) mesh,
    by the CPU test's gates (``tests/test_torch_mesh_train.py``)."""
    _need_card()
    import torch_mesh_worker as worker
    import torch_train_mesh_worker as w
    from test_torch_mesh_train import _gates
    from repro_torch.sharding import partition

    ranks = worker.spawn("torch_train_mesh_worker:card_gloo", 4, tmp_path)
    for r in ranks:
        assert "error" not in r, r.get("error")
    for arch in w.ARCHS:
        cfg = w.config(arch)
        with partition.activate({"data": 2, "model": 2}):
            one = w.train_case(cfg, device="cuda")
            one["noise"] = w.train_case(cfg, device="cuda", nudge=11)
        ratios = _gates(ranks[0][arch], one, cfg)
        worst = max(ratios, key=ratios.get)
        assert ratios[worst] <= 1.0, (arch, worst, ratios[worst])
        assert all(r[arch]["digest"] == ranks[0][arch]["digest"] for r in ranks), arch


def _chip_smoke(monkeypatch):
    """``chip_smoke.py`` as a module, importable by that name (spawned ranks
    import it) with the repo root on ``sys.path``."""
    import importlib.util
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    monkeypatch.syspath_prepend(str(root))
    spec.loader.exec_module(smoke)
    return smoke


def test_train_mesh_moe_at_full_width_holds_the_float64_witness(tmp_path, monkeypatch):
    """deepseek-v2-lite-16b at full width cut to 3 layers (``topk``), 3 steps
    of 4 x 128 tokens (``accum=2``) on 4 gloo ranks sharing the card on
    (2, 2) (``chip_smoke.lm_train_mesh_moe_case``): every step's ranks
    within the gate of the float64 witness set by the one-process float32
    runs, each step's routing flips reported on its line."""
    _need_card()
    from repro_torch import configs

    smoke = _chip_smoke(monkeypatch)
    row = smoke.lm_train_mesh_moe_case(configs, torch.device("cuda"), seed=0,
                                       out_dir=str(tmp_path))
    assert [s["ok"] for s in row["steps"]] == [True] * 3


@pytest.mark.parametrize("row", ["lm_qwen15", "lm_internlm2", "lm_command_r"])
def test_catalog_reference_on_the_card(row, monkeypatch):
    """A dense catalog config at full width cut to its fixture's depth
    (``chip_smoke.LM_CATALOG_FIXTURES``), as slice 11's reference rows are
    held (``chip_smoke.lm_family_reference``): the weights' digest, float32
    logits within the row gates with TF32 failing them, bfloat16 within
    ``LM_BF16_FACTOR`` of the reference's own bfloat16 gap."""
    _need_card()
    from repro_torch import configs

    smoke = _chip_smoke(monkeypatch)
    model, model16, out = smoke.lm_family_reference(configs, torch.device("cuda"), row,
                                                    smoke.LM_CATALOG_FIXTURES)
    assert out["logits_ok"] and out["bf16_rel_l2"] <= out["bf16_limit"], out


def test_catalog_dbrx_reference_on_the_card(monkeypatch):
    """dbrx-132b at full width cut to its fixture's depth, under ``topk`` and
    ``lp`` (``chip_smoke.lm_moe_reference_rows``): the float32 and bfloat16
    gates of ``lm_moe_reference``, and under ``lp`` the fixture's router
    LPs (24 x 128) on the simplex kernel and the port's own against the
    reference's bases (``router_lp_checks``)."""
    _need_card()
    from repro_torch import configs

    smoke = _chip_smoke(monkeypatch)
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}
    arch, path = smoke.LM_CATALOG_MOE_FIXTURE
    out = smoke.lm_moe_reference_rows(configs, torch.device("cuda"), arch, path,
                                      counters=counters, setup="lm_dbrx_reference_setup")
    assert sorted(out) == ["lp", "topk"]
    lp = out["lp"]["router_lp"]
    assert lp["ok"] and (lp["fixture_on_kernel"]["m"], lp["fixture_on_kernel"]["n"]) == (24, 128)
    assert out["lp"]["simplex_launches"] == out["lp"]["router_lps_solved"] > 0
    for router in ("topk", "lp"):
        assert out[router]["logits"]["ok"]
        assert out[router]["bf16_rel_l2"] <= out[router]["bf16_limit"]
