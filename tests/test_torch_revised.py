"""The port's revised simplex against ``repro.core.revised`` (the ``xla-shared`` backend).

The fixtures follow ``tests/test_revised.py`` (5x5 up to 16x16, and the
infeasible-start 12x6 and 10x5), under every pivot rule, in float32 and
float64.  Status, iteration count and final basis must be equal per LP;
the objective agrees to rtol 1e-5 (float32) or 1e-9 (float64) and x to
XTOL of max|x| (``tests/test_torch_simplex.py`` says why the bits
differ).  RPC noise is bit-equal: the trajectories under ``rpc`` match.
On CPU tensors ``kernels/ops.py`` runs the kernel's plain version, which
is also held against the reference's Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import lp as jlp
from repro.core import revised as jrevised
from repro.kernels import ops as jops
from repro_torch.core import convert, engine
from repro_torch.core import lp as tlp
from repro_torch.core import revised as trevised
from repro_torch.kernels import ops as tops
from repro_torch.kernels import revised_cuda

from test_torch_simplex import RTOL, assert_matches_reference

FIXTURES = [
    (8, 5, 5, True),
    (8, 10, 10, True),
    (8, 16, 16, True),
    (8, 16, 8, True),
    (8, 12, 6, False),
    (8, 10, 5, False),
]


def _shared(batch, m, n, feasible, dtype):
    seed = batch * 1000003 + m * 101 + n
    jb = jlp.random_shared_lp_batch(np.random.default_rng(seed), batch, m, n, feasible,
                                    dtype=dtype)
    tb = tlp.random_shared_lp_batch(np.random.default_rng(seed), batch, m, n, feasible,
                                    dtype=dtype, device="cpu")
    return jb, tb


def _assert_bit_equal(x, y, fields):
    for f in fields:
        assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_cold_state_is_contiguous_and_writable():
    _, tb = _shared(4, 12, 6, False, np.float32)
    state = trevised._cold_state(tb.a, tb.b)
    for t in (state.binv, state.basis, state.xb, state.phase):
        assert t.is_contiguous()
    assert state.binv.stride() == (144, 12, 1)
    state.binv[0, 0, 1] = 5.0  # a fresh buffer: the other LPs keep I
    assert torch.equal(state.binv[1], torch.eye(12))
    assert state.basis.dtype == torch.int32 and state.phase.dtype == torch.int32
    assert torch.equal(state.phase, torch.ones(4, dtype=torch.int32))


def test_warm_state_singular_basis_falls_back_cold():
    _, tb = _shared(6, 8, 8, True, np.float64)
    cold = trevised.solve_batched(tb.a, tb.b, tb.c)
    basis0 = cold.basis.clone()
    basis0[:2, 1] = basis0[:2, 0]  # a repeated column: a singular basis matrix
    binv, _, _, ok = trevised._warm_state(tb.a, tb.b, basis0)
    assert ok.tolist() == [False, False, True, True, True, True]
    assert bool(torch.isfinite(binv).all())
    warm = trevised.solve_batched(tb.a, tb.b, tb.c, basis0=basis0)
    assert torch.equal(warm.iterations[:2], cold.iterations[:2])  # cold start
    assert (warm.iterations[2:] == 0).all()  # already optimal
    np.testing.assert_allclose(warm.objective.numpy(), cold.objective.numpy(), rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("batch,m,n,feasible", FIXTURES)
def test_solve_batched_matches_reference(batch, m, n, feasible, rule, dtype):
    jb, tb = _shared(batch, m, n, feasible, dtype)
    sol_j = jrevised.solve_batched(jb.a, jb.b, jb.c, rule=rule, seed=7)
    sol_t = trevised.solve_batched(tb.a, tb.b, tb.c, rule=rule, seed=7)
    assert_matches_reference(sol_t, sol_j, dtype)


@pytest.mark.parametrize("rule", ["lpc", "bland"])
def test_resume_chain_bit_identical_to_one_solve(rule):
    _, tb = _shared(8, 12, 6, False, np.float32)
    k1, k2 = 5, 40
    full, full_state = trevised.solve_batched(tb.a, tb.b, tb.c, rule=rule, max_iters=k1 + k2,
                                              want_state=True)
    part, state = trevised.solve_batched(tb.a, tb.b, tb.c, rule=rule, max_iters=k1,
                                         want_state=True)
    assert (part.status.numpy() == jlp.ITER_LIMIT).any()
    rest, rest_state = trevised.resume_batched(tb.a, tb.b, tb.c, state, rule=rule, max_iters=k2)
    _assert_bit_equal(rest, full, ("objective", "x", "status", "basis"))
    assert torch.equal(part.iterations + rest.iterations, full.iterations)
    _assert_bit_equal(rest_state, full_state, ("binv", "basis", "xb", "phase"))
    # The same chain through the kernel wrappers (plain version on the CPU).
    kpart, kstate = tops.revised_solve(tb.a, tb.b, tb.c, rule=rule, max_iters=k1,
                                       want_state=True)
    krest, kstate2 = tops.revised_resume(tb.a, tb.b, tb.c, kstate, rule=rule, max_iters=k2)
    _assert_bit_equal(krest, full, ("objective", "x", "status", "basis"))
    _assert_bit_equal(kstate2, full_state, ("binv", "basis", "xb", "phase"))
    assert torch.equal(kstate.binv, state.binv)  # the caller's state is left as it was


@pytest.mark.parametrize("rule", ["lpc", "rpc"])
def test_resume_chain_matches_reference(rule):
    jb, tb = _shared(8, 12, 6, False, np.float32)
    _, jstate = jrevised.solve_batched(jb.a, jb.b, jb.c, rule=rule, seed=3, max_iters=5,
                                       want_state=True)
    jrest, _ = jrevised.resume_batched(jb.a, jb.b, jb.c, jstate, rule=rule, seed=3,
                                       max_iters=40)
    _, tstate = trevised.solve_batched(tb.a, tb.b, tb.c, rule=rule, seed=3, max_iters=5,
                                       want_state=True)
    trest, _ = trevised.resume_batched(tb.a, tb.b, tb.c, tstate, rule=rule, seed=3,
                                       max_iters=40)
    assert_matches_reference(trest, jrest, np.float32)


def test_init_batched_then_resume_equals_cold_solve():
    _, tb = _shared(8, 10, 10, True, np.float64)
    state = trevised.init_batched(tb.a, tb.b, tb.c)
    resumed = trevised.resume_batched(tb.a, tb.b, tb.c, state, want_state=False)
    _assert_bit_equal(resumed, trevised.solve_batched(tb.a, tb.b, tb.c),
                      ("objective", "x", "status", "iterations", "basis"))


@pytest.mark.parametrize("warm", [True, False])
def test_sweep_matches_reference(warm):
    jb, tb = _shared(6, 16, 8, True, np.float32)
    rng = np.random.default_rng(4)
    base = rng.uniform(0.1, 1.0, size=(6, 8))
    stack = np.stack([base + 0.05 * t * rng.normal(size=base.shape) for t in range(4)])
    stack = stack.astype(np.float32)
    outs_j = jrevised.sweep_batched(jb.a, jb.b, stack, warm=warm)
    outs_t = trevised.sweep_batched(tb.a, tb.b, torch.as_tensor(stack), warm=warm)
    obj_j, _, status_j, iters_j = (np.asarray(v) for v in outs_j)
    obj_t, x_t, status_t, iters_t = outs_t
    assert np.array_equal(status_t.numpy(), status_j)
    assert np.array_equal(iters_t.numpy(), iters_j)
    ok = status_j == jlp.OPTIMAL
    np.testing.assert_allclose(obj_t.numpy()[ok], obj_j[ok], rtol=RTOL[np.float32])
    if warm:
        assert iters_t[1:].sum() < iters_t[0].sum() * 3  # later steps start warm
    # The kernel wrapper's sweep (plain version on the CPU) is the same loop.
    for got, want in zip(tops.revised_sweep(tb.a, tb.b, torch.as_tensor(stack), warm=warm),
                         outs_t):
        assert torch.equal(got, want)


def _recorded_sweep(tb, c_stack, warm, rule, seed):
    """The plain sweep, keeping each step's terminal ``(basis, xb, status)``."""
    cap, tol = trevised.resolve_cap_tol(tb.a, 0, 0.0)
    feas = engine.phase1_feasibility_tol(tb.b)
    states = []

    def step(c_t, start):
        sol, out = trevised._iterate(tb.a, tb.b, c_t, start, feas, cap, seed, rule=rule,
                                     tol=tol)
        states.append((out.basis.clone(), out.xb.clone(), sol.status.clone()))
        return sol, out

    trevised.sweep_loop(tb.a, tb.b, c_stack, step, warm)
    return states


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("rule,dtype", [("lpc", np.float32), ("rpc", np.float32),
                                        ("bland", np.float64)])
def test_ops_revised_sweep_matches_reference(warm, rule, dtype):
    jb, tb = _shared(6, 12, 6, False, dtype)
    rng = np.random.default_rng(11)
    stack = (np.asarray(jb.c)[None] + 0.3 * rng.normal(size=(5, 6, 6))).astype(dtype)
    outs_j = jrevised.sweep_batched(jb.a, jb.b, stack, rule=rule, seed=2, warm=warm)
    c_stack = torch.as_tensor(stack)
    before = revised_cuda.launches
    outs_t = tops.revised_sweep(tb.a, tb.b, c_stack, rule=rule, seed=2, warm=warm)
    assert revised_cuda.launches == before  # CPU tensors: the plain version
    obj_j, x_j, status_j, iters_j = (np.asarray(v) for v in outs_j)
    obj_t, x_t, status_t, iters_t = outs_t
    assert np.array_equal(status_t.numpy(), status_j)
    assert np.array_equal(iters_t.numpy(), iters_j)
    ok = status_j == jlp.OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(obj_t.numpy()[ok], obj_j[ok], rtol=RTOL[dtype])
    assert np.isneginf(obj_t.numpy()[~ok]).all() and np.isneginf(obj_j[~ok]).all()
    # Each step's objective in the bits of core/revised.py:objective at its
    # terminal state (the sum the kernel computes).
    for t, (basis, xb, status) in enumerate(_recorded_sweep(tb, c_stack, warm, rule, 2)):
        assert torch.equal(obj_t[t], trevised.objective(basis, xb, c_stack[t], status))
        assert torch.equal(x_t[t], trevised.primal(basis, xb, status, 6))


def test_revised_wrapper_returns_the_objective_of_its_terminal_state():
    _, tb = _shared(8, 12, 6, False, np.float32)
    state = trevised.init_traced(tb.a, tb.b, None)
    bufs = [t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]
    obj, x, status, iters = revised_cuda.revised(tb.a, tb.b, tb.c, *bufs,
                                                 engine.phase1_feasibility_tol(tb.b), 200)
    assert torch.equal(obj, trevised.objective(bufs[1], bufs[2], tb.c, status))
    assert torch.equal(obj, trevised.solve_batched(tb.a, tb.b, tb.c, max_iters=200).objective)


@pytest.mark.parametrize("feasible", [True, False])
def test_ops_revised_solve_matches_pallas_interpret(feasible):
    rng_seed = 101 + feasible
    jb = jlp.random_shared_lp_batch(np.random.default_rng(rng_seed), 8, 10, 5, feasible)
    tb = tlp.random_shared_lp_batch(np.random.default_rng(rng_seed), 8, 10, 5, feasible,
                                    device="cpu")
    sol_j, state_j = jops.revised_solve(jb.a, jb.b, jb.c, interpret=True, want_state=True,
                                        tile_b=4)
    before = revised_cuda.launches
    sol_t, state_t = tops.revised_solve(tb.a, tb.b, tb.c, want_state=True)
    assert revised_cuda.launches == before  # CPU tensors: the plain version
    assert_matches_reference(sol_t, sol_j, np.float32)
    assert np.array_equal(state_t.phase.numpy(), np.asarray(state_j.phase))
    np.testing.assert_allclose(state_t.xb.numpy(), np.asarray(state_j.xb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state_t.binv.numpy(), np.asarray(state_j.binv), rtol=1e-5,
                               atol=1e-5)


def test_jax_revised_state_continues_in_the_port():
    jb, _ = _shared(8, 12, 6, False, np.float32)
    _, jstate = jrevised.solve_batched(jb.a, jb.b, jb.c, max_iters=6, want_state=True)
    state = convert.from_numpy(trevised.RevisedResumeState, convert.to_numpy(jstate),
                               device="cpu")
    assert state.basis.dtype == torch.int32 and state.phase.dtype == torch.int32
    batch = convert.from_numpy(tlp.SharedLPBatch, convert.to_numpy(jb), device="cpu")
    assert tuple(batch.a.shape) == (12, 6)  # the shared A has no batch axis
    sol_t = trevised.resume_batched(batch.a, batch.b, batch.c, state, max_iters=60,
                                    want_state=False)
    sol_j = jrevised.resume_batched(jb.a, jb.b, jb.c, jstate, max_iters=60, want_state=False)
    assert_matches_reference(sol_t, sol_j, np.float32)


def test_state_bytes_match_reference():
    for m, n in [(10, 5), (100, 100), (200, 100)]:
        assert trevised.state_bytes_per_lp(m, n) == jrevised.state_bytes_per_lp(m, n)
        assert trevised.state_bytes_per_lp(m, n, torch.float64) == jrevised.state_bytes_per_lp(
            m, n, np.float64)
        assert trevised.stored_bytes_per_lp(m, n, 64) == jrevised.stored_bytes_per_lp(m, n, 64)


# ---------------------------------------------------------------------------
# the round protocol on the shared backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch-shared", "cuda-shared"])
def test_shared_compaction_bit_identical(backend):
    from repro_torch.core import dispatch as tdispatch

    sb = tlp.random_shared_lp_batch(np.random.default_rng(11), 24, 12, 6, False, device="cpu")
    plain = tdispatch.solve_canonical(sb, repro_torch.SolveOptions(backend=backend))
    compacted = tdispatch.solve_canonical(sb, repro_torch.SolveOptions(
        backend=backend, compaction="every_k", compact_every=3, resume="basis"))
    _assert_bit_equal(plain, compacted, ("objective", "x", "status", "iterations", "basis"))
    jb = jlp.random_shared_lp_batch(np.random.default_rng(11), 24, 12, 6, False)
    ref = repro.solve(jb, repro.SolveOptions(backend="xla-shared", autotune="off",
                                             compaction="every_k", compact_every=3,
                                             resume="basis"))
    assert_matches_reference(compacted, ref, np.float32)


@pytest.mark.parametrize("backend", ["torch-shared", "cuda-shared"])
def test_shared_serve_protocol_splice_bitwise(backend):
    # init_state, capped resume_round quanta and a mid-flight splice land
    # bit-identical to the one-shot solve.
    rng = np.random.default_rng(21)
    first = tlp.random_shared_lp_batch(rng, 6, 10, 5, False, device="cpu")
    second = tlp.SharedLPBatch(
        first.a, torch.from_numpy(rng.uniform(0.5, 2.0, size=(4, 10)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32)))
    merged = tlp.SharedLPBatch(first.a, torch.cat([first.b, second.b]),
                               torch.cat([first.c, second.c]))
    opts = repro_torch.SolveOptions(backend=backend)
    oneshot = repro_torch.solve(merged, opts)
    sess = repro_torch.SolveSession(opts, device="cpu")
    batch, state, sol = first, sess.init_state(first, opts), None
    for step in range(64):
        if step == 2:
            batch = merged
            state = tlp.concat_states([state, sess.init_state(second, opts)])
        sol, state = sess.resume_round(batch, state, cap=3, options=opts)
        if not bool((sol.status == tlp.ITER_LIMIT).any()):
            break
    assert batch.batch == merged.batch
    _assert_bit_equal(sol, oneshot, ("objective", "x", "status"))


# ---------------------------------------------------------------------------
# float32 at the paper's sizes: known differences from the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,bsz,m,n,ref_iters,port_iters", [
    (1301, 8, 40, 30, [125, 138, 98, 115, 128, 110, 121, 120],
     [123, 111, 96, 115, 116, 109, 121, 118]),
    (1791, 4, 100, 100, [1688, 1633, 1592, 1126], [1513, 1527, 1476, 1000]),
])
def test_float32_revised_trajectories_past_16x16_are_known_differences(
        seed, bsz, m, n, ref_iters, port_iters):
    """Float32 pivot parity on the revised path holds on this file's fixtures
    (up to 16x16) and not at 40x30 or 100x100, bland, seed 3.

    Attributed contraction by contraction on a scratch copy of the port
    (``ROADMAP.md``, "Kept divergences and guards"): the port matches the
    reference on both fixtures only when it takes, all at once, XLA's
    results for the three contractions (y = c_B B^-1, the pricing against
    A, u = B^-1 me), XLA's fused binv/xb update and the reference's
    pricing of basic columns (which the port zeroes by design).  XLA's
    CPU dot order is its vectorised, ISA-dependent one, which the kernel
    cannot follow cheaply, so both fixtures are pinned here: the same
    statuses and optimal objectives, other pivot counts.
    """
    jb = jlp.random_shared_lp_batch(np.random.default_rng(seed), bsz, m, n, True)
    tb = tlp.random_shared_lp_batch(np.random.default_rng(seed), bsz, m, n, True, device="cpu")
    sol_j = jrevised.solve_batched(jb.a, jb.b, jb.c, rule="bland", seed=3)
    sol_t = trevised.solve_batched(tb.a, tb.b, tb.c, rule="bland", seed=3)
    assert np.asarray(sol_j.iterations).tolist() == ref_iters
    assert sol_t.iterations.tolist() == port_iters
    assert np.array_equal(sol_t.status.numpy(), np.asarray(sol_j.status))
    assert (sol_t.status.numpy() == jlp.OPTIMAL).all()
    np.testing.assert_allclose(sol_t.objective.numpy(), np.asarray(sol_j.objective),
                               rtol=RTOL[np.float32])


def test_float32_status_at_100x100_follows_the_oracle_not_the_reference():
    # The reference prices basic columns afresh; in float32 one enters and
    # it ends ITER_LIMIT after 10,000 pivots on all 4 LPs.  The port zeroes
    # them and ends UNBOUNDED, as the float64 oracle does.
    from repro_torch.core import oracle

    tb = tlp.random_shared_lp_batch(np.random.default_rng(1808), 4, 100, 100, True,
                                    device="cpu")
    sol_t = trevised.solve_batched(tb.a, tb.b, tb.c, rule="bland", seed=3)
    dense = tb.densify()
    _, _, status, _ = oracle.solve_batch(*(t.double().numpy() for t in
                                           (dense.a, dense.b, dense.c)))
    assert (status == jlp.UNBOUNDED).all()
    assert np.array_equal(sol_t.status.numpy(), status)
    assert sol_t.iterations.tolist() == [913, 922, 1175, 979]
