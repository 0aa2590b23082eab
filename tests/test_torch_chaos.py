"""The port's fault injection and recovery against ``repro``'s (``tests/test_chaos.py``).

Every case of the reference's file runs on the port with ``device="cpu"``
(the kernels' plain versions): an injected backend failure re-dispatches
the same round from the same carried state and ends bit-identical to the
clean run; a NaN poisoned into a carried state retires exactly that row
``NUMERICAL``; the quarantine re-solves it on the float64 oracle; input
with NaN is refused at the door.  Where a result is compared, the port's
is also held against the reference's run of the same case: status,
iterations and basis equal; objective within rtol 1e-5 (float32) and x
within 1e-4 of max|x| (``test_torch_simplex.py``'s contract).

Port-only: the fault schedule of a seed equals the reference's, fault for
fault; a kernel that did not build, or whose launch failed, is never
retried.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import dispatch as jdispatch
from repro.core import lp as jlp
from repro.runtime import chaos as jchaos
from repro_torch.core import dispatch
from repro_torch.core import lp as tlp
from repro_torch.core.problem import LPProblem, canonicalize_shared
from repro_torch.kernels import build
from repro_torch.runtime import chaos

from test_torch_simplex import RTOL, XTOL

RESUME = dict(compaction="every_k", compact_every=4, resume="basis")


def _arrays(bsz=6, m=8, n=6, seed=0):
    jb = jlp.random_lp_batch(np.random.default_rng(seed), bsz, m, n)
    return tuple(np.asarray(v) for v in (jb.a, jb.b, jb.c))


def _batch(bsz=6, m=8, n=6, seed=0):
    return tlp.LPBatch.from_numpy(*_arrays(bsz, m, n, seed), device="cpu")


def _ref_batch(bsz=6, m=8, n=6, seed=0):
    return jlp.LPBatch(*_arrays(bsz, m, n, seed))


def _shared(jb):
    return tlp.SharedLPBatch(*(torch.as_tensor(np.array(v)) for v in (jb.a, jb.b, jb.c)))


@pytest.fixture
def broken_simplex_build(monkeypatch, tmp_path):
    """The simplex source swapped for one that does not compile, and every
    launch of the simplex wrapper routed through the build, as a launch on a
    CUDA tensor is.  Without a toolkit ``nvcc`` is missing; with one the
    source fails to compile: either way ``build.load`` raises
    ``KernelBuildError``."""
    from repro_torch.kernels import simplex_cuda

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "simplex.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))

    def launch(*args, **kw):
        build.load("simplex")
        raise AssertionError("a source that does not compile was loaded")

    monkeypatch.setattr(simplex_cuda, "simplex_plain", launch)


class _FailingLaunch:
    """Stands in for the simplex wrapper's plain version: every call is a
    launch that returned CUDA error 700, raised as the wrapper raises it
    (``build.launch_error`` on the library's ``simplex_error_string``)."""

    def __init__(self):
        self.calls = 0
        self.simplex_error_string = lambda err: b"an illegal memory access was encountered"

    def __call__(self, *args, **kw):
        self.calls += 1
        raise build.launch_error(self, "simplex", 700, "simplex kernel (cluster, k=2)")


@pytest.fixture
def failing_simplex_launch(monkeypatch):
    """Every launch of the simplex wrapper fails with a CUDA error."""
    from repro_torch.kernels import simplex_cuda

    fail = _FailingLaunch()
    monkeypatch.setattr(simplex_cuda, "simplex_plain", fail)
    return fail


def _ref_opts(**kw):
    return repro.SolveOptions(backend=kw.pop("backend", "xla"), autotune="off", **kw)


def assert_identical(ref, sol, rows=slice(None), iterations=True):
    """Bit for bit: status, objective, x (and iterations)."""
    fields = ("status", "objective", "x") + (("iterations",) if iterations else ())
    for f in fields:
        a, b = getattr(ref, f)[rows], getattr(sol, f)[rows]
        same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b
        assert bool(same.all()), f


def assert_parity(sol_t, sol_j, rows=slice(None), dtype=np.float32, basis=True):
    """The parity contract: status, iterations (and basis) equal; objective and
    x within the dtype's tolerance on OPTIMAL rows, equal elsewhere."""
    status = np.asarray(sol_j.status)[rows]
    assert np.array_equal(sol_t.status.cpu().numpy()[rows], status)
    assert np.array_equal(sol_t.iterations.cpu().numpy()[rows], np.asarray(sol_j.iterations)[rows])
    if basis and sol_t.basis is not None and sol_j.basis is not None:
        assert np.array_equal(sol_t.basis.cpu().numpy()[rows], np.asarray(sol_j.basis)[rows])
    ok = status == jlp.OPTIMAL
    obj_t = sol_t.objective.cpu().numpy()[rows]
    obj_j = np.asarray(sol_j.objective)[rows]
    np.testing.assert_allclose(obj_t[ok], obj_j[ok], rtol=RTOL[dtype])
    np.testing.assert_array_equal(obj_t[~ok], obj_j[~ok])
    x_t = sol_t.x.cpu().numpy()[rows].astype(np.float64)
    x_j = np.asarray(sol_j.x)[rows].astype(np.float64)
    scale = max(1.0, float(np.abs(x_j).max())) if x_j.size else 1.0
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=XTOL[dtype] * scale)


# -- retry from the carried state -----------------------------------------


def test_injected_failure_recovers_bit_identical():
    batch = _batch()
    opts = repro_torch.SolveOptions(**RESUME)
    ref = dispatch.solve_canonical(batch, opts)
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=(1,))) as mk:
        sol = dispatch.solve_canonical(batch, opts, stats=stats)
    assert mk.faults_injected == 1
    assert stats.retries == 1
    assert stats.faults_injected == 1
    assert_identical(ref, sol)
    jstats = repro.SolveStats()
    with jchaos.inject(jchaos.ChaosMonkey(fail_rounds=(1,))):
        jsol = jdispatch.solve_canonical(_ref_batch(), _ref_opts(**RESUME), stats=jstats)
    assert jstats.retries == stats.retries
    assert_parity(sol, jsol)


def test_retry_budget_exhausted_raises():
    opts = repro_torch.SolveOptions(retry_budget=1, retry_backoff=0.0, **RESUME)
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=tuple(range(32)))):
        with pytest.raises(chaos.ChaosError):
            dispatch.solve_canonical(_batch(), opts)


def test_retry_budget_zero_fails_fast():
    stats = repro_torch.SolveStats()
    opts = repro_torch.SolveOptions(retry_budget=0, **RESUME)
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=(0,))):
        with pytest.raises(chaos.ChaosError):
            dispatch.solve_canonical(_batch(), opts, stats=stats)
    assert stats.retries == 0


def test_non_transient_errors_are_not_retried():
    assert not chaos.is_transient(ValueError("bad argument"))
    assert not chaos.is_transient(TypeError("bad type"))
    assert not chaos.is_transient(build.KernelBuildError("nvcc failed"))
    assert chaos.is_transient(chaos.ChaosError("injected"))
    assert chaos.is_transient(RuntimeError("device lost"))
    # An unknown backend raises ValueError out of dispatch_round_safe
    # without burning the retry budget.
    stats = repro_torch.SolveStats()
    with pytest.raises(ValueError):
        dispatch.dispatch_round_safe(_batch(), repro_torch.SolveOptions(backend="no-such"), stats)
    assert stats.retries == 0


def test_kernel_build_error_is_never_retried(broken_simplex_build):
    """A kernel that does not build propagates out of dispatch_round_safe and
    out of ``repro_torch.solve`` at once: no retry, no plain-version answer."""
    stats = repro_torch.SolveStats()
    with pytest.raises(build.KernelBuildError):
        dispatch.dispatch_round_safe(_batch(), repro_torch.SolveOptions(retry_backoff=0.0), stats)
    assert stats.retries == 0
    stats = repro_torch.SolveStats()
    with pytest.raises(build.KernelBuildError):
        repro_torch.solve(_batch(), repro_torch.SolveOptions(**RESUME), stats=stats)
    assert stats.retries == 0 and stats.lps == 0


def test_kernel_launch_error_is_never_retried(failing_simplex_launch):
    """A launch that returned a CUDA error propagates out of
    dispatch_round_safe and out of ``repro_torch.solve`` after one attempt:
    no retry, no answer."""
    err = build.launch_error(failing_simplex_launch, "simplex", 700, "simplex kernel")
    assert isinstance(err, build.KernelLaunchError) and isinstance(err, build.KernelError)
    assert "CUDA error 700 (an illegal memory access was encountered)" in str(err)
    assert not chaos.is_transient(err)
    stats = repro_torch.SolveStats()
    with pytest.raises(build.KernelLaunchError):
        dispatch.dispatch_round_safe(_batch(), repro_torch.SolveOptions(retry_backoff=0.0), stats)
    assert stats.retries == 0 and failing_simplex_launch.calls == 1
    stats = repro_torch.SolveStats()
    with pytest.raises(build.KernelLaunchError):
        repro_torch.solve(_batch(), repro_torch.SolveOptions(**RESUME), stats=stats)
    assert stats.retries == 0 and stats.lps == 0 and failing_simplex_launch.calls == 2


def test_shard_crash_mid_round_recovers_bit_identical():
    batch = _batch(bsz=8)
    opts = repro_torch.SolveOptions(chunk_size=4)
    ref = dispatch.solve_canonical(batch, opts)
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(crash_rounds=(0,), max_faults=1)) as mk:
        sol = dispatch.solve_canonical(batch, opts, stats=stats)
    assert mk.faults_injected == 1
    assert stats.retries == 1
    assert_identical(ref, sol)
    with jchaos.inject(jchaos.ChaosMonkey(crash_rounds=(0,), max_faults=1)):
        jsol = jdispatch.solve_canonical(_ref_batch(bsz=8), _ref_opts(chunk_size=4))
    assert_parity(sol, jsol)


@pytest.mark.parametrize("backend,ref_backend", [
    ("cuda", "xla"), ("torch", "xla"), ("pdhg", "pdhg"), ("cuda-shared", "xla-shared"),
    ("torch-shared", "xla-shared")])
def test_recovery_across_backends(backend, ref_backend):
    """Fail once, retry on the same backend: bit-identical on every family."""
    rng = np.random.default_rng(1)
    if backend.endswith("shared"):
        jb = jlp.random_shared_lp_batch(rng, 6, 8, 6)
        batch = _shared(jb)
    else:
        jb = jlp.random_lp_batch(rng, 6, 8, 6)
        batch = tlp.LPBatch.from_numpy(*(np.asarray(v) for v in (jb.a, jb.b, jb.c)),
                                       device="cpu")
    opts = repro_torch.SolveOptions(backend=backend)
    ref = dispatch.solve_canonical(batch, opts)
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=(0,), max_faults=1)):
        sol = dispatch.solve_canonical(batch, opts, stats=stats)
    assert stats.retries == 1
    assert_identical(ref, sol)
    with jchaos.inject(jchaos.ChaosMonkey(fail_rounds=(0,), max_faults=1)):
        jsol = jdispatch.solve_canonical(jb, _ref_opts(backend=ref_backend))
    if backend == "pdhg":
        # The first-order loops agree in status and steps, and within the
        # PDHG tolerance (tests/test_torch_pdhg.py), not to the simplex's.
        assert np.array_equal(sol.status.numpy(), np.asarray(jsol.status))
        assert np.array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
        np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=0, atol=1e-4)
    else:
        assert_parity(sol, jsol)


def test_recovery_reuses_warm_specialisations():
    """The retry re-enters kernels already used: no new specialisation."""
    batch = _batch()
    opts = repro_torch.SolveOptions(**RESUME)
    dispatch.solve_canonical(batch, opts)  # warm
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=(1,))):
        dispatch.solve_canonical(batch, opts, stats=stats)
    assert stats.retries == 1
    assert stats.compiles == 0


# -- numerical guardrails -------------------------------------------------


def test_poisoned_state_retires_numerical():
    batch = _batch()
    opts = repro_torch.SolveOptions(**RESUME)
    ref = dispatch.solve_canonical(batch, opts)
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(poison_rows={0: (0,)})) as mk:
        sol = dispatch.solve_canonical(batch, opts, stats=stats)
    assert mk.rows_poisoned == 1
    assert stats.faults_injected == 1
    assert int(sol.status[0]) == tlp.NUMERICAL
    assert np.isnan(float(sol.objective[0]))
    assert_identical(ref, sol, rows=slice(1, None))
    with jchaos.inject(jchaos.ChaosMonkey(poison_rows={0: (0,)})):
        jsol = jdispatch.solve_canonical(_ref_batch(), _ref_opts(**RESUME))
    assert_parity(sol, jsol, rows=slice(1, None))
    assert int(np.asarray(jsol.status)[0]) == tlp.NUMERICAL


@pytest.mark.parametrize("backend", ["cuda", "cuda-shared", "pdhg"])
def test_poison_fills_every_floating_field_of_each_state_type(backend):
    """``poison_state`` writes NaN into the chosen rows of every floating field
    of the three state types (tableau, revised record, PDHG iterates), on the
    state's own device, and leaves the integer fields and other rows alone."""
    rng = np.random.default_rng(4)
    if backend == "cuda-shared":
        jb = jlp.random_shared_lp_batch(rng, 4, 8, 6)
        batch = _shared(jb)
    else:
        batch = tlp.random_lp_batch(rng, 4, 8, 6, device="cpu")
    be = repro_torch.get_backend(backend)
    _, state = be.start_canonical(batch, repro_torch.SolveOptions(backend=backend, max_iters=2))
    mk = chaos.ChaosMonkey(poison_rows={3: (1, 2, 9)})
    same, n = mk.poison_state(0, state)
    assert same is state and n == 0
    out, n = mk.poison_state(3, state)
    assert n == 2 and mk.rows_poisoned == 2
    for f in type(state).__dataclass_fields__:
        before, after = getattr(state, f), getattr(out, f)
        assert after.device == before.device
        if before.is_floating_point():
            assert bool(after[1:3].isnan().all())
            assert torch.equal(after[[0, 3]], before[[0, 3]])
        else:
            assert torch.equal(after, before)
    healthy = dispatch.state_health(out)
    assert healthy.tolist() == [True, False, False, True]


def test_guardrails_never_flag_honest_statuses():
    """UNBOUNDED/INFEASIBLE rows pass the health mask untouched."""
    rng = np.random.default_rng(2)
    m, n = 8, 6
    easy = jlp.random_lp_batch(rng, 2, m, n)
    a_unb = -np.abs(rng.uniform(0.1, 1.0, size=(2, m, n)))
    b_unb = np.ones((2, m))
    c_unb = np.abs(rng.uniform(0.1, 1.0, size=(2, n)))
    a_inf = np.zeros((2, m, n))
    b_inf = np.ones((2, m))
    a_inf[:, 0, 0] = 1.0
    a_inf[:, 1, 0] = -1.0
    b_inf[:, 0] = 1.0
    b_inf[:, 1] = -3.0
    c_inf = np.ones((2, n))
    arrays = [np.concatenate([np.asarray(e), u, i]).astype(np.float32) for e, u, i in (
        (easy.a, a_unb, a_inf), (easy.b, b_unb, b_inf), (easy.c, c_unb, c_inf))]
    batch = tlp.LPBatch.from_numpy(*arrays, device="cpu")
    off = dispatch.solve_canonical(batch, repro_torch.SolveOptions(guardrails=False))
    on = dispatch.solve_canonical(batch, repro_torch.SolveOptions())
    assert not np.any(on.status.numpy() == tlp.NUMERICAL)
    assert_identical(off, on)
    assert_parity(on, jdispatch.solve_canonical(jlp.LPBatch(*arrays), _ref_opts()))


def test_quarantine_rescues_poisoned_rows():
    batch = _batch()
    opts = repro_torch.SolveOptions(**RESUME)
    ref = dispatch.solve_canonical(batch, opts)
    stats = repro_torch.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(poison_rows={0: (0,)})):
        sol = dispatch.solve_canonical(batch, opts.replace(quarantine=True), stats=stats)
    assert stats.quarantined == 1
    assert int(sol.status[0]) == tlp.OPTIMAL
    # The oracle answers in float64: equal to the device answer, not bit-equal.
    assert abs(float(sol.objective[0]) - float(ref.objective[0])) < 1e-6
    assert_identical(ref, sol, rows=slice(1, None))


# -- input validation -----------------------------------------------------


def test_make_rejects_nan_naming_field():
    c = np.array([[1.0, np.nan]])
    a = np.ones((1, 2, 2))
    b = np.ones((1, 2))
    with pytest.raises(ValueError, match=r"\.c contains NaN"):
        LPProblem.make(c=c, a=a, bu=b, device="cpu")
    with pytest.raises(ValueError, match=r"\.a contains"):
        LPProblem.make(c=np.ones((1, 2)), a=np.full((1, 2, 2), np.inf), bu=b, device="cpu")
    # Inf in bounds is legal ("no bound").
    LPProblem.make(c=np.ones((1, 2)), a=a, bu=np.full((1, 2), np.inf), device="cpu")
    p = LPProblem.make(c=c, a=a, bu=b, validate=False, device="cpu")
    assert p.batch == 1


def test_canonicalize_shared_rejects_poisoned_input():
    c = np.ones((2, 2))
    c[1, 0] = np.nan
    a = np.broadcast_to(np.eye(2), (2, 2, 2)).copy()
    p = LPProblem.make(c=c, a=a, bu=np.ones((2, 2)), validate=False, device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        canonicalize_shared(p)


# -- delays, determinism, speculation ------------------------------------


def test_delay_injection_counts():
    with chaos.inject(chaos.ChaosMonkey(delay_s=0.005)) as mk:
        dispatch.solve_canonical(_batch(), repro_torch.SolveOptions())
    assert mk.delays_injected >= 1


def test_chaos_schedule_is_deterministic():
    batch = _batch()
    opts = repro_torch.SolveOptions(retry_budget=8, retry_backoff=0.0, **RESUME)

    def run():
        stats = repro_torch.SolveStats()
        mk = chaos.ChaosMonkey(seed=7, error_rate=1.0, max_faults=3)
        with chaos.inject(mk):
            sol = dispatch.solve_canonical(batch, opts, stats=stats)
        return sol, mk, stats

    sol_a, mk_a, st_a = run()
    sol_b, mk_b, st_b = run()
    assert mk_a.faults_injected == mk_b.faults_injected == 3
    assert mk_a.rounds_seen == mk_b.rounds_seen
    assert st_a.retries == st_b.retries
    assert_identical(sol_a, sol_b)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_schedule_equals_the_reference(seed):
    """The same configuration raises, crashes and poisons the same rounds,
    chunks and rows as the reference's monkey, fault for fault."""
    kw = dict(seed=seed, error_rate=0.3, crash_rate=0.4, poison_rate=0.25, max_faults=12,
              fail_rounds=(2,), crash_rounds=(5,), poison_rows={1: (0, 3)})
    mk, jmk = chaos.ChaosMonkey(**kw), jchaos.ChaosMonkey(**kw)
    rows = 6
    state = tlp.ResumeState(torch.zeros((rows, 3, 4)), torch.zeros((rows, 2), dtype=torch.int32),
                            torch.ones((rows,), dtype=torch.int32))
    jstate = jlp.ResumeState(jnp.zeros((rows, 3, 4), jnp.float32),
                             jnp.zeros((rows, 2), jnp.int32), jnp.ones((rows,), jnp.int32))

    def trace(monkey, st, errors):
        events = []
        for _ in range(24):
            try:
                r = monkey.on_round("cuda")
            except errors as exc:
                events.append(("round", type(exc).__name__))
                continue
            for k in range(4):
                try:
                    monkey.on_chunk(r, k)
                except errors as exc:
                    events.append(("chunk", r, k, type(exc).__name__))
                    break
            out, n = monkey.poison_state(r, st)
            nan = np.isnan(np.asarray(out.tab).reshape(rows, -1)).all(axis=1)
            events.append(("poison", r, n, np.nonzero(nan)[0].tolist()))
        return events

    ours = trace(mk, state, chaos.ChaosError)
    theirs = trace(jmk, jstate, jchaos.ChaosError)
    assert ours == theirs
    assert (mk.faults_injected, mk.rows_poisoned) == (jmk.faults_injected, jmk.rows_poisoned)
    assert mk.faults_injected == 12  # the schedule really fires


def test_inject_restores_previous_monkey():
    assert chaos.active() is None
    with chaos.inject(chaos.ChaosMonkey()) as mk:
        assert chaos.active() is mk
    assert chaos.active() is None


def test_speculative_chunks_bit_identical():
    batch = _batch(bsz=8)
    opts = repro_torch.SolveOptions(chunk_size=2)
    ref = dispatch.solve_canonical(batch, opts)
    sol = dispatch.solve_canonical(batch, opts.replace(speculation=True))
    assert_identical(ref, sol)
    # ... and under an injected per-round delay (the straggler case).
    with chaos.inject(chaos.ChaosMonkey(delay_s=0.002)):
        slow = dispatch.solve_canonical(batch, opts.replace(speculation=True))
    assert_identical(ref, slow)
    jsol = jdispatch.solve_canonical(_ref_batch(bsz=8), _ref_opts(chunk_size=2, speculation=True))
    assert_parity(sol, jsol)


def test_options_validate_robustness_knobs():
    with pytest.raises(ValueError):
        repro_torch.SolveOptions(retry_budget=-1)
    with pytest.raises(ValueError):
        repro_torch.SolveOptions(retry_backoff=-0.5)
    opts = repro_torch.SolveOptions()
    assert (opts.retry_budget, opts.retry_backoff, opts.speculation) == (2, 0.05, False)


# -- port-only: the certificate confirmation on host threads ---------------


def _flagged_fixture():
    """6 LPs of 100x100 and a solution flagging every row: rows 0 and 1
    unbounded by construction, 4 and 5 infeasible, 2 and 3 bounded (their
    flags must be revoked, as must row 5's UNBOUNDED)."""
    rng = np.random.default_rng(3)
    m = n = 100
    a = rng.standard_normal((6, m, n)).astype(np.float32)
    b = (np.abs(rng.standard_normal((6, m))) + 0.5).astype(np.float32)
    c = rng.standard_normal((6, n)).astype(np.float32)
    for i in (0, 1):
        d = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        a[i] -= np.outer(a[i] @ d + 0.1, d / (d @ d))
        c[i] = np.abs(c[i])
    for i in (4, 5):
        a[i] = 0.0
        b[i] = 1.0
        a[i, 0, 0], a[i, 1, 0], b[i, 1] = 1.0, -1.0, -3.0
    flags = np.array([tlp.UNBOUNDED, tlp.UNBOUNDED, tlp.UNBOUNDED, tlp.INFEASIBLE,
                      tlp.INFEASIBLE, tlp.UNBOUNDED], np.int32)
    return a, b, c, flags


def test_parallel_confirmation_equals_sequential_and_reference(monkeypatch):
    from repro.core import pdhg as jpdhg
    from repro_torch.core import oracle, pdhg

    a, b, c, flags = _flagged_fixture()
    batch = tlp.LPBatch.from_numpy(a, b, c, device="cpu")

    def solution(status):
        return tlp.LPSolution(objective=torch.zeros(6), x=torch.zeros((6, 100)),
                              status=torch.as_tensor(status), iterations=torch.zeros(6, dtype=torch.int32))

    confirmed = {}
    for workers in (1, 4):
        monkeypatch.setattr(pdhg, "confirm_workers", lambda rows, w=workers: min(w, rows))
        confirmed[workers] = pdhg.confirm_certificates(batch, solution(flags)).status.numpy()
    jsol = jlp.LPSolution(objective=np.zeros(6, np.float32), x=np.zeros((6, 100), np.float32),
                          status=jnp.asarray(flags), iterations=jnp.zeros(6, jnp.int32))
    ref = np.asarray(jpdhg.confirm_certificates(jlp.LPBatch(a, b, c), jsol).status)
    assert np.array_equal(confirmed[1], confirmed[4])
    assert np.array_equal(confirmed[4], ref)
    assert confirmed[4].tolist() == [tlp.UNBOUNDED, tlp.UNBOUNDED, tlp.ITER_LIMIT,
                                     tlp.ITER_LIMIT, tlp.INFEASIBLE, tlp.ITER_LIMIT]
    a64, b64, c64 = (v.astype(np.float64) for v in (a, b, c))
    assert np.array_equal(pdhg.oracle_statuses(a64, b64, c64, 400, workers=3),
                          oracle.solve_batch(a64, b64, c64, max_iters=400)[2])
    assert pdhg.confirm_workers(1) == 1


def test_fault_counters_hold_under_threads():
    """The speculative chunks call ``on_chunk`` from worker threads: with a
    switch interval of a microsecond, 16 threads crashing 400 chunks each
    must count every raised fault once, and stop exactly at ``max_faults``."""
    import sys
    import threading

    mk = chaos.ChaosMonkey(crash_rate=1.0, max_faults=5000)
    raised = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def crash_all():
        n = 0
        for k in range(1, 401):
            try:
                mk.on_chunk(0, k)
            except chaos.ShardCrash:
                n += 1
        raised.append(n)

    try:
        threads = [threading.Thread(target=crash_all) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sum(raised) == mk.faults_injected == 5000
