"""Hypothesis property tests of the port, the twins of ``tests/test_property.py``.

Random float64 batches (numpy-seeded, so both packages see the same
data) go through the port's plain versions on the CPU: an OPTIMAL
simplex solution is feasible, consistent and no worse than a point of
the feasible set, with status, pivots and basis equal to ``repro``'s; the
hyperbox support keeps its invariants and agrees with ``repro``'s to
1e-12; a box's support equals its polytope's LP to 1e-6; and every
compaction mode, with either resume, equals ``compaction="off"`` bit for
bit.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed; skipping property tests")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro_torch  # noqa: E402
from repro.core import hyperbox as jhyperbox  # noqa: E402
from repro.core import lp as jlp  # noqa: E402
from repro.core import simplex as jsimplex  # noqa: E402
from repro_torch.core import hyperbox as thyperbox  # noqa: E402
from repro_torch.core import lp as tlp  # noqa: E402
from repro_torch.core import simplex as tsimplex  # noqa: E402
from repro_torch.core.support import Box, box_to_polytope, template_directions  # noqa: E402

import test_torch_simplex  # noqa: E402,F401  (one intra-op thread per test process)

SHAPES = dict(m=st.integers(2, 12), n=st.integers(2, 12), batch=st.integers(1, 8),
              seed=st.integers(0, 2**31 - 1))


def _pair(m, n, batch, seed, feasible=True):
    jb = jlp.random_lp_batch(np.random.default_rng(seed), batch, m, n, feasible,
                             dtype=np.float64)
    tb = tlp.random_lp_batch(np.random.default_rng(seed), batch, m, n, feasible,
                             dtype=np.float64, device="cpu")
    return jb, tb


@given(**SHAPES)
@settings(max_examples=25, deadline=None)
def test_simplex_solution_is_feasible_and_matches_the_reference(m, n, batch, seed):
    jb, tb = _pair(m, n, batch, seed)
    sol = tsimplex.solve_batched(tb.a, tb.b, tb.c)
    ref = jsimplex.solve_batched(jb.a, jb.b, jb.c)
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert np.array_equal(sol.iterations.numpy(), np.asarray(ref.iterations))
    assert np.array_equal(sol.basis.numpy(), np.asarray(ref.basis))
    a, b, c, x = (t.numpy() for t in (tb.a, tb.b, tb.c, sol.x))
    for i in range(batch):
        if int(sol.status[i]) != tlp.OPTIMAL:
            continue
        assert (a[i] @ x[i] <= b[i] + 1e-7).all()
        assert (x[i] >= -1e-9).all()
        np.testing.assert_allclose(c[i] @ x[i], float(sol.objective[i]), rtol=1e-8)
        assert c[i] @ (0.5 * x[i]) <= float(sol.objective[i]) + 1e-7


@given(st.integers(1, 6), st.integers(2, 30), st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_hyperbox_support_invariants(batch, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi, d = (torch.from_numpy(np.asarray(v)) for v in
                 jlp.random_hyperbox_batch(rng, batch, n, dtype=np.float64))
    sup, pick = thyperbox.argsupport(lo, hi, d)
    # XLA contracts the reference's sum into FMAs: the bits may differ.
    np.testing.assert_allclose(sup.numpy(), np.asarray(jhyperbox.support(
        lo.numpy(), hi.numpy(), d.numpy())), rtol=1e-12, atol=1e-12)
    assert bool((pick >= lo - 1e-12).all() and (pick <= hi + 1e-12).all())
    for _ in range(5):
        z = torch.where(torch.from_numpy(rng.random(tuple(lo.shape)) < 0.5), lo, hi)
        assert bool(((d * z).sum(-1) <= sup + 1e-9).all())
    np.testing.assert_allclose(thyperbox.support(lo, hi, 2.5 * d).numpy(), 2.5 * sup.numpy(),
                               rtol=1e-10)
    d2 = torch.from_numpy(rng.normal(size=tuple(d.shape)))
    lhs = thyperbox.support(lo, hi, d + d2)
    assert bool((lhs <= sup + thyperbox.support(lo, hi, d2) + 1e-9).all())


@given(st.integers(2, 8), st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_box_support_equals_polytope_lp(dim, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2, 0, dim)
    hi = lo + rng.uniform(0.5, 2, dim)
    box = Box(lo, hi)
    dirs = template_directions(dim, "oct").astype(np.float64)
    s_box = box.support(dirs, device="cpu").numpy()
    s_lp = box_to_polytope(box).support(dirs, device="cpu").numpy()
    np.testing.assert_allclose(s_box, s_lp, rtol=1e-6, atol=1e-6)


@given(m=st.integers(4, 12), n=st.integers(2, 6), batch=st.integers(1, 12),
       seed=st.integers(0, 2**31 - 1), mode=st.sampled_from(["chunked", "every_k"]),
       resume=st.sampled_from(["scratch", "basis"]), k=st.integers(1, 20),
       rule=st.sampled_from(["lpc", "bland"]))
@settings(max_examples=30, deadline=None)
def test_compaction_equals_off(m, n, batch, seed, mode, resume, k, rule):
    # An infeasible start where the shape allows one (phase I, skewed pivots).
    _, tb = _pair(m, n, batch, seed, feasible=m < 2 * n)
    off = repro_torch.solve(tb, repro_torch.SolveOptions(rule=rule))
    sol = repro_torch.solve(tb, repro_torch.SolveOptions(
        rule=rule, compaction=mode, resume=resume, compact_every=k))
    for f in ("status", "objective", "x", "iterations", "basis"):
        assert torch.equal(getattr(sol, f), getattr(off, f)), f


# ---------------------------------------------------------------------------
# the operation counter (launch/op_stats.py), the twins of the HLO cases
# ---------------------------------------------------------------------------


@given(
    st.sampled_from([torch.float32, torch.bfloat16, torch.int32, torch.float64]),
    st.lists(st.integers(1, 64), min_size=0, max_size=4),
)
@settings(max_examples=50, deadline=None)
def test_op_stats_shape_bytes(dtype, dims):
    from repro_torch.launch import op_stats

    nbytes = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4, torch.float64: 8}[dtype]
    expect = nbytes * int(np.prod(dims)) if dims else nbytes
    assert op_stats._shape_bytes(dtype, dims) == expect
    # an elementwise operation moves its input and its output, once each
    x = torch.zeros(dims, dtype=dtype)
    assert op_stats.analyze(torch.neg, x)["traffic_bytes"] == 2 * expect


def test_op_stats_loop_aware_flops_exact():
    """Nested loops of products: the counter sees every trip (5 x 3)."""
    from repro_torch.launch import op_stats

    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    w = torch.randn(64, 64)
    got = op_stats.analyze(f, w, w)
    expect = 15 * 2 * 64 ** 3  # 5 x 3 matmuls
    assert abs(got["dot_flops"] - expect) / expect < 1e-6, got["dot_flops"]
