"""Shared-A batches in the port: containers, canonicalization, bucketing, routing.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``); solutions are compared with the tolerances of
``tests/test_torch_simplex.py``.
"""

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import lp as jlp
from repro.core.problem import canonicalize_shared as jcanonicalize_shared
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import lp as tlp
from repro_torch.core.backends import SHARED_BACKENDS, SolveOptions, SolveStats
from repro_torch.core.bucketing import bucket_shared_batches, scatter_shared_solutions
from repro_torch.core.problem import canonicalize
from repro_torch.kernels import revised_cuda

from test_torch_simplex import assert_matches_reference

JAX_SHARED = repro.SolveOptions(backend="xla-shared", autotune="off")


def _shared(seed, batch, m, n, feasible, dtype=np.float32):
    jb = jlp.random_shared_lp_batch(np.random.default_rng(seed), batch, m, n, feasible,
                                    dtype=dtype)
    tb = tlp.random_shared_lp_batch(np.random.default_rng(seed), batch, m, n, feasible,
                                    dtype=dtype, device="cpu")
    return jb, tb


@pytest.mark.parametrize("feasible,m,n", [(True, 9, 7), (False, 14, 5)])
def test_random_shared_lp_batch_matches_reference(feasible, m, n):
    jb, tb = _shared(3, 6, m, n, feasible)
    for f in ("a", "b", "c"):
        assert np.array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    assert (tb.batch, tb.m, tb.n) == (6, m, n)
    with pytest.raises(ValueError, match="m >= 2n"):
        tlp.random_shared_lp_batch(np.random.default_rng(0), 2, 5, 5, False, device="cpu")


def test_take_and_densify():
    _, tb = _shared(5, 7, 6, 4, True)
    tb = tlp.SharedLPBatch(tb.a, tb.b, tb.c, basis0=torch.arange(42, dtype=torch.int32)
                           .reshape(7, 6))
    sub = tb.take(slice(2, 5))
    assert sub.a is tb.a  # the shared A is never copied
    assert torch.equal(sub.b, tb.b[2:5]) and torch.equal(sub.basis0, tb.basis0[2:5])
    idx = torch.tensor([6, 0])
    assert torch.equal(tb.take(idx).c, tb.c[idx])
    dense = tb.densify()
    assert tuple(dense.a.shape) == (7, 6, 4) and dense.a.stride()[0] == 0
    assert torch.equal(dense.a[3], tb.a)
    assert tb.astype(torch.float64).b.dtype == torch.float64


def test_canonicalize_shared_accepts_and_rejects():
    rng = np.random.default_rng(71)
    a0 = rng.normal(size=(4, 5)).astype(np.float32)
    bu = rng.uniform(0.5, 2.0, size=(6, 4)).astype(np.float32)
    c = rng.normal(size=(6, 5)).astype(np.float32)
    a = np.broadcast_to(a0, (6, 4, 5))
    canon = repro_torch.canonicalize_shared(repro_torch.LPProblem.make(c, a, bu=bu, device="cpu"))
    assert isinstance(canon.batch, tlp.SharedLPBatch)
    ref = jcanonicalize_shared(repro.LPProblem.make(c=c, a=a, bu=bu))
    for f in ("a", "b", "c"):
        assert np.array_equal(getattr(canon.batch, f).numpy(), np.asarray(getattr(ref.batch, f)))
    dense = canonicalize(repro_torch.LPProblem.make(c, a, bu=bu, device="cpu")).batch
    assert torch.equal(canon.batch.densify().a, dense.a)

    a_bad = a.copy()
    a_bad[2, 1, 1] += 1.0
    with pytest.raises(ValueError, match="differ across the batch"):
        repro_torch.canonicalize_shared(repro_torch.LPProblem.make(c, a_bad, bu=bu,
                                                                   device="cpu"))
    a_inf = a.copy()
    a_inf[:, 0, 0] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        repro_torch.canonicalize_shared(repro_torch.LPProblem.make(c, a_inf, bu=bu, device="cpu",
                                                                   validate=False))
    c_nan = c.copy()
    c_nan[1, 2] = np.nan
    with pytest.raises(ValueError, match="b/c contain NaN"):
        repro_torch.canonicalize_shared(repro_torch.LPProblem.make(c_nan, a, bu=bu, device="cpu",
                                                                   validate=False))


def test_bucket_shared_batches_merges_only_equal_a():
    _, sb1 = _shared(81, 5, 6, 5, True)
    sb2 = tlp.SharedLPBatch(sb1.a.clone(), sb1.b[:3] + 1.0, sb1.c[:3])  # equal A, new tensor
    other = tlp.SharedLPBatch(sb1.a * 2.0, sb1.b, sb1.c)  # same shape, another A
    _, small = _shared(82, 4, 3, 3, True)
    inputs = [sb1, sb2, other, small]
    buckets = bucket_shared_batches(inputs)
    assert len(buckets) == 3
    merged = next(bk for bk in buckets if 0 in bk.indices)
    assert merged.indices == (0, 1) and merged.sizes == (5, 3)
    assert merged.batch.batch == 8 and merged.batch.a is sb1.a
    opts = SolveOptions(backend="torch-shared")
    sols = [tdispatch.solve_canonical(bk.batch, opts) for bk in buckets]
    back = scatter_shared_solutions(buckets, sols, len(inputs))
    for inp, got in zip(inputs, back):
        ref = tdispatch.solve_canonical(inp, opts)
        for f in ("objective", "x", "status", "iterations", "basis"):
            assert torch.equal(getattr(got, f), getattr(ref, f))
    with pytest.raises(TypeError, match="SharedLPBatch"):
        bucket_shared_batches([sb1, sb1.densify()])


def test_shared_routing():
    assert tdispatch.resolve_backend(SolveOptions(), shared=True).backend == "cuda-shared"
    assert tdispatch.resolve_backend(SolveOptions(backend="torch"), True).backend == "torch-shared"
    assert tdispatch.resolve_backend(SolveOptions(backend="reference"), True).backend == "reference"
    assert tdispatch.resolve_backend(SolveOptions(), shared=False).backend == "cuda"
    assert SHARED_BACKENDS == ("torch-shared", "cuda-shared")
    jb, tb = _shared(91, 4, 5, 5, True)
    with pytest.raises(ValueError, match="consumes SharedLPBatch"):
        repro_torch.solve(tb.densify(), SolveOptions(backend="cuda-shared"))
    # reference densifies: the float64 oracle's answers, as in the reference package.
    sol_t = repro_torch.solve(tb, SolveOptions(backend="reference"))
    sol_j = repro.solve(jb, repro.SolveOptions(backend="reference", autotune="off"))
    for f in ("objective", "status", "iterations"):
        assert np.array_equal(getattr(sol_t, f).numpy(), np.asarray(getattr(sol_j, f)))


def test_default_options_reach_the_revised_kernel_wrapper(monkeypatch):
    _, tb = _shared(93, 6, 8, 4, True)
    calls = []
    real = revised_cuda.revised

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(revised_cuda, "revised", spy)
    sol = repro_torch.solve(tb)
    assert calls == [torch.Size([8, 4])]
    plain = repro_torch.solve(tb, SolveOptions(backend="torch"))
    for f in ("objective", "x", "status", "iterations", "basis"):
        assert torch.equal(getattr(sol, f), getattr(plain, f))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("feasible,m,n", [(True, 12, 9), (False, 16, 6)])
def test_solve_shared_matches_reference(backend, feasible, m, n):
    jb, tb = _shared(100 + m, 10, m, n, feasible)
    sol_j = repro.solve(jb, JAX_SHARED)
    stats = SolveStats()
    sol_t = repro_torch.solve(tb, SolveOptions(backend=backend, chunk_size=4), stats=stats)
    assert_matches_reference(sol_t, sol_j, np.float32)
    assert (stats.lps, stats.rounds) == (10, 3)
    assert stats.tableau_bytes == 4 * ((m * m + m) * 4 + (m + 1) * 4)
    assert stats.simplex_iterations == int(np.asarray(sol_j.iterations).sum())


def test_empty_shared_batch():
    _, tb = _shared(1, 3, 4, 4, True)
    sol = repro_torch.solve(tb.take(slice(0, 0)))
    assert tuple(sol.x.shape) == (0, 4)
