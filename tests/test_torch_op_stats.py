"""The operation counter (``launch/op_stats.py``) and the tuner's use of it.

The counterpart of ``tests/test_hlo_stats.py`` for the port: exact
contraction flops, exact bytes with views free, counts that follow the
loop trips a function really runs, the cap differencing of
``runtime/autotune.py:op_profile`` on the plain loops, and the
``feature_source="ops"`` refinement of the plain candidates.  CPU only:
the counts do not depend on the device.
"""

import numpy as np
import pytest
import torch

from repro_torch import SolveOptions
from repro_torch.launch import op_stats
from repro_torch.runtime import autotune

F32 = torch.float32


@pytest.fixture(autouse=True)
def isolated_tuner(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    autotune.reset(cache_path=path)
    yield path
    autotune._TUNER = None


def test_dot_flops_of_bmm_mm_and_einsum_are_exact():
    a, b = torch.randn(2, 3, 4), torch.randn(2, 4, 5)
    assert op_stats.analyze(torch.bmm, a, b)["dot_flops"] == 2 * 2 * 3 * 5 * 4
    x, y = torch.randn(6, 7), torch.randn(7, 3)
    assert op_stats.analyze(torch.mm, x, y)["dot_flops"] == 2 * 6 * 3 * 7
    assert op_stats.analyze(torch.addmm, torch.zeros(6, 3), x, y)["dot_flops"] == 2 * 6 * 3 * 7
    # einsum lowers to a bmm with a trailing unit dimension
    m, v = torch.randn(3, 4, 5), torch.randn(3, 5)
    got = op_stats.analyze(torch.einsum, "bmn,bn->bm", m, v)
    assert got["dot_flops"] == 2 * 3 * 4 * 5 and got["ops"] == 1


def test_elementwise_bytes_are_exact_and_views_are_free():
    x, y = torch.randn(4, 8), torch.randn(8, 4)
    got = op_stats.analyze(lambda: x + y.t())
    assert got["traffic_bytes"] == 3 * 4 * 8 * 4  # two inputs read, one output written
    assert got["ops"] == 1 and got["dot_flops"] == 0
    views = op_stats.analyze(lambda: x.reshape(32)[None, :].expand(3, 32).t().unsqueeze(0))
    assert views["traffic_bytes"] == 0 and views["ops"] == 0
    # a broadcast (stride-0) input counts its distinct elements once
    w = torch.randn(3, 4, 8, dtype=torch.float64)
    got = op_stats.analyze(lambda: w * x.double()[None].expand(3, 4, 8))
    conv = 4 * 8 * (4 + 8)  # the float64 copy of x: read float32, write float64
    assert got["traffic_bytes"] == conv + 8 * (3 * 4 * 8 + 4 * 8 + 3 * 4 * 8)


@pytest.mark.parametrize("trips", [1, 2, 5])
def test_counts_scale_with_the_loop_trips(trips):
    w = torch.randn(16, 16)

    def f(x):
        for _ in range(trips):
            x = torch.tanh(x @ w)
        return x

    got = op_stats.analyze(f, w)
    assert got["dot_flops"] == trips * 2 * 16 ** 3
    assert got["ops"] == 2 * trips
    assert got["traffic_bytes"] == trips * (3 + 2) * 16 * 16 * 4


def test_a_function_that_runs_no_operation_is_safe():
    got = op_stats.analyze(lambda: None)
    assert got == {"dot_flops": 0.0, "traffic_bytes": 0.0, "ops": 0.0}


@pytest.mark.parametrize("shared", [False, True], ids=["tableau", "revised"])
def test_cap_differencing_isolates_one_iteration(shared):
    # 40x40 runs past 24 pivots on some LP, so both caps run every trip.
    wide = autotune.op_profile(40, 40, batch=4, caps=(8, 24), shared=shared)
    narrow = autotune.op_profile(40, 40, batch=4, caps=(4, 12), shared=shared)
    for key in ("ops_per_iter", "traffic_bytes_per_iter", "dot_flops_per_iter"):
        assert wide[key] == narrow[key], key
    assert wide["ops_per_iter"] == autotune.plain_ops_per_iter(
        "torch-shared" if shared else "torch", 40)
    assert wide["traffic_bytes_per_iter"] > 0 and wide["batch"] == 4.0
    assert wide["traffic_bytes"] > wide["traffic_bytes_per_iter"] * 24  # plus the setup


def test_plain_op_counts_follow_the_model_across_shapes():
    for m, n in ((28, 28), (60, 40)):
        assert autotune.op_profile(m, n, caps=(8, 16))["ops_per_iter"] == 77
        shared = autotune.op_profile(m, n, caps=(8, 16), shared=True)
        assert shared["ops_per_iter"] == autotune.plain_ops_per_iter("torch-shared", m)


def test_a_batch_that_finishes_before_the_cap_raises():
    with pytest.raises(ValueError, match="finished before cap"):
        autotune.op_profile(3, 2, batch=2, caps=(8, 24))


def test_ops_features_refine_the_plain_candidates():
    base = autotune.predict_cost("torch", "compact", 40, 40, 4, F32)
    heavy = autotune.predict_cost(
        "torch", "compact", 40, 40, 4, F32,
        features={"dot_flops_per_iter": 0.0, "traffic_bytes_per_iter": 1e9, "batch": 4})
    assert heavy > base
    feats = {"compact": autotune.op_profile(40, 40), "dense": autotune.op_profile(
        40, 40, layout="dense")}
    # the eager loop moves more than the fused kernel's analytic traffic
    analytic = autotune.rank_candidates(40, 40, 4, F32, SolveOptions(backend="auto"))
    counted = autotune.rank_candidates(40, 40, 4, F32, SolveOptions(backend="auto"),
                                       features=feats)
    by = {(c.backend, c.layout): c.predicted_s for c in analytic}
    for c in counted:
        if c.backend == "torch":
            assert c.predicted_s > by[(c.backend, c.layout)]
        else:
            assert c.predicted_s == by[(c.backend, c.layout)]  # kernels: unchanged
    assert counted[0].backend == "cuda"


def test_warm_with_ops_features_ranks_and_caches():
    (cfg,) = autotune.warm([(40, 40, 4)], ops=True, device="cpu")
    assert cfg.source == "measured" and autotune.get_tuner().feature_source == "analytic"
    with pytest.warns(UserWarning, match="analytic model"):
        (tiny,) = autotune.warm([(3, 2, 2)], ops=True, device="cpu")  # no counts
    assert tiny.source == "measured"


def test_shape_bytes_by_dtype_and_dims():
    assert op_stats._shape_bytes(torch.float32, (3, 4)) == 48
    assert op_stats._shape_bytes(torch.float64, ()) == 8
    assert op_stats._shape_bytes(torch.bfloat16, (0, 5)) == 0
    assert op_stats._tensor_bytes(torch.zeros(5, dtype=torch.int32)[:, None].expand(5, 7)) == 20
    assert np.isclose(op_stats.analyze(torch.zeros, 10)["traffic_bytes"], 40)
