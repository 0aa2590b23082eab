"""The port's cost-model autotuner against ``tests/test_autotune.py``.

Case for case: the knobs and their validation, ``"predict"`` against the
static routing table (a grid around the frontier, dense and shared
batches, float32 and float64, on CPU tensors and for the card), pure
and memoized prediction, pins, the ``pdhg`` reset, the stats, results
bit-equal to ``autotune="off"``, the frontier as a constraint, the cost
model, trials, the winner cache and its lifecycle, and ``warm``; plus
two parity cases against ``repro`` on the same shapes (the layout the
tuner picks, the keys of an ``autotune_log`` row).

The reference's ``cached_tile_b`` cases and its "pallas is infeasible
off the TPU" cases have no counterpart: the port has no tile knob and
every candidate runs (the kernels' second variants take the shapes past
the shared-memory budget).  Its bounded warn-once table belongs to the
``pallas`` VMEM fallback, which the port does not have.  Everything runs
on CPU tensors, where the trials time the kernels' plain versions.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import dispatch as jdispatch
from repro_torch import SolveOptions, SolveStats
from repro_torch.core import backends, dispatch, engine, lp
from repro_torch.core.session import SolveSession
from repro_torch.core.tableau import DEFAULT_LAYOUT
from repro_torch.kernels import build, cluster, simplex_cuda
from repro_torch.runtime import autotune

F32, F64 = torch.float32, torch.float64
CPU = "cpu"


@pytest.fixture(autouse=True)
def isolated_tuner(tmp_path, monkeypatch):
    """Every test gets a private tuner and cache file (never ~/.cache)."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    autotune.reset(cache_path=path)
    yield path
    autotune._TUNER = None  # later modules rebuild against the real env


def _resolve(m, n, opts, dtype=F32, batch=8, shared=False, device=CPU, stats=None):
    return dispatch.resolve_backend(opts, shared=shared, shape=(m, n), dtype=dtype,
                                    batch=batch, stats=stats, device=device)


# -- knobs and validation ----------------------------------------------------


def test_default_options_leave_tuner_knobs_open():
    opts = SolveOptions()
    assert opts.autotune == "predict"
    assert opts.layout is None
    assert opts.effective_layout == DEFAULT_LAYOUT
    assert repro_torch.autotune is autotune


def test_option_validation():
    with pytest.raises(ValueError, match="autotune"):
        SolveOptions(autotune="sometimes")
    with pytest.raises(ValueError):
        SolveOptions(backend="pdhg", layout="dense")
    SolveOptions(backend="pdhg", layout=None)
    for mode in backends.AUTOTUNE_MODES:
        assert SolveOptions(autotune=mode).autotune == mode
    assert backends.AUTOTUNE_MODES == autotune.MODES


# -- predict mode ------------------------------------------------------------

GRID = [(5, 5), (28, 28), (100, 80), (200, 100), (234, 100), (235, 100), (499, 499),
        (500, 500), (700, 20), (20, 700)]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("shared", [False, True], ids=["dense", "shared"])
@pytest.mark.parametrize("m,n", GRID)
def test_predict_reproduces_static_routing(m, n, shared, dtype):
    # On CPU tensors and for the card (device None), for "auto" and the pins.
    for device in (CPU, None):
        for backend in ("auto", "cuda", "torch"):
            for batch in (1, 8, 50_000):
                tuned = _resolve(m, n, SolveOptions(backend=backend), dtype, batch, shared,
                                 device)
                static = _resolve(m, n, SolveOptions(backend=backend, autotune="off"),
                                  dtype, batch, shared, device)
                assert tuned.backend == static.backend, (device, backend, batch)
                assert tuned.effective_layout == static.effective_layout


def test_predict_is_pure_and_memoized(isolated_tuner, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("prediction must not build or load a kernel")

    monkeypatch.setattr(build, "compile_source", no_build)
    monkeypatch.setattr(build, "load", no_build)
    tuner = autotune.get_tuner()
    opts = SolveOptions(backend="auto")
    first = tuner.get(20, 10, F32, opts, batch=8)
    second = tuner.get(20, 10, F32, opts, batch=8)
    assert second is first  # memo hit
    assert tuner.trials_run == 0
    assert not os.path.exists(isolated_tuner)  # prediction never touches disk
    assert first.source == "predicted"
    assert first.predicted_s > 0


def test_predict_resolution_fills_only_open_knobs():
    opts = SolveOptions(backend="torch", layout="dense")
    resolved = _resolve(12, 8, opts)
    assert (resolved.backend, resolved.layout) == ("torch", "dense")
    filled = _resolve(12, 8, SolveOptions(backend="torch"))
    assert (filled.backend, filled.layout) == ("torch", DEFAULT_LAYOUT)
    assert _resolve(12, 8, SolveOptions(backend="auto", layout="dense")).layout == "dense"


def test_predict_routes_pdhg_with_reset_rule_and_layout():
    resolved = _resolve(600, 600, SolveOptions(backend="auto", rule="rpc", layout="dense"),
                        batch=4)
    assert resolved.backend == "pdhg"
    assert resolved.layout is None
    assert resolved.rule == engine.LPC
    # The simplex leg drops crossover (it polishes first-order answers only).
    small = _resolve(20, 20, SolveOptions(backend="auto", crossover=True))
    assert (small.backend, small.crossover) == ("cuda", False)
    big = _resolve(600, 600, SolveOptions(backend="auto", crossover=True))
    assert (big.backend, big.crossover) == ("pdhg", True)


def test_stats_record_autotuned_decision():
    stats = SolveStats()
    _resolve(12, 8, SolveOptions(backend="auto"), stats=stats)
    assert stats.autotuned == 1
    (row,) = stats.autotune_log
    assert row["m"] == 12 and row["n"] == 8 and row["batch"] == 8
    assert row["source"] == "predicted"
    assert row["backend"] in autotune.TUNABLE_BACKENDS
    assert row["tile_b"] is None and row["measured_s"] is None
    assert row["dtype"] == "float32" and row["shared"] is False


def test_off_books_nothing_and_shapeless_resolution_is_static():
    stats = SolveStats()
    _resolve(12, 8, SolveOptions(backend="auto", autotune="off"), stats=stats)
    assert stats.autotuned == 0 and stats.autotune_log == []
    assert dispatch.resolve_backend(SolveOptions(), shared=True).backend == "cuda-shared"


@pytest.mark.parametrize("kind", ["batch", "problems", "shared"])
def test_solve_results_identical_predict_vs_off(kind):
    rng = np.random.default_rng(7)
    if kind == "batch":
        problem = lp.random_lp_batch(rng, 8, 6, 5, feasible_start=True, device=CPU)
    elif kind == "shared":
        problem = lp.random_shared_lp_batch(rng, 8, 6, 5, device=CPU)
    else:
        from repro_torch.serve.loadgen import lp_request_mix

        make = lp_request_mix([(4, 6), (6, 4)], seed=3, device=CPU)
        problem = [make(i) for i in range(6)]
    stats = SolveStats()
    tuned = repro_torch.solve(problem, SolveOptions(), stats=stats)
    static = repro_torch.solve(problem, SolveOptions(autotune="off"))
    for t, s in zip(tuned if kind == "problems" else [tuned],
                    static if kind == "problems" else [static]):
        for f in ("objective", "x", "status", "iterations"):
            assert torch.equal(getattr(t, f), getattr(s, f)), f
    assert stats.autotuned == (2 if kind == "problems" else 1)  # one per bucket


def test_route_shape_tuner_leg_equals_the_table():
    for m, n in GRID:
        opts = SolveOptions()
        assert backends.route_shape(m, n, opts) == backends.route_shape(m, n)
        assert backends.route_shape(m, n, opts, shared=True) == "cuda-shared"
    lifted = SolveOptions(route_frontier=8)
    assert backends.route_shape(12, 6, lifted) == "pdhg" == backends.route_shape(
        12, 6, lifted.replace(autotune="off"))


def test_session_resolution_keys_the_batch_class_and_books_its_stats():
    sess = SolveSession(SolveOptions(backend="auto"), device=CPU)
    first = sess.resolve_options(12, 6, F32, batch=5)
    assert sess.resolve_options(12, 6, F32, batch=7) is first  # next_pow2: 8
    other = sess.resolve_options(12, 6, F32, batch=9)
    assert other is not first and other == first
    assert sess.stats.autotuned == 2
    assert [r["batch"] for r in sess.stats.autotune_log] == [5, 9]


def test_concurrent_resolution_from_threads():
    opts = SolveOptions(backend="auto")
    out, errors = [], []

    def work():
        try:
            out.append(autotune.get_tuner().get(30, 20, F32, opts, batch=64, device=CPU))
        except Exception as exc:  # pragma: no cover - the failure being tested
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(out) == 8 and all(c is out[0] for c in out)


# -- candidate enumeration and the cost model ---------------------------------


def test_frontier_is_a_constraint_not_a_knob():
    auto = SolveOptions(backend="auto")
    above = autotune.candidate_configs(600, 600, auto)
    assert {name for name, _ in above} == {"pdhg"}
    lifted = autotune.candidate_configs(600, 600, auto.replace(route_frontier=10_000))
    assert {name for name, _ in lifted} == {"cuda", "torch"}
    assert autotune.feasible("pdhg", None, 600, 600, auto)
    assert not autotune.feasible("cuda", "compact", 600, 600, auto)


def test_non_tunable_backend_passes_through():
    cands = autotune.candidate_configs(12, 8, SolveOptions(backend="reference"))
    assert cands == [("reference", None)]
    resolved = _resolve(12, 8, SolveOptions(backend="reference"))
    assert resolved.backend == "reference" and resolved.layout is None


def test_candidates_of_each_family():
    auto = SolveOptions(backend="auto")
    assert autotune.candidate_configs(12, 8, auto) == [
        ("cuda", "dense"), ("cuda", "compact"), ("torch", "dense"), ("torch", "compact")]
    assert autotune.candidate_configs(12, 8, auto, shared=True) == [
        ("cuda-shared", None), ("torch-shared", None)]
    assert autotune.candidate_configs(12, 8, auto.replace(layout="dense")) == [
        ("cuda", "dense"), ("torch", "dense")]


def test_predict_cost_sanity():
    card = dict(device=None)
    # compact tableau moves fewer bytes per iteration than dense
    assert (autotune.predict_cost("cuda", "compact", 64, 48, 256, F32, **card)
            < autotune.predict_cost("cuda", "dense", 64, 48, 256, F32, **card))
    # the resident (cluster) variant streams its state once per solve: it
    # ranks below the global variant of the same shape (max_k=0 forces it)
    assert autotune.resident("cuda", "compact", 100, 100, F32)
    assert not autotune.resident("cuda", "compact", 100, 100, F32, max_k=0)
    assert (autotune.predict_cost("cuda", "compact", 100, 100, 50_000, F32, **card)
            < autotune.predict_cost("cuda", "compact", 100, 100, 50_000, F32, **card,
                                    max_k=0))
    # the kernels beat their plain loops on the card ...
    for fam in (("cuda", "torch", "compact"), ("cuda-shared", "torch-shared", None)):
        kern, plain, lay = fam
        assert (autotune.predict_cost(kern, lay, 100, 100, 1024, F32, **card)
                < autotune.predict_cost(plain, lay, 100, 100, 1024, F32, **card))
        # ... and cost the same on CPU tensors, where they run them
        assert (autotune.predict_cost(kern, lay, 100, 100, 1024, F32, device=CPU)
                == autotune.predict_cost(plain, lay, 100, 100, 1024, F32, device=CPU))
    # float64 halves the tableau's intensity and the peak
    assert (autotune.predict_cost("cuda", "compact", 200, 100, 10_000, F64, **card)
            > autotune.predict_cost("cuda", "compact", 200, 100, 10_000, F32, **card))


def test_resident_follows_the_planners():
    assert autotune.resident("cuda", "compact", 200, 100, F32)  # k = 2
    assert not autotune.resident("cuda", "compact", 700, 700, F32)  # past 16 CTAs
    assert autotune.resident("pdhg", None, 500, 500, F32)
    assert autotune.resident("cuda-shared", None, 234, 100, F32)
    assert not autotune.resident("cuda-shared", None, 300, 100, F32)
    assert not autotune.resident("torch", "compact", 100, 100, F32)


def test_cpu_ties_go_to_the_kernel_backend():
    ranked = autotune.rank_candidates(12, 8, 64, F32, SolveOptions(backend="auto"),
                                      device=CPU)
    assert ranked[0].predicted_s == ranked[1].predicted_s
    assert [(c.backend, c.layout) for c in ranked[:2]] == [("cuda", "compact"),
                                                           ("torch", "compact")]
    card = autotune.rank_candidates(12, 8, 64, F32, SolveOptions(backend="auto"))
    assert card == sorted(card, key=lambda c: c.predicted_s)
    assert card[0].predicted_s < card[1].predicted_s


# -- trial mode and the winner cache ------------------------------------------


def test_trial_measures_persists_and_warm_process_hits(isolated_tuner):
    opts = SolveOptions(backend="auto", autotune="trial")
    tuner = autotune.get_tuner()
    first = tuner.get(6, 5, F32, opts, batch=4, device=CPU)
    assert first.source == "measured"
    assert first.measured_s > 0
    assert tuner.trials_run == 3  # the predicted top 3 were timed
    assert len(first.trials) == 3 and all(t[3] > 0 and t[2] > 0 for t in first.trials)
    with open(isolated_tuner) as f:
        data = json.load(f)
    assert data["schema"] == autotune.SCHEMA_VERSION
    key = autotune.cache_key(6, 5, 4, F32, device=CPU)
    assert data["entries"][key]["backend"] == first.backend

    # a "new process": fresh tuner, same cache file -> zero micro-trials
    warm = autotune.reset(cache_path=isolated_tuner)
    hit = warm.get(6, 5, F32, opts, batch=4, device=CPU)
    assert warm.trials_run == 0
    assert hit.source == "cache"
    assert (hit.backend, hit.layout) == (first.backend, first.layout)


def test_trial_solve_is_bit_equal_to_off():
    batch = lp.random_lp_batch(np.random.default_rng(1), 32, 10, 10, device=CPU)
    stats = SolveStats()
    tuned = repro_torch.solve(batch, SolveOptions(autotune="trial"), stats=stats)
    static = repro_torch.solve(batch, SolveOptions(autotune="off"))
    for f in ("objective", "x", "status", "iterations", "basis"):
        assert torch.equal(getattr(tuned, f), getattr(static, f)), f
    (row,) = stats.autotune_log
    assert row["source"] == "measured" and row["backend"] == "cuda"  # the pin holds
    assert stats.lps == 32  # the trials book nothing into the caller's stats


def test_a_kernel_error_in_a_trial_propagates(monkeypatch, isolated_tuner):
    def broken(*a, **k):
        raise build.KernelBuildError("nvcc failed for simplex.cu")

    monkeypatch.setattr(simplex_cuda, "simplex", broken)
    with pytest.raises(build.KernelBuildError):
        autotune.resolve(10, 10, F32, SolveOptions(autotune="trial"), batch=8, device=CPU)
    assert not os.path.exists(isolated_tuner)  # nothing ranked, nothing cached


def test_trial_single_candidate_skips_trials_but_still_caches(isolated_tuner):
    opts = SolveOptions(backend="auto", autotune="trial")
    tuner = autotune.get_tuner()
    choice = tuner.get(600, 600, F32, opts, batch=2, device=CPU)
    assert choice.backend == "pdhg"  # only candidate at this shape
    assert tuner.trials_run == 0  # nothing to compare against
    with open(isolated_tuner) as f:
        assert autotune.cache_key(600, 600, 2, F32, device=CPU) in json.load(f)["entries"]


def test_corrupt_cache_falls_back_and_heals(isolated_tuner):
    with open(isolated_tuner, "w") as f:
        f.write("{this is not json")
    tuner = autotune.reset(cache_path=isolated_tuner)
    opts = SolveOptions(backend="auto", autotune="trial")
    choice = tuner.get(600, 600, F32, opts, batch=2, device=CPU)  # must not crash
    assert choice.backend == "pdhg"
    with open(isolated_tuner) as f:
        assert json.load(f)["schema"] == autotune.SCHEMA_VERSION  # rewritten valid


def test_torn_write_reads_as_empty(isolated_tuner):
    cache = autotune.TuningCache(isolated_tuner)
    cache.store("k", {"backend": "cuda"})
    with open(isolated_tuner) as f:
        whole = f.read()
    with open(isolated_tuner, "w") as f:
        f.write(whole[: len(whole) // 2])  # simulate a torn write
    assert autotune.TuningCache(isolated_tuner).load() == {}


def test_schema_bump_invalidates_every_entry(isolated_tuner):
    cache = autotune.TuningCache(isolated_tuner)
    cache.store("k", {"backend": "cuda"})
    with open(isolated_tuner) as f:
        data = json.load(f)
    data["schema"] = autotune.SCHEMA_VERSION + 1
    with open(isolated_tuner, "w") as f:
        json.dump(data, f)
    assert autotune.TuningCache(isolated_tuner).load() == {}


def test_cache_key_carries_device_and_shape_classes():
    key = autotune.cache_key(6, 5, 12, F32, device=CPU)
    assert key.startswith("cpu|")
    assert f"smem{cluster.SMEM_LIMIT}" in key
    assert "|lp|" in key and "m8|" in key and "n8|" in key and "b16|" in key
    assert key.endswith("float32")
    assert autotune.cache_key(6, 5, 12, np.float64, device=CPU).endswith("float64")
    shared_key = autotune.cache_key(6, 5, 12, F32, shared=True, device=CPU)
    assert "|shared|" in shared_key and shared_key != key
    card_key = autotune.cache_key(6, 5, 12, F32)
    assert card_key.startswith(autotune.device_name(None) + "|") and card_key != key
    assert autotune.default_cache_path().endswith("autotune.json")


def test_cached_pin_violating_entry_is_ignored(isolated_tuner):
    key = autotune.cache_key(6, 5, 4, F32, device=CPU)
    autotune.TuningCache(isolated_tuner).store(key, {"backend": "cuda", "layout": "dense"})
    tuner = autotune.reset(cache_path=isolated_tuner)
    pinned = SolveOptions(backend="auto", layout="compact", autotune="trial")
    choice = tuner.get(6, 5, F32, pinned, batch=4, device=CPU)
    assert choice.layout == "compact"  # the cached dense winner must not win
    assert choice.source in ("measured", "predicted")


def test_cached_entry_across_the_frontier_is_ignored(isolated_tuner):
    # 499 and 500 share the size class m512/n512; a simplex winner cached
    # at 499 must not carry 500 across the frontier.
    key = autotune.cache_key(500, 500, 2, F32, device=CPU)
    assert key == autotune.cache_key(499, 499, 2, F32, device=CPU)
    autotune.TuningCache(isolated_tuner).store(key, {"backend": "cuda", "layout": "compact"})
    tuner = autotune.reset(cache_path=isolated_tuner)
    opts = SolveOptions(backend="auto", autotune="trial")
    assert tuner.get(500, 500, F32, opts, batch=2, device=CPU).backend == "pdhg"
    hit = tuner.get(499, 499, F32, opts.replace(autotune="predict"), batch=2, device=CPU)
    assert hit.backend == "cuda"


def test_warm_tunes_then_rewarm_is_free(isolated_tuner):
    (cfg,) = autotune.warm([(6, 5, 4)], device=CPU)
    assert cfg.backend in autotune.TUNABLE_BACKENDS
    fresh = autotune.reset(cache_path=isolated_tuner)
    (again,) = autotune.warm([(6, 5, 4)], device=CPU)
    assert fresh.trials_run == 0  # pure cache hit
    assert again.source == "cache"
    assert again.backend == cfg.backend


# -- parity with the reference --------------------------------------------------


@pytest.mark.parametrize("m,n", [(12, 8), (100, 80)])
def test_tuned_layout_and_log_keys_equal_the_reference(m, n):
    import jax.numpy as jnp

    jstats, tstats = repro.SolveStats(), SolveStats()
    ref = jdispatch.resolve_backend(m, n, jnp.float32, repro.SolveOptions(backend="auto"),
                                    batch=8, stats=jstats)
    port = _resolve(m, n, SolveOptions(backend="auto"), stats=tstats)
    assert port.effective_layout == ref.effective_layout
    assert set(tstats.autotune_log[0]) == set(jstats.autotune_log[0])
    assert (tstats.autotuned, jstats.autotuned) == (1, 1)
