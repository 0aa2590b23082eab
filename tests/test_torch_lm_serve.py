"""The port's LM ``Engine`` against the reference ``repro.serve.engine.Engine``
(jitted), greedy, on reduced configs; the reference fixture's comparison
as ``chip_smoke.py`` makes it on the card; the committed fixture.

Both packages take the same NumPy weights (``models/convert.py``).
float32; the logits fed the reference's tokens agree at every step within
the parity tolerance of ``tests/test_torch_models.py`` (relative L2 1e-5,
max abs 2e-5 times the logits' largest magnitude), and the tokens are
equal wherever the reference's top-2 margin exceeds 10 times that abs
tolerance (past a smaller margin the two may pick different tokens, and
the continuations then part).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import Model as RModel
from repro.serve.engine import Engine as REngine
from repro_torch import configs
from repro_torch.models import Model
from repro_torch.models.convert import (compare_to_summary, load_reference_params,
                                        reference_weights, vocab_subset, weights_digest)
from repro_torch.serve.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "lm_gemma2_2b_reference.npz"
MOE_FIXTURE = ROOT / "tests" / "data" / "lm_deepseek_v2_lite_reference.npz"
RTOL, ATOL = 1e-5, 2e-5
BATCH, PROMPT, STEPS = 2, 20, 10


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(arch, seed=7, **kw):
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), **kw)
    tree = reference_weights(cfg, seed)
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    rcfg = dataclasses.replace(rconfigs.get_config(arch, reduced=True), **kw)
    rmodel = RModel(rcfg)
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    prompts = np.array(rconfigs.make_inputs(rcfg, rconfigs.Shape("t", PROMPT, BATCH, "prefill"),
                                            seed=3)["tokens"])
    return model, rmodel, rparams, prompts


def _reference_logits(rmodel, rparams, tokens, prompt, steps):
    """The reference's logits (B, steps, V) fed ``tokens``: prefill, then
    one decode step a token."""
    cache = rmodel.init_cache(tokens.shape[0], prompt + steps)
    lg, cache = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(tokens[:, :prompt])},
                                        cache)
    rows = [np.asarray(lg[:, -1])]
    decode = jax.jit(rmodel.decode_step)
    for i in range(steps - 1):
        lg, cache = decode(rparams, {"tokens": jnp.asarray(tokens[:, prompt + i:prompt + i + 1])},
                           cache, prompt + i)
        rows.append(np.asarray(lg[:, -1]))
    return np.stack(rows, axis=1)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-4b"])
def test_generate_matches_the_reference_engine(arch):
    _generate_parity(*_setup(arch))


@pytest.mark.parametrize("router", ["topk", "lp"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-lite-16b"])
def test_moe_generate_matches_the_reference_engine(arch, router):
    """The MoE family under both routers: under ``lp`` each prefill and
    decode step solves one router LP a MoE layer on both sides."""
    _generate_parity(*_setup(arch, router=router))


def _generate_parity(model, rmodel, rparams, prompts):
    arch = model.cfg.name
    want = np.asarray(REngine(rmodel, rparams, max_len=PROMPT + STEPS).generate(
        {"tokens": jnp.asarray(prompts)}, steps=STEPS))
    engine = Engine(model, max_len=PROMPT + STEPS, device="cpu")
    got = engine.generate({"tokens": prompts}, steps=STEPS)
    assert got.dtype == torch.int32 and got.shape == (BATCH, STEPS)
    got = got.numpy()

    # the logits fed the reference's tokens agree at every step
    fed = np.concatenate([prompts, want[:, :-1]], axis=1)
    ref = _reference_logits(rmodel, rparams, fed, PROMPT, STEPS)
    mine = _port_logits(model, fed, PROMPT, STEPS)
    scale = max(1.0, float(np.abs(ref).max()))
    for t in range(STEPS):
        err = float(np.abs(mine[:, t] - ref[:, t]).max())
        rel = float(np.linalg.norm(mine[:, t] - ref[:, t]) / np.linalg.norm(ref[:, t]))
        assert err <= ATOL * scale and rel <= RTOL, (arch, t, err, rel)

    # the tokens agree wherever the reference's choice is decided
    top2 = np.sort(ref, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    checked = 0
    for row in range(BATCH):
        for t in range(STEPS):
            if margin[row, t] <= 10 * ATOL * scale:
                if got[row, t] != want[row, t]:
                    break  # an undecided pick: the continuations may part here
                continue
            assert got[row, t] == want[row, t], (row, t, margin[row, t])
            checked += 1
    assert checked >= STEPS  # most picks are decided at this size


def _port_logits(model, tokens, prompt, steps):
    cache = model.init_cache(tokens.shape[0], prompt + steps)
    toks = torch.as_tensor(tokens)
    lg, _ = model.prefill({"tokens": toks[:, :prompt]}, cache)
    rows = [lg[:, -1]]
    for i in range(steps - 1):
        lg, _ = model.decode_step({"tokens": toks[:, prompt + i:prompt + i + 1]}, cache,
                                  prompt + i)
        rows.append(lg[:, -1])
    return torch.stack(rows, dim=1).numpy()


def test_cache_is_allocated_once_and_written_in_place():
    model, _, _, prompts = _setup("gemma2-2b")
    engine = Engine(model, max_len=PROMPT + STEPS, device="cpu")
    ptrs, phases = [], []

    def watch(phase, call):
        def wrapped(inputs, cache, *rest):
            phases.append(phase)
            ptrs.append([(c["k"].data_ptr(), c["v"].data_ptr()) for c in cache])
            return call(inputs, cache, *rest)
        return wrapped

    model.prefill = watch("prefill", model.prefill)
    model.decode_step = watch("step", model.decode_step)
    engine.generate({"tokens": prompts}, steps=STEPS)
    assert phases == ["prefill"] + ["step"] * (STEPS - 1)
    assert all(p == ptrs[0] for p in ptrs)
    assert [(c["k"].data_ptr(), c["v"].data_ptr()) for c in engine.cache] == ptrs[0]
    # the cache holds the prompt and every fed token, nothing past them
    k0 = engine.cache[0]["k"]
    assert k0.shape == (BATCH, model.cfg.num_kv_heads, PROMPT + STEPS, model.cfg.head_dim)
    assert k0[:, :, :PROMPT + STEPS - 1].abs().sum(-1).gt(0).all()
    assert not k0[:, :, PROMPT + STEPS - 1:].any()


def test_sampling_follows_the_seed():
    model, _, _, prompts = _setup("qwen1.5-4b")
    engine = Engine(model, max_len=PROMPT + STEPS, device="cpu")
    a = engine.generate({"tokens": prompts}, steps=STEPS, temperature=1.0, seed=11)
    b = engine.generate({"tokens": prompts}, steps=STEPS, temperature=1.0, seed=11)
    c = engine.generate({"tokens": prompts}, steps=STEPS, temperature=1.0, seed=12)
    greedy = engine.generate({"tokens": prompts}, steps=STEPS)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, greedy)
    assert ((a >= 0) & (a < model.cfg.vocab_size)).all()


def test_engine_and_make_inputs_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = configs.get_config("gemma2-2b", reduced=True)
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.make_inputs(cfg, configs.Shape("t", 4, 1, "prefill"))


def test_generate_rejects_a_run_past_max_len():
    model, _, _, prompts = _setup("gemma2-2b")
    with pytest.raises(ValueError, match="max_len"):
        Engine(model, max_len=PROMPT + 2, device="cpu").generate({"tokens": prompts}, steps=4)


# ---------------------------------------------------------------------------
# The reference fixture and chip_smoke.py's LM gates
# ---------------------------------------------------------------------------


def test_chip_smoke_lm_gates_on_a_reduced_fixture(capsys):
    """The fixture tool's output for reduced gemma2, built here in memory,
    against the port through ``chip_smoke.py``'s own comparison: the
    float32 gate of ``lm_reference`` and the bfloat16 gate of ``lm_serve``."""
    tool = _module("lm_reference_fixture", ROOT / "tools" / "lm_reference_fixture.py")
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    fixture = tool.build_fixture("gemma2-2b", reduced=True, seed=2, prompt_len=12, steps=4,
                                 subset=100)
    assert fixture["tokens"].shape == (2, 16) and fixture["logits"].shape == (2, 5, 100)
    cfg = configs.get_config("gemma2-2b", reduced=True)
    tree = reference_weights(cfg, 2)
    assert np.array_equal(weights_digest(tree), fixture["weights_digest"])
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    res = smoke.lm_reference_case(model, fixture)
    assert res["ok"] and res["argmax_mismatch"] == 0
    assert '"phase": "lm_reference"' in capsys.readouterr().out

    # bfloat16: the port's error against the float32 fixture within the
    # chip's factor of the reference's own bfloat16 error
    model16 = load_reference_params(Model(dataclasses.replace(cfg, dtype="bfloat16"),
                                          device="cpu"), tree)
    logits = smoke.lm_fixture_logits(model16, fixture).float().numpy()[..., fixture["vocab_ids"]]
    ref = np.asarray(fixture["logits"], np.float64)
    rel = np.linalg.norm(logits - ref) / np.linalg.norm(ref)
    assert 0 < rel <= smoke.LM_BF16_FACTOR * float(fixture["bf16_rel_l2_all"])

    # a wrong model fails the gate
    with torch.no_grad():
        model.final_norm.add_(0.01)
    tol = smoke.lm_tolerances(fixture)
    assert (tol["abs"] == smoke.LM_ABS_TOL).all() and (tol["rel"] == smoke.LM_REL_TOL).all()
    assert (tol["rel_f64"] == smoke.LM_REL_TOL).all()  # the floors at this size
    bad = compare_to_summary(smoke.lm_fixture_logits(model, fixture), fixture,
                             abs_tol=tol["abs"], rel_tol=tol["rel"], margin=smoke.LM_MARGIN)
    assert not bad["ok"]
    assert smoke.lm_f64_error(smoke.lm_fixture_logits(model, fixture), fixture,
                              tol)["f64_worst_ratio"] > 1


def test_chip_smoke_lm_gates_follow_each_rows_noise():
    """Where a row's recorded float32 noise lifts its gate past the floor,
    that row alone is widened: an error planted in it passes, and the same
    error in a row gated at the floor fails."""
    tool = _module("lm_reference_fixture", ROOT / "tools" / "lm_reference_fixture.py")
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    fixture = tool.build_fixture("gemma2-2b", reduced=True, seed=2, prompt_len=12, steps=4,
                                 subset=100)
    fixture["f32_noise_rel_l2"] = fixture["f32_noise_rel_l2"].copy()
    fixture["f32_noise_max_abs"] = fixture["f32_noise_max_abs"].copy()
    fixture["f32_noise_rel_l2"][0, 1] = 0.01
    fixture["f32_noise_max_abs"][0, 1] = 0.05
    tol = smoke.lm_tolerances(fixture)
    assert tol["rel"][0, 1] == 0.04 and tol["abs"][0, 1] == pytest.approx(0.2)
    assert (np.delete(tol["rel"].ravel(), 1) == smoke.LM_REL_TOL).all()
    cfg = configs.get_config("gemma2-2b", reduced=True)
    model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 2))
    logits = smoke.lm_fixture_logits(model, fixture)
    for row, ok in (((0, 1), True), ((1, 1), False), ((0, 2), False)):
        planted = logits.clone()
        planted[row] *= 1.02  # 2% relative error, the argmax kept
        res = compare_to_summary(planted, fixture, abs_tol=tol["abs"], rel_tol=tol["rel"],
                                 margin=smoke.LM_MARGIN)
        assert res["ok"] is ok, (row, res)


def test_chip_smoke_lm_window_case_on_the_cpu(capsys):
    """``lm_window`` at a reduced size: decode past the window equals the
    forward, and the all-global forward differs only past the window."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    cfg = configs.get_config("gemma2-2b", reduced=True)
    model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 4))
    res = smoke.lm_window_case(model, seed=1, prompt=20, steps=6)
    assert res["global_vs_local_before_window_max_abs"] == 0.0
    assert res["global_vs_local_past_window_max_abs"] > 0.01
    assert [layer.window for layer in model.layers] == model.windows()
    assert '"phase": "lm_window"' in capsys.readouterr().out


def test_committed_fixture():
    fx = np.load(FIXTURE)
    cfg = configs.get_config("gemma2-2b")
    b, p, steps = 2, int(fx["prompt_len"]), int(fx["steps"])
    assert (str(fx["arch"]), p, steps) == ("gemma2-2b", 40, 8)
    assert fx["tokens"].shape == (b, p + steps) and fx["tokens"].dtype == np.int32
    assert fx["logits"].shape == (b, steps + 1, 2048)
    for k in ("argmax", "logsumexp", "margin", "bf16_rel_l2", "f32_noise_rel_l2",
              "f32_noise_max_abs", "f64_rel_l2", "f64_max_abs"):
        assert fx[k].shape == (b, steps + 1)
    assert fx["logits_f64"].shape == fx["logits"].shape and fx["logits_f64"].dtype == np.float64
    # the float32 noise that sets the card's gate lies far below the bf16 gap
    assert 0 < float(fx["f32_noise_rel_l2"].max()) < 0.05 * float(fx["bf16_rel_l2_all"])
    assert np.array_equal(fx["vocab_ids"], vocab_subset(cfg.vocab_size, 2048, int(fx["seed"]) + 1))
    # the prompts are make_inputs' draws, and greedy: each fed token is the
    # argmax of the step before
    prompts = configs.make_inputs(cfg, configs.Shape("lm_reference", p, b, "prefill"),
                                  int(fx["seed"]), device="cpu")["tokens"].numpy()
    assert np.array_equal(fx["tokens"][:, :p], prompts)
    assert np.array_equal(fx["tokens"][:, p:], fx["argmax"][:, :-1])
    assert np.isfinite(fx["logits"]).all() and (fx["margin"] >= 0).all()
    assert 0 < float(fx["bf16_rel_l2_all"]) < 1
    assert fx["weights_digest"].size == 8 * 12 and np.isfinite(fx["weights_digest"]).all()


def test_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"),
                           "--device", "cpu", "--steps", "6"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated 24 tokens" in proc.stdout


# ---------------------------------------------------------------------------
# The MoE phases of chip_smoke.py at a reduced size, and the committed fixture
# ---------------------------------------------------------------------------


class _HostEvent:
    """``torch.cuda.Event``'s timing on the host clock."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_lm_moe_phases_on_a_reduced_fixture(monkeypatch, capsys):
    """``lm_moe_reference`` and ``lm_moe_serve`` on the CPU: the fixture
    tool's reduced deepseek fixture (``lp``, the router whose LPs it records)
    through ``chip_smoke.py``'s own cases, then ``lm_moe_serve`` under both
    routers.  Off the card the wrappers count no launches, so the plain
    simplex is wrapped to count them as the kernel would."""
    from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda
    import repro_torch.serve.engine as engine_mod

    tool = _module("lm_reference_fixture", ROOT / "tools" / "lm_reference_fixture.py")
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    fixture = tool.build_router_fixtures("deepseek-v2-lite-16b", ["lp"], reduced=True,
                                         seed=2, prompt_len=10, steps=3, subset=100)
    assert list(fixture["routers"]) == ["lp"]
    assert fixture["lp__router_c"].shape == (4 * 2, 64)  # 4 calls x 2 MoE layers
    assert fixture["lp__router_call"].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert fixture["lp__router_layer"].tolist() == [1, 2] * 4
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}
    plain = simplex_cuda.simplex_plain

    def counted(*args, **kw):
        simplex_cuda.launches += 1
        simplex_cuda.variant_launches["cluster"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(simplex_cuda, "simplex_plain", counted)
    cfg = configs.get_config("deepseek-v2-lite-16b", reduced=True)
    tree = reference_weights(cfg, 2)
    assert np.array_equal(weights_digest(tree), fixture["weights_digest"])
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    model16 = load_reference_params(Model(dataclasses.replace(cfg, dtype="bfloat16"),
                                          device="cpu"), tree)
    out = smoke.lm_moe_reference_case(model, model16, fixture, "lp", counters=counters)
    assert out["logits"]["ok"] and out["bf16_rel_l2"] <= out["bf16_limit"]
    assert out["router_lps_solved"] == out["simplex_launches"] == 8
    lp = out["router_lp"]
    assert lp["ok"] and lp["port_basis_equal"] == lp["port_lps"] == 8
    assert lp["fixture_on_kernel"]["basis_equal"] and not lp["divergences"]

    # lm_moe_serve with the card's clock and memory calls stood in for
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(smoke, "smi_line", lambda: "cpu")
    monkeypatch.setattr(engine_mod, "resolve_device", lambda device=None: torch.device("cpu"))
    for router in ("topk", "lp"):
        res = smoke.lm_moe_serve_case(model16, router, seed=0, counters=counters, batch=2,
                                      prompt=24, steps=5)
        assert res["all_logits_finite"] and res["routing"]["decode"]["dropped"] == 0
    assert res["router_lps"] == 2 * 5 and res["captured_bit_identical"] == 2 * 3
    assert res["port_kernel_launches"]["simplex"] == 10
    lines = capsys.readouterr().out
    assert '"phase": "lm_moe_reference"' in lines and '"phase": "lm_moe_serve"' in lines

    # a divergence that the affinities' rounding cannot explain fails the gate
    view = {k[len("lp__"):] if k.startswith("lp__") else k: v for k, v in fixture.items()}
    recs = []
    with smoke.SimplexSpy(simplex_cuda) as spy:
        smoke.with_router(model, "lp")
        smoke.lm_fixture_logits(model, view)
        recs = spy.records
    c_ext = recs[0]["inputs"][3]
    swapped = c_ext.clone()
    swapped[0, 1:65] = c_ext[0, 1:65].flip(0)  # another LP's costs, far from rounding
    recs[0]["inputs"][3] = swapped
    recs[0]["basis"] = torch.zeros_like(recs[0]["basis"])
    bad = smoke.router_lp_checks(view, recs, torch.device("cpu"), cfg.router_groups)
    assert not bad["ok"] and bad["divergences"][0]["lp"] == 0
    assert not bad["divergences"][0]["within_rounding"]


def test_committed_moe_fixture():
    """deepseek-v2-lite-16b at full width cut to 3 layers, both routers:
    the fields, greedy tokens, and under ``lp`` the 18 router LPs (2 MoE
    layers x 9 calls) re-solved by the port's plain version to the
    stored status, iterations and basis."""
    from repro_torch.kernels import ops
    from repro_torch.models.convert import fixture_view

    fx = dict(np.load(MOE_FIXTURE))
    cfg = configs.get_config("deepseek-v2-lite-16b")
    assert str(fx["arch"]) == "deepseek-v2-lite-16b" and int(fx["layers"]) == 3
    assert list(fx["routers"]) == ["topk", "lp"]
    b, p, steps = 2, int(fx["prompt_len"]), int(fx["steps"])
    assert (p, steps) == (40, 8)
    prompts = configs.make_inputs(dataclasses.replace(cfg, num_layers=3),
                                  configs.Shape("lm_reference", p, b, "prefill"),
                                  int(fx["seed"]), device="cpu")["tokens"].numpy()
    assert np.array_equal(fx["vocab_ids"], vocab_subset(cfg.vocab_size, 2048, int(fx["seed"]) + 1))
    for router in ("topk", "lp"):
        view = fixture_view(fx, router)
        assert str(view["router"]) == router
        assert view["tokens"].shape == (b, p + steps)
        assert np.array_equal(view["tokens"][:, :p], prompts)
        assert np.array_equal(view["tokens"][:, p:], view["argmax"][:, :-1])
        assert view["logits"].shape == view["logits_f64"].shape == (b, steps + 1, 2048)
        for k in ("argmax", "logsumexp", "margin", "bf16_rel_l2", "f32_noise_rel_l2",
                  "f32_noise_max_abs", "f64_rel_l2", "f64_max_abs"):
            assert view[k].shape == (b, steps + 1)
        assert 0 < float(view["f32_noise_rel_l2"].max()) < 0.05 * float(view["bf16_rel_l2_all"])
        assert np.isfinite(view["logits"]).all()
    assert "router_c" not in fixture_view(fx, "topk")
    lp = fixture_view(fx, "lp")
    n_lp = 2 * (steps + 1)
    assert lp["router_a"].shape == (n_lp, 72, 512) and lp["router_x"].shape == (n_lp, 512)
    assert lp["router_call"].tolist() == np.repeat(np.arange(steps + 1), 2).tolist()
    assert lp["router_layer"].tolist() == [1, 2] * (steps + 1)
    assert (lp["router_status"] == 1).all()
    # b: ones for the 8 groups, then cap_e = 6 * 1.25 / 64 (exact in binary)
    assert (lp["router_b"][:, :8] == 1).all() and (lp["router_b"][:, 8:] == 0.1171875).all()
    sol = ops.simplex_solve(torch.as_tensor(lp["router_a"]), torch.as_tensor(lp["router_b"]),
                            torch.as_tensor(lp["router_c"]), max_iters=8 * (72 + 512))
    assert np.array_equal(sol.status.numpy(), lp["router_status"])
    assert np.array_equal(sol.iterations.numpy(), lp["router_iterations"])
    assert np.array_equal(sol.basis.numpy(), lp["router_basis"])
    assert float(np.abs(sol.x.numpy() - lp["router_x"]).max()) <= 1e-6
