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


def _extras(rcfg, seed=3):
    """The prompt's inputs besides the tokens (``make_inputs``' frames and
    patch embeddings; M-RoPE positions whose coordinates differ)."""
    out = {k: np.array(v) for k, v in rconfigs.make_inputs(
        rcfg, rconfigs.Shape("t", PROMPT, BATCH, "prefill"), seed=seed).items() if k != "tokens"}
    if rcfg.mrope_sections:
        out["positions"] = configs.mrope_positions(BATCH, PROMPT, rcfg.num_patches, seed)
    return out


def _reference_logits(rmodel, rparams, tokens, prompt, steps, extras=None):
    """The reference's logits (B, steps, V) fed ``tokens``: prefill (with
    ``extras``), then one decode step a token."""
    extras = extras or {}
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    cache = rmodel.init_cache(tokens.shape[0], prompt + steps, enc_len=enc_len)
    first = {"tokens": jnp.asarray(tokens[:, :prompt]),
             **{k: jnp.asarray(v) for k, v in extras.items()}}
    lg, cache = jax.jit(rmodel.prefill)(rparams, first, cache)
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


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2",
                                  "qwen2-vl-72b"])
def test_family_generate_matches_the_reference_engine(arch):
    """The SSM, hybrid, encoder-decoder and M-RoPE families: ``enc_len``
    and the prompt's frames, patch embeddings and positions go to both
    engines.  The logit gate is raised to the reference's own float32
    noise where that is the larger (``tests/test_torch_models.py:_gate``)."""
    model, rmodel, rparams, prompts = _setup(arch)
    _generate_parity(model, rmodel, rparams, prompts, _extras(rmodel.cfg), gate_noise=True)


def _noise(rmodel, rparams, fed, extras):
    """The reference's float32 noise on the fed logits: their largest change
    (max abs over the largest magnitude, relative L2, per step) when every
    weight moves one ulp (``tests/test_torch_models.py:_noise``'s draws)."""
    models = _module("test_torch_models", ROOT / "tests" / "test_torch_models.py")
    return models._noise(lambda p: list(np.moveaxis(
        _reference_logits(rmodel, p, fed, PROMPT, STEPS, extras), 1, 0)), rparams)


def _generate_parity(model, rmodel, rparams, prompts, extras=None, gate_noise=False):
    arch = model.cfg.name
    extras = extras or {}
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    want = np.asarray(REngine(rmodel, rparams, max_len=PROMPT + STEPS, enc_len=enc_len).generate(
        {"tokens": jnp.asarray(prompts), **{k: jnp.asarray(v) for k, v in extras.items()}},
        steps=STEPS))
    engine = Engine(model, max_len=PROMPT + STEPS, enc_len=enc_len, device="cpu")
    got = engine.generate({"tokens": prompts, **extras}, steps=STEPS)
    assert got.dtype == torch.int32 and got.shape == (BATCH, STEPS)
    got = got.numpy()

    # the logits fed the reference's tokens agree at every step
    fed = np.concatenate([prompts, want[:, :-1]], axis=1)
    ref = _reference_logits(rmodel, rparams, fed, PROMPT, STEPS, extras)
    mine = _port_logits(model, fed, PROMPT, STEPS, extras)
    atol, rtol = ATOL, RTOL
    if gate_noise:
        noise_abs, noise_rel = _noise(rmodel, rparams, fed, extras)
        atol, rtol = max(ATOL, 4 * noise_abs), max(RTOL, 4 * noise_rel)
    scale = max(1.0, float(np.abs(ref).max()))
    for t in range(STEPS):
        err = float(np.abs(mine[:, t] - ref[:, t]).max())
        rel = float(np.linalg.norm(mine[:, t] - ref[:, t]) / np.linalg.norm(ref[:, t]))
        assert err <= atol * scale and rel <= rtol, (arch, t, err, rel)

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


def _port_logits(model, tokens, prompt, steps, extras=None):
    extras = {k: torch.as_tensor(v) for k, v in (extras or {}).items()}
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    cache = model.init_cache(tokens.shape[0], prompt + steps, enc_len=enc_len)
    toks = torch.as_tensor(tokens)
    lg, _ = model.prefill({"tokens": toks[:, :prompt], **extras}, cache)
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


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2",
                                  "qwen2-vl-72b"])
def test_example_runs_every_new_family_on_the_cpu(arch):
    """The example with the frames, patch embeddings, M-RoPE positions and
    ``enc_len`` each family takes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_lm.py"),
                           "--arch", arch, "--device", "cpu", "--steps", "6"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"{arch} (reduced) on cpu: generated 24 tokens" in proc.stdout


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
    # the counts are module state: restored after the test, not left raised
    monkeypatch.setattr(simplex_cuda, "launches", simplex_cuda.launches)
    monkeypatch.setattr(simplex_cuda, "variant_launches", dict(simplex_cuda.variant_launches))
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


# ---------------------------------------------------------------------------
# The slice-11 phases of chip_smoke.py at a reduced size, and the committed fixtures
# ---------------------------------------------------------------------------

FAMILY_FIXTURES = {
    "lm_ssm": ("mamba2-130m", "lm_mamba2_130m_reference.npz", 24, 0),
    "lm_hybrid": ("zamba2-7b", "lm_zamba2_7b_reference.npz", 7, 0),
    "lm_encdec": ("seamless-m4t-large-v2", "lm_seamless_m4t_large_v2_reference.npz", 1, 1),
    "lm_vlm": ("qwen2-vl-72b", "lm_qwen2_vl_72b_reference.npz", 2, 0),
}


class _ReducedConfigs:
    """A ``repro_torch.configs`` stand-in whose ``get_config`` gives the
    reduced configs (what ``chip_smoke.py`` asks for at full width)."""

    def get_config(self, arch, reduced=False):
        return configs.get_config(arch, reduced=True)


def _stub_the_card(monkeypatch, smoke):
    import repro_torch.serve.engine as engine_mod

    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(smoke, "smi_line", lambda: "cpu")
    monkeypatch.setattr(engine_mod, "resolve_device", lambda device=None: torch.device("cpu"))


def test_chip_smoke_lm_families_phase_on_reduced_fixtures(monkeypatch, tmp_path, capsys):
    """``lm_families_phase`` whole on the CPU: the fixture tool's reduced
    fixtures of the four families (mamba2 and zamba2 prompts of 100 tokens,
    several chunks with padding; qwen2-vl's patch prefix and M-RoPE
    positions; seamless's frames) through ``<row>_reference``, then every
    serve row, ``lm_ssm_long`` and the encoder-decoder's decode against its
    forward, at small sizes with the card's clock stubbed.  Off the card no
    kernel of the port is reached, as on it."""
    from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda

    tool = _module("lm_reference_fixture", ROOT / "tools" / "lm_reference_fixture.py")
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    _stub_the_card(monkeypatch, smoke)
    fixtures = {}
    for row, (arch, name, _, _) in FAMILY_FIXTURES.items():
        prompt = 100 if row in ("lm_ssm", "lm_hybrid") else 12
        positions = configs.mrope_positions(2, prompt, 8, seed=5) if row == "lm_vlm" else None
        fx = tool.build_fixture(arch, reduced=True, seed=2, prompt_len=prompt, steps=3,
                                subset=100, positions=positions)
        if positions is not None:  # the caller's positions, not the default draw
            assert np.array_equal(fx["positions"], positions)
        np.savez(tmp_path / name, **fx)
        fixtures[row] = (arch, tmp_path / name)
    monkeypatch.setattr(smoke, "LM_FAMILY_FIXTURES", fixtures)
    for name, value in (("LM_SERVE_BATCH", 2), ("LM_SERVE_PROMPT", 24), ("LM_SERVE_STEPS", 4),
                        ("LM_LONG_PROMPT", 300), ("LM_LONG_STEPS", 3), ("LM_ENCDEC_CHECK", (2, 3))):
        monkeypatch.setattr(smoke, name, value)
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}

    def reset():
        for mod in counters.values():
            mod.launches = 0
            for v in getattr(mod, "variant_launches", {}):
                mod.variant_launches[v] = 0

    out = smoke.lm_families_phase(_ReducedConfigs(), torch.device("cpu"), seed=0,
                                  counters=counters, reset=reset)
    for row in ("ssm", "hybrid", "encdec", "vlm"):
        assert out[row]["logits_ok"] and out[row]["bf16_rel_l2"] <= out[row]["bf16_limit"]
    assert out["hybrid"]["shared_sites"] == 3  # the reduced zamba2: every 2 of 5 layers
    assert out["long"]["continuity_rel_l2"] <= smoke.LM_REL_TOL
    assert out["long"]["zeroed_state_rel_l2"] > 10 * smoke.LM_REL_TOL
    assert out["long"]["cache_bytes"] == out["long"]["cache_bytes_4096_prompt"]
    assert out["encdec_serve"]["decode_vs_forward_max_abs"] <= smoke.LM_WINDOW_TOL
    for row in ("ssm_serve", "hybrid_serve", "encdec_serve"):
        res = out[row]
        assert res["all_logits_finite"] and not any(res["port_kernel_launches"].values())
        assert res["prefill_bound_ms"] > 0 and res["decode_bound_ms"] > 0
    assert out["ssm_serve"]["prefill_flops_f32"] > 0 and out["encdec_serve"]["prefill_flops_f32"] == 0
    lines = capsys.readouterr().out
    for phase in ("lm_ssm_reference", "lm_hybrid_reference", "lm_encdec_reference",
                  "lm_vlm_reference", "lm_ssm_serve", "lm_ssm_long", "lm_hybrid_serve",
                  "lm_encdec_serve", "lm_encdec_decode_vs_forward", "slice11_lm_families"):
        assert f'"{phase}"' in lines, phase


def test_chip_smoke_ssm_long_gate_rejects_a_lost_state(monkeypatch):
    """``lm_ssm_long``'s continuity gate fails when the port's decode step
    itself drops the state handed over by the prefill (a fault planted in
    ``mamba_mixer``), not only when the case zeroes it."""
    from repro_torch.models import mamba2

    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    _stub_the_card(monkeypatch, smoke)
    cfg = configs.get_config("mamba2-130m", reduced=True)
    tree = reference_weights(cfg, 2)
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    orig = mamba2.mamba_mixer

    def forgetful(x, params, cfg, *, cache=None, cache_index=None):
        if cache is not None and x.shape[1] == 1:
            cache["state"].zero_()
        return orig(x, params, cfg, cache=cache, cache_index=cache_index)

    monkeypatch.setattr(mamba2, "mamba_mixer", forgetful)
    with pytest.raises(SystemExit, match="differs from the whole prefill"):
        smoke.lm_ssm_long_case(model, model, seed=0, counters={}, prompt=200, steps=2)


def test_chip_smoke_lm_bounds_cover_every_family():
    """The prefill FLOPs and the decode step's cache bytes: gemma2's as
    before (attention layers only), mamba2's from its SSD and states alone
    (no attention dimension), the encoder-decoder's cross caches."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    m = Model(configs.get_config("mamba2-130m"), device="cpu")
    cfg = m.cfg
    flops = smoke.lm_prefill_flops(m, 8, 4096)
    per_token = cfg.d_model * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) \
        + cfg.d_inner * cfg.d_model + 4 * (cfg.d_inner + 2 * cfg.ssm_state)
    assert flops["bf16"] == 2.0 * 8 * 4096 * per_token * 24 + 2.0 * 8 * 768 * cfg.padded_vocab
    assert flops["f32"] == 24 * smoke.lm_ssd_flops(cfg, 8, 4096) > 0
    state = 24 * 2 * 8 * (3 * (cfg.d_inner + 2 * cfg.ssm_state) * 2 + 24 * 64 * 128 * 4)
    assert smoke.lm_decode_kv_bytes(m, 8, 4096, 2) == smoke.lm_decode_kv_bytes(m, 8, 9, 2) == state
    g = Model(configs.get_config("gemma2-2b"), device="cpu")
    gc = g.cfg
    keys = sum(smoke.lm_keys(g.windows(), q) for q in range(64))
    assert smoke.lm_prefill_flops(g, 2, 64) == {"bf16": (
        2.0 * 2 * 64 * (gc.d_model * gc.q_dim + 2 * gc.d_model * gc.kv_dim + gc.q_dim * gc.d_model
                        + 3 * gc.d_model * gc.d_ff) * gc.num_layers
        + 4.0 * 2 * gc.num_heads * gc.head_dim * keys + 2.0 * 2 * gc.d_model * gc.padded_vocab),
        "f32": 0.0}
    s = Model(configs.get_config("seamless-m4t-large-v2", reduced=True), device="cpu")
    sc = s.cfg
    assert smoke.lm_decode_kv_bytes(s, 2, 9, 4, enc_len=30) - smoke.lm_decode_kv_bytes(s, 2, 9, 4) \
        == 2 * 2 * 2 * sc.num_heads * sc.head_dim * 30 * 4


@pytest.mark.parametrize("row", list(FAMILY_FIXTURES))
def test_committed_family_fixture(row):
    """The four fixtures of slice 11, each at full width: depth, prompts
    (mamba and zamba2 100 tokens; qwen2-vl 320, its 256 patches on a 16 x 16
    grid at one t, then the text at equal coordinates), greedy tokens,
    the float32 noise far below the bf16 gap, and the extras' digest."""
    arch, name, layers, enc_layers = FAMILY_FIXTURES[row]
    fx = dict(np.load(ROOT / "tests" / "data" / name))
    cfg = configs.get_config(arch)
    b, p, steps = 2, int(fx["prompt_len"]), int(fx["steps"])
    assert (str(fx["arch"]), int(fx["layers"]), steps) == (arch, layers, 8)
    assert int(fx.get("enc_layers", 0)) == enc_layers
    assert p == {"lm_ssm": 100, "lm_hybrid": 100, "lm_encdec": 40, "lm_vlm": 320}[row]
    cut = dataclasses.replace(cfg, num_layers=layers, enc_layers=enc_layers or cfg.enc_layers)
    made = configs.make_inputs(cut, configs.Shape("lm_reference", p, b, "prefill"),
                               int(fx["seed"]), device="cpu")
    assert np.array_equal(fx["tokens"][:, :p], made["tokens"].numpy())
    assert np.array_equal(fx["tokens"][:, p:], fx["argmax"][:, :-1])
    assert fx["logits"].shape == fx["logits_f64"].shape == (b, steps + 1, 2048)
    assert np.array_equal(fx["vocab_ids"], vocab_subset(cfg.vocab_size, 2048, int(fx["seed"]) + 1))
    for k in ("argmax", "logsumexp", "margin", "bf16_rel_l2", "f32_noise_rel_l2",
              "f32_noise_max_abs", "f64_rel_l2", "f64_max_abs"):
        assert fx[k].shape == (b, steps + 1)
    assert np.isfinite(fx["logits"]).all() and 0 < float(fx["bf16_rel_l2_all"]) < 1
    assert 0 < float(fx["f32_noise_rel_l2"].max()) < 0.05 * float(fx["bf16_rel_l2_all"])
    keys = [str(k) for k in fx["extras_keys"]]
    assert keys == {"lm_encdec": ["frames"], "lm_vlm": ["patch_embeds"]}.get(row, [])
    if keys:
        assert np.array_equal(weights_digest({k: made[k].float().numpy() for k in keys}),
                              fx["extras_digest"])
    if row == "lm_vlm":
        pos = fx["positions"]
        assert pos.shape == (b, p, 3)
        assert np.array_equal(pos, configs.mrope_positions(b, p, 256, int(fx["seed"])))
        assert (pos[:, :256, 0] == pos[:, :1, 0]).all()  # one t for the image
        assert len(np.unique(pos[0, :256, 1])) == len(np.unique(pos[0, :256, 2])) == 16
        assert (pos[:, 256:] == np.arange(256, p)[None, :, None]).all()
    else:
        assert "positions" not in fx
