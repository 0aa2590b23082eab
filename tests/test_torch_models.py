"""The port's LMs (``repro_torch.models``, ``configs``, ``sharding``): the
dense family, the MoE family (dbrx's GQA + MoE, deepseek-v2-lite's MLA +
MoE) under both routers, the SSM and hybrid families (mamba2-130m,
zamba2-7b), the encoder-decoder (seamless-m4t-large-v2) and M-RoPE with
the vision prefix (qwen2-vl-72b), against the reference
``repro.models.Model`` on reduced configs.

Both packages take the same NumPy weights (``models/convert.py:
reference_weights``) and the same inputs (``configs.make_inputs``).
float32 throughout.  The parity tolerance (``_close``): a relative L2
error of at most 1e-5, and a max abs error of at most 2e-5 times the
tensor's largest magnitude where that exceeds 1.  Not the elementwise
``|a - b| <= 2e-5 + 1e-5 |b|``: float32 error along the layers has the
size of the tensor's norm, not of each entry, so correct evaluations
fail that form.  On the final hidden states of the four configs below
(``tools/lm_precision_probe.py --reduced``), the reference's own float32
forward against an all-float64 evaluation of the same weights reaches
0.60-1.15x the elementwise bound (1.15x on qwen1.5) and the port's
0.70-1.43x, while both stay at 0.23-0.46x ``_close``'s bound and 1.9e-6
to 2.8e-6 relative L2.  The sequence (24 tokens) is longer than gemma2's
reduced window (16), so its local layers mask.

The four families of ``FAMILIES`` are gated the same way, with one
addition (``_gate``): where the reference's own float32 noise on the
case exceeds a quarter of ``_close``'s bound, the bound becomes 4 times
that noise, as ``chip_smoke.py:lm_tolerances`` gates the card's rows.
The noise of a case is the largest change of any of its outputs (every
step of a prefill-and-decode run) when every weight moves one ulp up or
down (a seeded coin a weight), over three such draws.  Reduced zamba2
and seamless need it: their attention scores reach magnitudes of 60
(the reference's std rule gives ``wq`` a std of 1/sqrt(H) = 0.5 on a
64-wide input), and a one-ulp nudge moves the reference's own outputs by
up to 8e-6 (zamba2) and 4e-5 (seamless) relative L2; the reference's
float32 decode steps miss an all-float64 evaluation of themselves by up
to 7e-6 (zamba2), the port's by up to 1.3e-5.  mamba2-130m and qwen2-vl
stay at the plain bound.  M-RoPE cases take positions whose three
coordinates differ (``configs.mrope_positions``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import Model as RModel
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro_torch import configs
from repro_torch.models import Model, attention, blocks, layers
from repro_torch.models.convert import (load_reference_params, reference_params,
                                        reference_weights)
from repro_torch.sharding import ParamSpec, materialize

DENSE = ["gemma2-2b", "qwen1.5-4b", "internlm2-20b", "command-r-plus-104b"]
MOE = ["dbrx-132b", "deepseek-v2-lite-16b"]
ROUTERS = ["topk", "lp"]
FAMILIES = ["mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2", "qwen2-vl-72b"]
RTOL, ATOL = 1e-5, 2e-5
NOISE_FACTOR = 4.0
SEQ, BATCH, PREFIX = 24, 2, 16


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    assert err <= atol * scale and rel <= rtol, (err, atol * scale, rel, rtol)


def _pair(arch, seed=3, **kw):
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), **kw)
    tree = reference_weights(cfg, seed)
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    rmodel = RModel(dataclasses.replace(rconfigs.get_config(arch, reduced=True), **kw))
    return model, rmodel, jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(arch, seq=SEQ, seed=1):
    cfg = rconfigs.get_config(arch, reduced=True)
    return np.array(rconfigs.make_inputs(cfg, rconfigs.Shape("t", seq, BATCH, "prefill"),
                                           seed=seed)["tokens"])


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_logits_match_reference(arch):
    model, rmodel, rp = _pair(arch)
    toks = _tokens(arch)
    rh = rmodel.forward(rp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        h = model.forward({"tokens": torch.as_tensor(toks)})
        lg = model.logits(h)
    _close(h, rh)
    _close(lg, rmodel.logits(rp, rh))
    assert lg.shape == (BATCH, SEQ, model.cfg.padded_vocab)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_every_decode_step_match_reference(arch):
    model, rmodel, rp = _pair(arch)
    toks = _tokens(arch)
    rcache = rmodel.init_cache(BATCH, SEQ)
    cache = model.init_cache(BATCH, SEQ)
    rl, rcache = rmodel.prefill(rp, {"tokens": jnp.asarray(toks[:, :PREFIX])}, rcache)
    lg, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :PREFIX])}, cache)
    _close(lg, rl)
    for t in range(PREFIX, SEQ):
        rl, rcache = rmodel.decode_step(rp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, rcache, t)
        lg, cache = model.decode_step({"tokens": torch.as_tensor(toks[:, t:t + 1])}, cache, t)
        _close(lg, rl)
    # the caches hold the same k/v (layer i of the reference's stacked g0)
    for i, layer_cache in enumerate(cache):
        _close(layer_cache["k"], rcache["g0"]["k"][i])
        _close(layer_cache["v"], rcache["g0"]["v"][i])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_in_the_port(arch):
    """Prefill + stepwise decode logits == full-forward logits (per position)."""
    cfg = configs.get_config(arch, reduced=True)
    model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 5))
    toks = torch.as_tensor(_tokens(arch, seed=2))
    with torch.no_grad():
        full = model.logits(model.forward({"tokens": toks}))
    cache = model.init_cache(BATCH, SEQ)
    lg, cache = model.prefill({"tokens": toks[:, :PREFIX]}, cache)
    errs = [float((lg[:, 0] - full[:, PREFIX - 1]).abs().max())]
    for t in range(PREFIX, SEQ):
        lg, cache = model.decode_step({"tokens": toks[:, t:t + 1]}, cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_and_logits_match_reference(arch, router):
    model, rmodel, rp = _pair(arch, router=router)
    toks = _tokens(arch)
    rh = rmodel.forward(rp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        h = model.forward({"tokens": torch.as_tensor(toks)})
        lg = model.logits(h)
    _close(h, rh)
    _close(lg, rmodel.logits(rp, rh))
    assert model.kinds() == [g.kind for g in rmodel.groups for _ in range(g.count)]


def _ref_layer_cache(rmodel, rcache, i):
    """Layer ``i``'s cache in the reference's stacked per-group caches."""
    at = 0
    for j, g in enumerate(rmodel.groups):
        if i < at + g.count:
            return {k: v[i - at] for k, v in rcache[f"g{j}"].items()}
        at += g.count
    raise IndexError(i)


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_decode_and_caches_match_reference(arch, router):
    """Prefill and every decode step (the LP router solves one LP a MoE
    layer a call: T = 32 tokens at prefill, 2 at each step), and the
    caches: k/v for dbrx, the MLA latents ``ckv``/``kpe`` for deepseek."""
    model, rmodel, rp = _pair(arch, router=router)
    toks = _tokens(arch)
    rcache = rmodel.init_cache(BATCH, SEQ)
    cache = model.init_cache(BATCH, SEQ)
    prefill, decode = jax.jit(rmodel.prefill), jax.jit(rmodel.decode_step)
    rl, rcache = prefill(rp, {"tokens": jnp.asarray(toks[:, :PREFIX])}, rcache)
    lg, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :PREFIX])}, cache)
    _close(lg, rl)
    for t in range(PREFIX, SEQ):
        rl, rcache = decode(rp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, rcache, t)
        lg, cache = model.decode_step({"tokens": torch.as_tensor(toks[:, t:t + 1])}, cache, t)
        _close(lg, rl)
    keys = {"ckv", "kpe"} if arch.startswith("deepseek") else {"k", "v"}
    for i, layer_cache in enumerate(cache):
        want = _ref_layer_cache(rmodel, rcache, i)
        assert set(layer_cache) == set(want) == keys
        for k in keys:
            _close(layer_cache[k], want[k])
    if arch.startswith("deepseek"):
        assert cache[0]["ckv"].shape == (BATCH, SEQ, model.cfg.kv_lora_rank)
        assert cache[0]["kpe"].shape == (BATCH, SEQ, model.cfg.qk_rope_dim)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_in_the_port(arch):
    """Dropless (capacity factor E, as ``tests/test_models.py``) with top-k
    routing.  The LP router has no such identity: its bias depends on the
    tokens of the call (the whole sequence in the forward, one token a
    sequence in a decode step)."""
    cfg = configs.get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 5))
    toks = torch.as_tensor(_tokens(arch, seed=2))
    with torch.no_grad():
        full = model.logits(model.forward({"tokens": toks}))
    cache = model.init_cache(BATCH, SEQ)
    lg, cache = model.prefill({"tokens": toks[:, :PREFIX]}, cache)
    errs = [float((lg[:, 0] - full[:, PREFIX - 1]).abs().max())]
    for t in range(PREFIX, SEQ):
        lg, cache = model.decode_step({"tokens": toks[:, t:t + 1]}, cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


# ---------------------------------------------------------------------------
# The SSM, hybrid, encoder-decoder and M-RoPE families
# ---------------------------------------------------------------------------


def _family_inputs(arch, seq=SEQ, seed=1):
    """NumPy prefill inputs: ``make_inputs``' draws (frames, patch
    embeddings), and under M-RoPE positions whose coordinates differ."""
    cfg = rconfigs.get_config(arch, reduced=True)
    out = {k: np.array(v) for k, v in rconfigs.make_inputs(
        cfg, rconfigs.Shape("t", seq, BATCH, "prefill"), seed=seed).items()}
    if cfg.mrope_sections:
        out["positions"] = configs.mrope_positions(BATCH, seq, cfg.num_patches, seed)
    return out


NUDGES = (11, 12, 13)


def _nudged(rp, seed):
    """Every weight one float32 ulp up or down (a seeded coin a weight)."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        up = rng.random(a.shape) < 0.5
        return jnp.nextafter(a, jnp.where(up, np.float32(np.inf), np.float32(-np.inf)))

    return jax.tree_util.tree_map(nudge, rp)


def _noise(run, rp):
    """The reference's float32 noise on a case: ``run(params)`` gives its
    outputs (a list); returns the largest (max abs over the largest
    magnitude, relative L2) change of any output over ``NUDGES``."""
    want = [np.asarray(w, np.float64) for w in run(rp)]
    worst_abs = worst_rel = 0.0
    for seed in NUDGES:
        for w, n in zip(want, run(_nudged(rp, seed))):
            n = np.asarray(n, np.float64)
            worst_abs = max(worst_abs, float(np.abs(n - w).max()) / max(1.0, float(np.abs(w).max())))
            worst_rel = max(worst_rel, float(np.linalg.norm(n - w) / np.linalg.norm(w)))
    return worst_abs, worst_rel


def _gate(got, want, noise):
    """``_close`` with its bounds raised to ``NOISE_FACTOR`` times the case's
    noise (``_noise``) where that is the larger."""
    noise_abs, noise_rel = noise
    _close(got, want, rtol=max(RTOL, NOISE_FACTOR * noise_rel),
           atol=max(ATOL, NOISE_FACTOR * noise_abs))


def _torch_inputs(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _jax_inputs(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def test_plan_builds_every_family_as_the_reference():
    for arch in rconfigs.ARCH_IDS:
        for reduced in (False, True):
            got = [(g.kind, g.count) for g in blocks.plan(configs.get_config(arch, reduced))]
            want = [(g.kind, g.count) for g in RModel(rconfigs.get_config(arch, reduced)).groups]
            assert got == want, arch
    families = {configs.get_config(a).family for a in configs.ARCH_IDS}
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_and_logits_match_reference(arch):
    model, rmodel, rp = _pair(arch)
    inputs = _family_inputs(arch)

    def run(params):
        h = rmodel.forward(params, _jax_inputs(inputs))
        return [h, rmodel.logits(params, h)]

    rh, rl = run(rp)
    noise = _noise(run, rp)
    with torch.no_grad():
        h = model.forward(_torch_inputs(inputs))
        lg = model.logits(h)
    _gate(h, rh, noise)
    _gate(lg, rl, noise)
    assert model.kinds() == [g.kind for g in rmodel.groups for _ in range(g.count)]


def _prefill_inputs(inputs, p):
    """The prompt's part of ``inputs``: tokens and positions cut to ``p``."""
    out = dict(inputs)
    out["tokens"] = inputs["tokens"][:, :p]
    if "positions" in out:
        out["positions"] = inputs["positions"][:, :p]
    return out


def _step_inputs(inputs, t):
    out = {"tokens": inputs["tokens"][:, t:t + 1]}
    if "positions" in inputs:
        out["positions"] = inputs["positions"][:, t:t + 1]
    return out


def _reference_run(rmodel, rp, inputs, enc_len):
    """The reference's logits of a prefill of ``PREFIX`` tokens and a decode
    step a token up to ``SEQ``, and its cache after them."""
    prefill, decode = jax.jit(rmodel.prefill), jax.jit(rmodel.decode_step)
    rcache = rmodel.init_cache(BATCH, SEQ, enc_len=enc_len)
    rl, rcache = prefill(rp, _jax_inputs(_prefill_inputs(inputs, PREFIX)), rcache)
    rows = [rl]
    for t in range(PREFIX, SEQ):
        rl, rcache = decode(rp, _jax_inputs(_step_inputs(inputs, t)), rcache, t)
        rows.append(rl)
    return rows, rcache


def _reference_caches(model, rmodel, rcache):
    """The reference's caches, one dict a layer of the port and then one a
    shared site: layer i of group gj is ``rcache[gj][...][i - offset]``; the
    encoder keeps none."""
    out, at = [], 0
    for j, g in enumerate(rmodel.groups):
        for i in range(g.count):
            out.append({} if g.kind == "enc" else
                       {k: v[i] for k, v in rcache[f"g{j}"].items()})
        at += g.count
    for site in range(model.shared_sites()):
        out.append({k: v[site] for k, v in rcache["shared"].items()})
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_decode_and_caches_match_reference(arch):
    """Prefill of 16 tokens (the encoder-decoder: 24 frames and 16 tokens;
    qwen2-vl: the 8 patch embeddings first) and every decode step to 24;
    then every cache: conv and SSM state, each shared site's k/v, self k/v,
    cross k/v."""
    model, rmodel, rp = _pair(arch)
    inputs = _family_inputs(arch)
    enc_len = SEQ if model.cfg.family == "encdec" else 0
    want, rcache = _reference_run(rmodel, rp, inputs, enc_len)
    noise = _noise(lambda params: _reference_run(rmodel, params, inputs, enc_len)[0], rp)
    cache = model.init_cache(BATCH, SEQ, enc_len=enc_len)
    lg, _ = model.prefill(_torch_inputs(_prefill_inputs(inputs, PREFIX)), cache)
    rows = [lg]
    for t in range(PREFIX, SEQ):
        lg, _ = model.decode_step(_torch_inputs(_step_inputs(inputs, t)), cache, t)
        rows.append(lg)
    for got, w in zip(rows, want):
        _gate(got, w, noise)
    ref = _reference_caches(model, rmodel, rcache)
    assert len(cache) == len(ref) == len(model.layers) + model.shared_sites()
    for layer_cache, want_cache in zip(cache, ref):
        assert set(layer_cache) == set(want_cache)
        for k in layer_cache:
            assert layer_cache[k].dtype == getattr(torch, str(want_cache[k].dtype))
            _close(layer_cache[k], want_cache[k], rtol=1e-4, atol=1e-4)
    kinds = set(model.kinds())
    if "mamba" in kinds:
        assert cache[0]["state"].dtype == torch.float32
    if model.shared_sites():
        assert model.shared_sites() == 3 and cache[-1]["k"].abs().sum() > 0
    if "dec_cross" in kinds:
        assert cache[-1]["ck"].shape == (BATCH, model.cfg.num_heads, SEQ, model.cfg.head_dim)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_forward_in_the_port(arch):
    """Prefill + stepwise decode logits == full-forward logits (per position)."""
    cfg = configs.get_config(arch, reduced=True)
    model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 5))
    inputs = _torch_inputs(_family_inputs(arch, seed=2))
    with torch.no_grad():
        full = model.logits(model.forward(inputs))
    cache = model.init_cache(BATCH, SEQ, enc_len=SEQ if cfg.family == "encdec" else 0)
    lg, _ = model.prefill(_prefill_inputs(inputs, PREFIX), cache)
    errs = [float((lg[:, 0] - full[:, PREFIX - 1]).abs().max())]
    for t in range(PREFIX, SEQ):
        lg, _ = model.decode_step(_step_inputs(inputs, t), cache, t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_cross_cache_sized_for_other_frames_is_replaced_as_the_reference_returns_it():
    """A cache made with ``enc_len`` 0 (the reference ``Engine``'s default)
    takes the prefill's cross K/V as they come, and decodes as one sized
    for the frames."""
    model, _, _ = _pair("seamless-m4t-large-v2")
    inputs = _torch_inputs(_family_inputs("seamless-m4t-large-v2"))
    rows = []
    for enc_len in (SEQ, 0):
        cache = model.init_cache(BATCH, SEQ, enc_len=enc_len)
        model.prefill(_prefill_inputs(inputs, PREFIX), cache)
        assert cache[-1]["ck"].shape == (BATCH, model.cfg.num_heads, SEQ, model.cfg.head_dim)
        rows.append(model.decode_step(_step_inputs(inputs, PREFIX), cache, PREFIX)[0])
    assert torch.equal(rows[0], rows[1])


def test_mrope_positions_change_qwen2_vl_and_the_patches_take_the_prefix():
    """Positions whose coordinates differ change the output against ``arange``
    on all three (where M-RoPE is RoPE), and the first P tokens' ids no
    longer matter once patch embeddings take their place."""
    model, _, _ = _pair("qwen2-vl-72b")
    inputs = _torch_inputs(_family_inputs("qwen2-vl-72b"))
    plain = dict(inputs)
    plain["positions"] = torch.arange(SEQ)[None, :, None].expand(BATCH, SEQ, 3)
    other = dict(inputs)
    other["tokens"] = inputs["tokens"].clone()
    other["tokens"][:, :model.cfg.num_patches] = 0
    with torch.no_grad():
        h = model.forward(inputs)
        assert not torch.allclose(h, model.forward(plain))
        assert torch.equal(h, model.forward(other))
        with pytest.raises(ValueError, match="patch embeddings"):
            model.forward({**inputs, "tokens": inputs["tokens"][:, :4],
                           "positions": inputs["positions"][:, :4]})


def test_zamba2_shared_block_has_one_set_of_weights_and_a_cache_a_site():
    """One shared block's parameters (the reference's unstacked
    ``shared_attn`` tree), a KV cache for each of its sites: ceil(5 / 2) = 3
    in the reduced config, ceil(81 / 6) = 14 at full size."""
    model, rmodel, _ = _pair("zamba2-7b")
    names = sorted(n for n, _ in model.named_parameters() if n.startswith("shared_attn."))
    want = jax.tree_util.tree_flatten_with_path(rmodel.abstract_params()["shared_attn"],
                                                is_leaf=lambda x: hasattr(x, "init"))[0]
    assert names == sorted("shared_attn." + ".".join(k.key for k in path) for path, _ in want)
    assert model.shared_sites() == rmodel._n_shared_sites() == 3
    cache = model.init_cache(BATCH, SEQ)
    assert len(cache) == model.cfg.num_layers + 3
    assert [sorted(c) for c in cache[-3:]] == [["k", "v"]] * 3
    full = configs.get_config("zamba2-7b")
    assert math.ceil(full.num_layers / full.shared_attn_every) == RModel(
        rconfigs.get_config("zamba2-7b"))._n_shared_sites() == 14


def test_gemma2_local_global_masks_differ_in_the_port():
    cfg = configs.get_config("gemma2-2b", reduced=True)
    cfg_glob = dataclasses.replace(cfg, sliding_window=0, local_global_pattern=False)
    tree = reference_weights(cfg, 0)
    m1 = load_reference_params(Model(cfg, device="cpu"), tree)
    m2 = load_reference_params(Model(cfg_glob, device="cpu"), tree)
    assert m1.windows() == [16, 1 << 30] and m2.windows() == [None, None]
    toks = torch.as_tensor(_tokens("gemma2-2b", seq=32, seed=2))
    with torch.no_grad():
        h1, h2 = m1.forward({"tokens": toks}), m2.forward({"tokens": toks})
    # equal while every key lies inside the window, different past it
    assert torch.equal(h1[:, :16], h2[:, :16])
    assert not torch.allclose(h1[:, 16:], h2[:, 16:])


def test_model_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.get_config("gemma2-2b", reduced=True))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_config_field_equal_to_reference(arch, reduced):
    cfg, ref = configs.get_config(arch, reduced), rconfigs.get_config(arch, reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert (cfg.padded_vocab, cfg.q_dim, cfg.kv_dim) == (ref.padded_vocab, ref.q_dim, ref.kv_dim)


def test_registry_equal_to_reference():
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    assert configs.LP_WORKLOADS == rconfigs.LP_WORKLOADS
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for shape in configs.SHAPES.values():
            ref_shape = rconfigs.SHAPES[shape.name]
            assert (configs.cell_is_applicable(cfg, shape)
                    == rconfigs.cell_is_applicable(rconfigs.get_config(arch), ref_shape))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_make_inputs_bit_equal_to_reference(arch, kind):
    """Full configs (bfloat16 frames and patch embeddings), a small shape."""
    cfg = configs.get_config(arch)
    shape = configs.Shape("t", 8, 2, kind)
    got = configs.make_inputs(cfg, shape, seed=4, device="cpu")
    want = rconfigs.make_inputs(rconfigs.get_config(arch), rconfigs.Shape("t", 8, 2, kind), seed=4)
    specs = configs.input_specs(cfg, shape)
    ref_specs = rconfigs.input_specs(rconfigs.get_config(arch), rconfigs.Shape("t", 8, 2, kind))
    assert list(got) == list(want) == list(specs) == list(ref_specs)
    for k, t in got.items():
        w = np.asarray(want[k])
        assert specs[k].shape == ref_specs[k].shape == tuple(t.shape) == w.shape
        assert str(ref_specs[k].dtype) == specs[k].dtype
        if t.dtype == torch.bfloat16:  # compare the bits
            assert np.array_equal(t.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), w)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE + FAMILIES)
def test_weight_round_trip_is_the_identity(arch):
    cfg = configs.get_config(arch, reduced=True)
    tree = reference_weights(cfg, 9)
    back = reference_params(load_reference_params(Model(cfg, device="cpu"), tree))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, arr in flat:
        assert np.array_equal(arr, flat_back[path]), path


def test_reference_weights_follow_the_std_rule_and_layout():
    cfg = configs.get_config("gemma2-2b", reduced=True)
    tree = reference_weights(cfg, 0)
    ref_specs = RModel(rconfigs.get_config("gemma2-2b", reduced=True)).abstract_params()
    shapes = jax.tree_util.tree_map(lambda s: s.shape, ref_specs,
                                    is_leaf=lambda x: hasattr(x, "init"))
    assert jax.tree_util.tree_structure(shapes, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: a.shape, tree),
                                     is_leaf=lambda x: isinstance(x, tuple))
    wq = tree["g0"]["attn"]["wq"]  # (L, d, H, hd): std 1 / sqrt(H) on the stacked shape
    assert wq.shape == (2, 64, 4, 32)
    assert abs(wq.std() - 1 / math.sqrt(4)) < 0.02
    assert not tree["g0"]["ln_attn"].any() and not tree["final_norm"].any()
    again = reference_weights(cfg, 0)
    assert np.array_equal(again["embed"]["embedding"], tree["embed"]["embedding"])
    wide = reference_weights(cfg, 0, dtype="float64")["g0"]["ffn"]["wi"]
    assert wide.dtype == np.float64 and np.array_equal(wide, tree["g0"]["ffn"]["wi"])
    # a bfloat16 model casts the float32 arrays as JAX does (nearest, ties to even)
    m16 = load_reference_params(Model(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu"),
                                tree)
    want = np.asarray(jnp.asarray(tree["g0"]["ffn"]["wi"][1], jnp.bfloat16)).view(np.int16)
    assert np.array_equal(m16.layers[1].ffn["wi"].detach().view(torch.int16).numpy(), want)


def test_deepseek_groups_load_in_both_directions():
    """deepseek's two groups: ``g0`` (``mla_dense``, 1 layer, the dense FFN of
    width ``d_ff_dense``) into layer 0, ``g1`` (``mla_moe``) into layers 1-2,
    with the reference's leaf layout."""
    cfg = configs.get_config("deepseek-v2-lite-16b", reduced=True)
    tree = reference_weights(cfg, 4)
    ref_specs = RModel(rconfigs.get_config("deepseek-v2-lite-16b", reduced=True)).abstract_params()
    shapes = jax.tree_util.tree_map(lambda s: s.shape, ref_specs,
                                    is_leaf=lambda x: hasattr(x, "init"))
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, tree)
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    assert model.kinds() == ["mla_dense", "mla_moe", "mla_moe"]
    assert tree["g0"]["ffn"]["wi"].shape == (1, 64, 2 * 128)
    assert np.array_equal(model.layers[0].ffn["wi"].detach().numpy(), tree["g0"]["ffn"]["wi"][0])
    assert np.array_equal(model.layers[2].ffn["shared"]["wo"].detach().numpy(),
                          tree["g1"]["ffn"]["shared"]["wo"][1])
    assert model.layers[1].ffn["router"].dtype == torch.float32
    assert ("layers.1.ffn.shared.wi" in dict(model.named_parameters())
            and "shared" in model.layers[1].ffn and "shared" not in model.layers[0].ffn)


def test_load_reference_params_rejects_a_mismatch():
    cfg = configs.get_config("gemma2-2b", reduced=True)
    model = Model(cfg, device="cpu")
    tree = reference_weights(cfg, 0)
    tree["embed"]["extra"] = np.zeros((3,), np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_reference_params(model, tree)
    tree = reference_weights(cfg, 0)
    del tree["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        load_reference_params(model, tree)
    tree = reference_weights(cfg, 0)
    tree["g0"]["ffn"]["wo"] = tree["g0"]["ffn"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(model, tree)


def test_materialize_follows_the_std_rule_and_zeros_are_zeros():
    specs = {
        "w": ParamSpec((256, 400, 3), ("fsdp", None, None), dtype="float32", scale=2.0),
        "v": ParamSpec((5000,), (None,), dtype="float32", scale=0.5),
        "z": ParamSpec((7, 5), (None, None), dtype="bfloat16", init="zeros"),
        "o": ParamSpec((4,), (None,), dtype="float32", init="ones"),
    }
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = materialize(specs, gen, "cpu")
    assert abs(float(out["w"].std()) - 2.0 / math.sqrt(400)) < 2e-3
    assert abs(float(out["v"].std()) - 0.5) < 0.02
    assert out["z"].dtype == torch.bfloat16 and not out["z"].any()
    assert torch.equal(out["o"], torch.ones(4))
    again = materialize(specs, torch.Generator(device="cpu").manual_seed(0), "cpu", "float64")
    assert again["w"].dtype == torch.float64
    assert torch.equal(again["w"].float(), out["w"])


def test_model_init_draws_from_the_generator():
    cfg = configs.get_config("qwen1.5-4b", reduced=True)
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1), dtype_override="bfloat16")
    assert torch.equal(a.layers[1].attn["wq"].bfloat16(), b.layers[1].attn["wq"])
    assert not a.layers[0].attn["bq"].any() and not a.final_norm.any()
    assert abs(float(a.layers[0].ffn["wi"].detach().std()) - 1 / math.sqrt(64)) < 0.02
    toks = torch.as_tensor(_tokens("qwen1.5-4b"))
    with torch.no_grad():
        assert torch.isfinite(a.logits(a.forward({"tokens": toks}))).all()


# ---------------------------------------------------------------------------
# Layers and attention against the reference functions
# ---------------------------------------------------------------------------


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rmsnorm_rope_softcap_match_reference():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64, scale=0.1)
    _close(layers.rmsnorm(torch.as_tensor(x), torch.as_tensor(w), 1e-6),
           rlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    q = _rand(rng, 2, 3, 7, 16)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (10000.0, 1e6):
        _close(layers.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), theta),
               rlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), theta))
    s = _rand(rng, 40, scale=80.0)
    _close(layers.softcap(torch.as_tensor(s), 50.0), rlayers.softcap(jnp.asarray(s), 50.0),
           atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(1)
    x, wi, wo = _rand(rng, 2, 5, 32), _rand(rng, 32, 96, scale=0.2), _rand(rng, 48, 32, scale=0.2)
    _close(layers.mlp(torch.as_tensor(x), torch.as_tensor(wi), torch.as_tensor(wo), act),
           rlayers.mlp(jnp.asarray(x), {"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)}, act))


def test_embed_and_unembed_match_reference_with_a_padded_vocab():
    cfg = dataclasses.replace(configs.get_config("gemma2-2b", reduced=True), vocab_size=250)
    rcfg = dataclasses.replace(rconfigs.get_config("gemma2-2b", reduced=True), vocab_size=250)
    assert cfg.padded_vocab == 256
    rng = np.random.default_rng(2)
    table = _rand(rng, 256, 64, scale=0.1)
    toks = rng.integers(0, 250, (2, 6)).astype(np.int32)
    x = layers.embed(torch.as_tensor(toks), torch.as_tensor(table), cfg)
    rx = rlayers.embed(jnp.asarray(toks), {"embedding": jnp.asarray(table)}, rcfg)
    _close(x, rx)
    lg = layers.unembed(x, torch.as_tensor(table), cfg)
    _close(lg, rlayers.unembed(rx, {"embedding": jnp.asarray(table)}, rcfg))
    assert (lg[..., 250:] == -1e30).all()


def _exact_attention(q, k, v, window, cap):
    """Dense softmax attention in float64: the plain definition."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    g = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    s = q @ k.transpose(0, 1, 3, 2) / math.sqrt(q.shape[-1])
    if cap:
        s = cap * np.tanh(s / cap)
    qp, kp = np.arange(q.shape[2])[:, None], np.arange(k.shape[2])[None, :]
    mask = qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("window,cap", [(None, 0.0), (5, 50.0), (1 << 30, 0.0)])
def test_flash_attention_one_chunk_matches_reference(window, cap):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 4, 12, 8), _rand(rng, 2, 2, 12, 8), _rand(rng, 2, 2, 12, 8)
    got = attention.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                    window=window, chunk=512, attn_softcap=cap)
    _close(got, rattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=window, chunk=512, attn_softcap=cap))


@pytest.mark.parametrize("chunk", [1, 4, 5, 12])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (5, 50.0)])
def test_flash_attention_any_chunk_is_exact_softmax(chunk, window, cap):
    """Chunks of any length (a partial last chunk too) give the exact
    softmax: the port carries the running maximum across chunks."""
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 4, 12, 8), _rand(rng, 2, 2, 12, 8), _rand(rng, 2, 2, 12, 8)
    got = attention.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                    window=window, chunk=chunk, attn_softcap=cap)
    _close(got, _exact_attention(q, k, v, window, cap))


@pytest.mark.parametrize("index,window", [(0, None), (9, None), (9, 4), (15, 3), (15, 1 << 30)])
def test_decode_attention_matches_reference(index, window):
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 2, 4, 1, 8), _rand(rng, 2, 2, 16, 8), _rand(rng, 2, 2, 16, 8)
    got = attention.decode_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                     index, window=window, attn_softcap=50.0)
    _close(got, rattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), index,
                                       window=window, attn_softcap=50.0))


def test_layernorm_matches_reference():
    """Ported although the reference calls it nowhere."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 64, scale=3.0) + 1.5
    p = {"scale": _rand(rng, 64), "bias": _rand(rng, 64, scale=0.1)}
    got = layers.layernorm(torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in p.items()})
    _close(got, rlayers.layernorm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    specs = layers.layernorm_specs(64, "float32")
    ref = rlayers.layernorm_specs(64, "float32")
    assert {k: (v.shape, v.init) for k, v in specs.items()} == \
        {k: (v.shape, v.init) for k, v in ref.items()}


@pytest.mark.parametrize("sections,theta", [((4, 6, 6), 1e6), ((16, 24, 24), 1e6),
                                            ((2, 3, 3), 10000.0)])
def test_apply_mrope_matches_reference(sections, theta):
    """On positions whose (t, h, w) differ, where M-RoPE is not RoPE."""
    hd = 2 * sum(sections)
    rng = np.random.default_rng(hd)
    x = _rand(rng, 2, 3, 20, hd)
    pos = configs.mrope_positions(2, 20, 8, seed=hd)
    assert (pos[:, :8, 0] != pos[:, :8, 1]).any() and (pos[:, :8, 1] != pos[:, :8, 2]).any()
    got = layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections, theta)
    _close(got, rlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta))
    plain = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[..., 0]), theta)
    assert not torch.allclose(got, plain)  # the h and w sections rotate by their own coordinates
    same = np.broadcast_to(pos[..., :1], pos.shape).copy()
    assert torch.equal(layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(same), sections,
                                          theta),
                       layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[..., 0]), theta))


@pytest.mark.parametrize("s,d", [(24, 64), (4096, 1024), (7, 10)])
def test_sinusoidal_positions_equal_reference(s, d):
    got = layers.sinusoidal_positions(s, d)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(rlayers.sinusoidal_positions(s, d)))


@pytest.mark.parametrize("senc", [12, 40])
def test_cross_attention_matches_reference(senc):
    cfg = configs.get_config("seamless-m4t-large-v2", reduced=True)
    rcfg = rconfigs.get_config("seamless-m4t-large-v2", reduced=True)
    rng = np.random.default_rng(senc)
    p = {k: _rand(rng, *spec.shape, scale=0.2) for k, spec in attention.gqa_specs(cfg).items()}
    x, enc = _rand(rng, 2, 9, cfg.d_model), _rand(rng, 2, senc, cfg.d_model)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got, (k, v) = attention.cross_attention(torch.as_tensor(x), tp, cfg,
                                            enc_out=torch.as_tensor(enc))
    want, (rk, rv) = rattn.cross_attention(jnp.asarray(x), jp, rcfg, enc_out=jnp.asarray(enc))
    _close(got, want)
    _close(k, rk)
    _close(v, rv)
    assert k.shape == (2, cfg.num_heads, senc, cfg.head_dim)
    again, kv = attention.cross_attention(torch.as_tensor(x), tp, cfg, kv=(k, v))
    assert torch.equal(again, got) and kv[0] is k


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-72b"])
def test_encoder_attention_matches_reference(arch):
    """Bidirectional, rope on q and k; under qwen2-vl's config the M-RoPE
    branch of ``_proj`` on 3-D positions, with its biases."""
    cfg = configs.get_config(arch, reduced=True)
    rcfg = rconfigs.get_config(arch, reduced=True)
    rng = np.random.default_rng(7)
    p = {k: _rand(rng, *spec.shape, scale=0.2) for k, spec in attention.gqa_specs(cfg).items()}
    x = _rand(rng, 2, 14, cfg.d_model)
    if cfg.mrope_sections:
        pos = configs.mrope_positions(2, 14, cfg.num_patches, seed=3)
    else:
        pos = np.broadcast_to(np.arange(14, dtype=np.int32) + 5, (2, 14)).copy()
    got = attention.encoder_attention(torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in p.items()},
                                      cfg, torch.as_tensor(pos))
    want = rattn.encoder_attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rcfg,
                                   jnp.asarray(pos))
    _close(got, want)


def test_rope_takes_the_first_coordinate_of_3d_positions_without_mrope():
    """The reference's ``_project_qkv`` rotates by ``positions[..., 0]``
    when positions are 3-D and the config has no M-RoPE sections (the
    port's ``_proj``, for q and k with their biases)."""
    cfg = configs.get_config("qwen1.5-4b", reduced=True)
    rng = np.random.default_rng(8)
    p = {k: torch.as_tensor(_rand(rng, *spec.shape, scale=0.2))
         for k, spec in attention.gqa_specs(cfg).items()}
    x = torch.as_tensor(_rand(rng, 2, 6, cfg.d_model))
    pos3 = torch.as_tensor(configs.mrope_positions(2, 6, 4, seed=1))

    def qk(positions):
        return [attention._proj(x, p[w], p.get(b), cfg, positions, True)
                for w, b in (("wq", "bq"), ("wk", "bk"))]

    q3, k3 = qk(pos3)
    q2, k2 = qk(pos3[..., 0])
    assert torch.equal(q3, q2) and torch.equal(k3, k2)
