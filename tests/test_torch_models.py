"""The port's LMs (``repro_torch.models``, ``configs``, ``sharding``): the
dense family, and the MoE family (dbrx's GQA + MoE, deepseek-v2-lite's
MLA + MoE) under both routers, against the reference ``repro.models.Model``
on reduced configs.

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
from repro_torch.models import Model, attention, layers
from repro_torch.models.convert import (load_reference_params, reference_params,
                                        reference_weights)
from repro_torch.sharding import ParamSpec, materialize

DENSE = ["gemma2-2b", "qwen1.5-4b", "internlm2-20b", "command-r-plus-104b"]
MOE = ["dbrx-132b", "deepseek-v2-lite-16b"]
ROUTERS = ["topk", "lp"]
NOT_PORTED = ["mamba2-130m", "zamba2-7b", "qwen2-vl-72b", "seamless-m4t-large-v2"]
RTOL, ATOL = 1e-5, 2e-5
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


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_families_not_ported_raise(arch):
    cfg = configs.get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(cfg, device="cpu")


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


@pytest.mark.parametrize("arch", DENSE + MOE)
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
