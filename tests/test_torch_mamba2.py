"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against the
reference ``repro.models.mamba2`` on NumPy-seeded inputs, float32.

Tolerance (``_close``): as ``tests/test_torch_models.py``, a relative L2
error of at most 1e-5 and a max abs error of at most 2e-5 times the
tensor's largest magnitude where that exceeds 1.  The scan cases use
sequences of 100 tokens: two chunks of 64 with padding, so the
inter-chunk recurrence and the padding both run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import Model as RModel
from repro.models import mamba2 as rmb
from repro_torch import configs
from repro_torch.models import Model
from repro_torch.models import mamba2 as mb
from repro_torch.models.convert import load_reference_params, reference_weights

RTOL, ATOL = 1e-5, 2e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    assert err <= atol * scale and rel <= rtol, (err, atol * scale, rel, rtol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _ssd_inputs(seed, b=2, s=100, h=4, p=8, g=1, n=16):
    rng = np.random.default_rng(seed)
    return dict(
        x=_rand(rng, b, s, h, p),
        dt=np.abs(_rand(rng, b, s, h, scale=0.5)),
        a=-np.exp(_rand(rng, h)),
        b_=_rand(rng, b, s, g, n),
        c_=_rand(rng, b, s, g, n),
        state=_rand(rng, b, h, p, n),
    )


def test_specs_equal_to_reference():
    for arch in ("mamba2-130m", "zamba2-7b"):
        for reduced in (False, True):
            cfg = configs.get_config(arch, reduced)
            rcfg = rconfigs.get_config(arch, reduced)
            got, want = mb.mamba_specs(cfg), rmb.mamba_specs(rcfg)
            assert sorted(got) == sorted(want)
            for k in got:
                assert (got[k].shape, got[k].dtype, got[k].init, got[k].scale) == \
                    (want[k].shape, want[k].dtype, want[k].init, want[k].scale), k
            assert mb.mamba_cache_specs(cfg, 3, cfg.dtype) == rmb.mamba_cache_specs(rcfg, 3,
                                                                                     rcfg.dtype)


@pytest.mark.parametrize("q", [1, 5, 64])
def test_segsum_matches_reference(q):
    x = _rand(np.random.default_rng(q), 2, 3, q)
    got, want = mb._segsum(_t(x)), np.asarray(rmb._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    finite = np.isfinite(want)
    _close(got.numpy()[finite], want[finite])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk,g", [(100, 64, 1), (128, 64, 1), (100, 100, 1), (37, 8, 2),
                                       (1, 64, 1)])
def test_ssd_chunked_matches_reference(s, chunk, g, with_state):
    """With padding (100 = 64 + 36; 37 = 4 x 8 + 5) and without (128, one
    chunk of 100, one token), from zeros and from an initial state, with
    one and two groups: y and the final state."""
    d = _ssd_inputs(s + chunk + g, s=s, g=g, h=4)
    init = d["state"] if with_state else None
    args = [d[k] for k in ("x", "dt", "a", "b_", "c_")]
    ry, rs = rmb._ssd_chunked(*(jnp.asarray(v) for v in args), chunk,
                              None if init is None else jnp.asarray(init))
    y, st = mb._ssd_chunked(*(_t(v) for v in args), chunk, None if init is None else _t(init))
    assert y.dtype == st.dtype == torch.float32
    _close(y, ry)
    _close(st, rs)


@pytest.mark.parametrize("s", [3, 4, 40])
def test_causal_conv_matches_reference(s):
    """From the conv window's length up (the reference's padded taps do not
    fit a shorter sequence; its mixer takes one token with a cache through
    the decode branch)."""
    rng = np.random.default_rng(s)
    x, w, b = _rand(rng, 2, s, 24), _rand(rng, 4, 24, scale=0.5), _rand(rng, 24, scale=0.1)
    got = mb._causal_conv(_t(x), _t(w), _t(b))
    _close(got, rmb._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


def _mixer_params(cfg, seed):
    """The reference's specs drawn by ``reference_weights``'s rule, one layer."""
    tree = reference_weights(cfg, seed)
    return {k: v[0] for k, v in tree["g0"]["mixer"].items()}


@pytest.mark.parametrize("s", [100, 3, 1])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_mixer_prefill_decode_and_caches_match_reference(arch, s):
    """The mixer with a cache: a prefill of ``s`` tokens (100: chunks and
    padding; 3: the conv window's length, one chunk; 1: the decode branch,
    as the reference takes it with a cache and one token), then four decode
    steps; the outputs and both cache tensors after each."""
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True), ssm_chunk=64)
    rcfg = dataclasses.replace(rconfigs.get_config(arch, reduced=True), ssm_chunk=64)
    p = _mixer_params(cfg, 4)
    rng = np.random.default_rng(s)
    x = _rand(rng, 2, s + 4, cfg.d_model)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    rcache = {k: jnp.zeros(shape, dt) for k, (shape, dt) in
              rmb.mamba_cache_specs(rcfg, 2, "float32").items()}
    cache = {k: torch.zeros(shape, dtype=getattr(torch, dt)) for k, (shape, dt) in
             mb.mamba_cache_specs(cfg, 2, "float32").items()}
    ry, rcache = rmb.mamba_mixer(jnp.asarray(x[:, :s]), rp, rcfg, cache=rcache, cache_index=0)
    y, out = mb.mamba_mixer(_t(x[:, :s]), tp, cfg, cache=cache, cache_index=0)
    assert out is cache
    _close(y, ry)
    _close(cache["conv"], rcache["conv"])
    _close(cache["state"], rcache["state"])
    assert cache["state"].dtype == torch.float32
    for t in range(s, s + 4):
        ry, rcache = rmb.mamba_mixer(jnp.asarray(x[:, t:t + 1]), rp, rcfg, cache=rcache,
                                     cache_index=t)
        y, _ = mb.mamba_mixer(_t(x[:, t:t + 1]), tp, cfg, cache=cache, cache_index=t)
        _close(y, ry)
        _close(cache["conv"], rcache["conv"])
        _close(cache["state"], rcache["state"])


def test_mixer_without_cache_matches_reference():
    cfg = configs.get_config("mamba2-130m", reduced=True)
    rcfg = rconfigs.get_config("mamba2-130m", reduced=True)
    p = _mixer_params(cfg, 6)
    x = _rand(np.random.default_rng(6), 2, 100, cfg.d_model)
    ry, rc = rmb.mamba_mixer(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rcfg)
    y, c = mb.mamba_mixer(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    assert rc is None and c is None
    _close(y, ry)


@pytest.mark.parametrize("s", [10, 3])
def test_prefill_conv_cache_is_the_pre_convolution_input(s):
    """The conv cache after a prefill holds the last ssm_conv - 1 rows of
    the in-projection's ``xbc`` part, before the convolution."""
    cfg = configs.get_config("mamba2-130m", reduced=True)
    p = {k: _t(v) for k, v in _mixer_params(cfg, 7).items()}
    x = _t(_rand(np.random.default_rng(7), 2, s, cfg.d_model))
    cache = {k: torch.zeros(shape, dtype=getattr(torch, dt)) for k, (shape, dt) in
             mb.mamba_cache_specs(cfg, 2, "float32").items()}
    mb.mamba_mixer(x, p, cfg, cache=cache, cache_index=0)
    di, conv_ch = cfg.d_inner, cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    xbc = (x @ p["in_proj"])[..., di:di + conv_ch]
    assert torch.equal(cache["conv"], xbc[:, -(cfg.ssm_conv - 1):])


def test_mamba2_state_continuity():
    """Prefill of s - 1 tokens then one decode step equals the full forward
    at the last position (the twin of ``tests/test_models.py::
    test_mamba2_state_continuity``, on the reference's weights), and the
    port's logits there match the reference's."""
    cfg = configs.get_config("mamba2-130m", reduced=True)
    rcfg = rconfigs.get_config("mamba2-130m", reduced=True)
    tree = reference_weights(cfg, 0)
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    s, b = 24, 2
    inputs = configs.make_inputs(cfg, configs.Shape("t", s, b, "train"), seed=3, device="cpu")
    with torch.no_grad():
        full = model.logits(model.forward({"tokens": inputs["tokens"]}))
    cache = model.init_cache(b, s)
    model.prefill({"tokens": inputs["tokens"][:, :s - 1]}, cache)
    lg, _ = model.decode_step({"tokens": inputs["tokens"][:, s - 1:]}, cache, s - 1)
    err = float((lg[:, 0] - full[:, -1]).abs().max())
    assert err < 2e-4, err

    rmodel = RModel(rcfg)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rcache = rmodel.init_cache(b, s)
    _, rcache = rmodel.prefill(rp, {"tokens": jnp.asarray(inputs["tokens"][:, :s - 1].numpy())},
                               rcache)
    rlg, _ = rmodel.decode_step(rp, {"tokens": jnp.asarray(inputs["tokens"][:, s - 1:].numpy())},
                                rcache, s - 1)
    _close(lg, rlg)


def test_a_zeroed_state_handoff_breaks_continuity():
    """The same check fails when the state is zeroed between the prefill and
    the decode step: the gate sees a lost handoff."""
    cfg = configs.get_config("mamba2-130m", reduced=True)
    model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 0))
    s, b = 24, 2
    toks = configs.make_inputs(cfg, configs.Shape("t", s, b, "train"), seed=3,
                               device="cpu")["tokens"]
    with torch.no_grad():
        full = model.logits(model.forward({"tokens": toks}))
    cache = model.init_cache(b, s)
    model.prefill({"tokens": toks[:, :s - 1]}, cache)
    for c in cache:
        c["state"].zero_()
    lg, _ = model.decode_step({"tokens": toks[:, s - 1:]}, cache, s - 1)
    assert float((lg[:, 0] - full[:, -1]).abs().max()) > 1e-2
