"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's ``repro.train.optimizer`` on random trees.

The update follows the reference's order of operations in float32.  It
is not bit-equal: XLA's CPU backend contracts multiply-add pairs into
fused multiply-adds and sums the global norm's squares in another order,
so ``grad_norm``, and through the clip scale ``m``, ``v``, the master
weights and the parameters, agree within ``ULPS`` float32 ulps of each
leaf's largest magnitude (the bfloat16 parameters exactly), and ``lr``
exactly.  ``torch.optim.AdamW`` computes the same step in another order
(it divides ``sqrt(v)`` by ``sqrt(1 - b2^t)`` and decays the weights
before the step) and rounds differently.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ropt
from repro_torch.train import optimizer as opt

#: A float32 sum of 2,284 squares in another order moves the global norm by
#: up to a few ulps, and the clip scale carries that into every leaf.
ULPS = 16
SHAPES = {"a": (64, 33), "b": (7,), "c": (3, 5, 11)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _torch(arr, dtype):
    """A NumPy float32 array as a tensor of ``dtype`` (bfloat16 by round to
    nearest even, as ``jnp.asarray(..., bfloat16)`` rounds it), always in
    memory of its own.

    JAX on the CPU takes a 64-byte-aligned NumPy array without a copy, so
    ``jnp.asarray(arr)`` may alias ``arr``; whether ``default_rng``'s draws
    land so aligned depends on what the process allocated before.  A tensor
    sharing ``arr``'s memory would let the port's in-place update rewrite
    the reference's input while the reference's asynchronously dispatched
    step may still read it."""
    return torch.tensor(arr).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _within_ulps(got, want, ulps=ULPS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ulps * np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("clip,master", [(1.0, True), (1e9, True), (1.0, False)])
def test_update_matches_reference(dtype, clip, master):
    """Four steps on the same gradients: every state leaf, the parameters,
    ``lr`` and ``grad_norm``, with the clip on (norms near 14) and off,
    with and without float32 master weights."""
    rng = np.random.default_rng(7)
    kw = dict(lr=1e-2, grad_clip=clip, warmup_steps=3, master_weights=master)
    p0 = _tree(rng)
    rp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    rstate = ropt.init(rp, ropt.OptConfig(**kw))
    params = {k: _torch(v, dtype) for k, v in p0.items()}
    state = opt.init(params, opt.OptConfig(**kw))
    rupdate = jax.jit(lambda g, s, p: ropt.update(g, s, p, ropt.OptConfig(**kw)))
    for _ in range(4):
        g = _tree(rng, 0.3)
        rp, rstate, rm = rupdate({k: jnp.asarray(v, dtype) for k, v in g.items()}, rstate, rp)
        state, m = opt.update({k: _torch(v, dtype) for k, v in g.items()}, state, params,
                              opt.OptConfig(**kw))
        assert float(m["lr"]) == float(rm["lr"]) and m["lr"].dtype == torch.float32
        assert m["grad_norm"].dtype == torch.float32
        _within_ulps(float(m["grad_norm"]), float(rm["grad_norm"]))
    assert int(state.step) == int(rstate.step) == 4 and state.step.dtype == torch.int32
    for k in SHAPES:
        assert params[k].dtype == getattr(torch, dtype)
        _within_ulps(state.m[k].numpy(), np.asarray(rstate.m[k]))
        _within_ulps(state.v[k].numpy(), np.asarray(rstate.v[k]))
        want = np.asarray(rp[k].astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(params[k]), want)
        else:
            _within_ulps(_np(params[k]), want)
        if master:
            assert state.master[k].dtype == torch.float32
            _within_ulps(state.master[k].numpy(), np.asarray(rstate.master[k]))
    assert (state.master is None) == (rstate.master is None) == (not master)


def _aligned(arr, offset):
    """``arr``'s values in a buffer whose address is ``offset`` bytes past a
    multiple of 64: at 0, ``jnp.asarray`` aliases it."""
    buf = np.empty(arr.nbytes + 128, np.uint8)
    start = (-buf.ctypes.data) % 64 + offset
    out = buf[start:start + arr.nbytes].view(arr.dtype).reshape(arr.shape)
    out[...] = arr
    return out


@pytest.mark.parametrize("offset", [0, 16])
def test_update_matches_reference_on_inputs_jax_aliases(monkeypatch, offset):
    """The state the failing case inherited from earlier tests: inputs on
    64-byte-aligned buffers, which ``jnp.asarray`` aliases.  The port's
    tensors hold copies, its in-place step leaves the reference's input
    as it was, and the case passes (at offset 16 JAX copies: the control)."""
    p = _aligned(np.arange(8, dtype=np.float32), offset)
    j = jnp.asarray(p)
    p[0] = -1.0
    assert (float(j[0]) == -1.0) == (offset == 0)  # aliased only when aligned
    p[0] = 0.0

    params = {"w": _torch(p, "float32")}
    state = opt.init(params, opt.OptConfig(master_weights=False))
    opt.update({"w": torch.ones(8)}, state, params, opt.OptConfig(master_weights=False))
    assert not np.shares_memory(params["w"].numpy(), p)
    np.testing.assert_array_equal(np.asarray(j), np.arange(8, dtype=np.float32))

    plain = _tree
    monkeypatch.setattr(sys.modules[__name__], "_tree",
                        lambda rng, scale=1.0: {k: _aligned(v, offset)
                                                for k, v in plain(rng, scale).items()})
    test_update_matches_reference("float32", 1.0, False)


def test_update_in_slices_equals_one_pass(monkeypatch):
    """A leaf updated in slices of ``SLICE`` elements takes the same bits."""
    rng = np.random.default_rng(3)
    p0, g = _tree(rng), _tree(rng, 0.3)
    runs = []
    for size in (opt.SLICE, 5):
        monkeypatch.setattr(opt, "SLICE", size)
        params = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
        state = opt.init(params, opt.OptConfig())
        state, _ = opt.update({k: torch.as_tensor(v) for k, v in g.items()}, state, params,
                              opt.OptConfig())
        runs.append((params, state))
    for k in SHAPES:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
        assert torch.equal(runs[0][1].m[k], runs[1][1].m[k])
        assert torch.equal(runs[0][1].master[k], runs[1][1].master[k])


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = opt.OptConfig(lr=0.3, warmup_steps=1, weight_decay=0.0)
    state = opt.init(params, cfg)
    for _ in range(150):
        state, _ = opt.update({"w": 2 * params["w"]}, state, params, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_limits_norm():
    params = {"w": torch.tensor([1.0])}
    cfg = opt.OptConfig(lr=1e-3, grad_clip=0.5, warmup_steps=1)
    state = opt.init(params, cfg)
    state, m = opt.update({"w": torch.tensor([100.0])}, state, params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(100.0)
    # the clipped gradient is 0.5: m holds (1 - b1) * 0.5
    assert float(state.m["w"]) == pytest.approx(0.1 * 0.5, rel=1e-6)


def test_torch_adamw_rounds_differently():
    """``torch.optim.AdamW`` with the same hyperparameters, no clip and
    no master copy, takes a step close to the reference's but not the same
    bits; the port's update is nearer the reference's."""
    rng = np.random.default_rng(11)
    p0 = _tree(rng)
    kw = dict(lr=1e-2, grad_clip=1e9, warmup_steps=1, master_weights=False, weight_decay=0.1)
    params = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    state = opt.init(params, opt.OptConfig(**kw))
    torch_params = [torch.nn.Parameter(torch.as_tensor(p0[k].copy())) for k in SHAPES]
    adamw = torch.optim.AdamW(torch_params, lr=kw["lr"], betas=(0.9, 0.95), eps=1e-8,
                              weight_decay=kw["weight_decay"], foreach=False)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rstate = ropt.init(rp, ropt.OptConfig(**kw))
    rupdate = jax.jit(lambda g, s, p: ropt.update(g, s, p, ropt.OptConfig(**kw)))
    for _ in range(5):
        g = _tree(rng, 0.3)
        state, _ = opt.update({k: torch.as_tensor(v) for k, v in g.items()}, state, params,
                              opt.OptConfig(**kw))
        for p, k in zip(torch_params, SHAPES):
            p.grad = torch.as_tensor(g[k])
        adamw.step()
        rp, rstate, _ = rupdate({k: jnp.asarray(v) for k, v in g.items()}, rstate, rp)
    ours = np.concatenate([params[k].numpy().ravel() for k in SHAPES])
    theirs = np.concatenate([p.detach().numpy().ravel() for p in torch_params])
    ref = np.concatenate([np.asarray(rp[k]).ravel() for k in SHAPES])
    np.testing.assert_allclose(theirs, ref, rtol=1e-5, atol=1e-6)
    assert not np.array_equal(theirs, ours)
    assert (theirs != ref).sum() > (ours != ref).sum()
