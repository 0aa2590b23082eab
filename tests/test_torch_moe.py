"""The port's MoE FFN and its LP router (``repro_torch.models.moe``) against
the reference ``repro.models.moe`` on NumPy-seeded inputs, float32.

The router's LP goes through ``kernels/ops.py:simplex_solve`` on CPU
tensors (the simplex kernel's plain version); on the reference's own LP
inputs it must give ``repro.core.simplex.solve_batched``'s status,
iterations and basis, with ``x`` within 1e-5 relative.  The FFN outputs
are held to the models' parity tolerance (``tests/test_torch_models.py``).
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import simplex as rsimplex
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import moe

RTOL, ATOL = 1e-5, 2e-5
ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b"]


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    assert err <= atol * scale and rel <= rtol, (err, atol * scale, rel, rtol)


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_config(arch, reduced=True), **kw),
            dataclasses.replace(rconfigs.get_config(arch, reduced=True), **kw))


def _ffn_params(cfg, seed):
    """NumPy FFN parameters by the reference's specs (router float32)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(rmoe.moe_specs(cfg).items()):
        if isinstance(spec, dict):
            out[name] = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
                         for k, s in sorted(spec.items())}
        else:
            out[name] = (rng.standard_normal(spec.shape) / np.sqrt(spec.shape[-2])).astype(np.float32)
    return out


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class _Spy:
    """Records the reference router's LP solves (its inputs and solution)."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = rsimplex.solve_batched

        def spy(a, b, c, **kw):
            sol = orig(a, b, c, **kw)
            self.calls.append(dict(a=np.asarray(a), b=np.asarray(b), c=np.asarray(c), kw=kw,
                                   status=np.asarray(sol.status),
                                   iterations=np.asarray(sol.iterations),
                                   basis=np.asarray(sol.basis), x=np.asarray(sol.x)))
            return sol

        monkeypatch.setattr(rsimplex, "solve_batched", spy)


# ---------------------------------------------------------------------------
# Capacity and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-v2-lite-16b-full"])
def test_capacity_matches_reference(arch):
    full = arch.endswith("-full")
    name = arch.removesuffix("-full")
    cfg, rcfg = configs.get_config(name, not full), rconfigs.get_config(name, not full)
    for t in (1, 2, 7, 8, 24, 80, 1000, 32768):
        for factor in (0.5, 1.25, float(cfg.num_experts)):
            c = moe._capacity(t, dataclasses.replace(cfg, capacity_factor=factor))
            assert c == rmoe._capacity(t, dataclasses.replace(rcfg, capacity_factor=factor))
            assert c % 8 == 0 and c >= 8
    if full:  # decode with 8 sequences, and a prefill of 8 x 4,096 tokens
        assert (moe._capacity(8, cfg), moe._capacity(32768, cfg)) == (8, 3840)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference_with_a_planted_tie(arch):
    """Two router columns are equal, so every token's logits tie there:
    the lower expert index comes first, as ``jax.lax.top_k`` orders it."""
    cfg, rcfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    router = rng.standard_normal((cfg.d_model, cfg.num_experts)).astype(np.float32)
    router[:, 3] = router[:, 1]
    # the tied pair leads every token's logits
    router[:, [1, 3]] += 10.0 * np.abs(router).max()
    x = rng.standard_normal((24, cfg.d_model)).astype(np.float32)
    x[:, :] = np.abs(x) + 0.1
    w, e = moe.route(torch.as_tensor(x), {"router": torch.as_tensor(router)}, cfg)
    rw, re_ = rmoe.route(jnp.asarray(x), {"router": jnp.asarray(router)}, rcfg)
    assert np.array_equal(e.numpy(), np.asarray(re_))
    assert (e[:, 0] == 1).all() and (e[:, 1] == 3).all()
    _close(w, rw)


# ---------------------------------------------------------------------------
# The LP router
# ---------------------------------------------------------------------------


def _logits(rng, t, e, scale=1.0):
    return (rng.standard_normal((t, e)) * scale).astype(np.float32)


@pytest.mark.parametrize("arch,t", [("deepseek-v2-lite-16b", 24), ("deepseek-v2-lite-16b", 2),
                                    ("dbrx-132b", 24), ("dbrx-132b", 5)])
def test_lp_balance_bias_matches_reference(arch, t, monkeypatch):
    cfg, rcfg = _cfgs(arch, router="lp")
    logits = _logits(np.random.default_rng(t), t, cfg.num_experts, scale=2.0)
    spy = _Spy(monkeypatch)
    want = np.asarray(rmoe._lp_balance_bias(None, jnp.asarray(logits), rcfg))
    got = moe._lp_balance_bias(torch.as_tensor(logits), cfg)
    # the LP the port builds is the reference's: a and b exactly, c within rounding
    (ref,) = spy.calls
    a, b, c, groups = moe.lp_router_problem(torch.as_tensor(logits), cfg)
    assert np.array_equal(a.numpy(), ref["a"]) and a.dtype == torch.float32
    assert np.array_equal(b.numpy(), ref["b"].astype(np.float32)) and b.dtype == torch.float32
    _close(c, ref["c"], rtol=1e-6)
    assert ref["kw"] == {"max_iters": 8 * (a.shape[1] + a.shape[2])}
    assert np.array_equal(groups.numpy(), np.arange(t) % cfg.router_groups)
    _close(got, want)
    assert got.shape == (t, cfg.num_experts) and got.dtype == torch.float32


@pytest.mark.parametrize("g,e,t,seed", [(8, 8, 24, 0), (8, 4, 24, 1), (8, 64, 8, 2),
                                        (8, 64, 80, 3), (4, 16, 40, 4)])
def test_router_lp_on_the_plain_version_matches_solve_batched(g, e, t, seed, monkeypatch):
    """The reference's own LP inputs (G + E rows, G*E variables; 72 x 512 is
    deepseek-v2-lite at full width) through ``ops.simplex_solve`` on CPU
    tensors: the reference's status, iterations and basis, x within 1e-5."""
    rcfg = dataclasses.replace(rconfigs.get_config("deepseek-v2-lite-16b"), num_experts=e,
                               router_groups=g, router="lp")
    spy = _Spy(monkeypatch)
    rmoe._lp_balance_bias(None, jnp.asarray(_logits(np.random.default_rng(seed), t, e)), rcfg)
    (ref,) = spy.calls
    a, b, c = (torch.tensor(ref[k]).float() for k in ("a", "b", "c"))
    sol = ops.simplex_solve(a, b, c, **ref["kw"])
    assert np.array_equal(sol.status.numpy(), ref["status"])
    assert np.array_equal(sol.iterations.numpy(), ref["iterations"])
    assert np.array_equal(sol.basis.numpy(), ref["basis"])
    scale = max(1.0, float(np.abs(ref["x"]).max()))
    assert float(np.abs(sol.x.numpy() - ref["x"]).max()) <= 1e-5 * scale
    assert int(ref["status"][0]) == 1 and int(ref["iterations"][0]) > 0


def test_the_router_lp_goes_to_the_simplex_wrapper(monkeypatch):
    """``route`` with ``router="lp"`` solves one LP a call through
    ``simplex_cuda.simplex`` (the kernel's wrapper, here its plain version)."""
    from repro_torch.kernels import simplex_cuda

    cfg, _ = _cfgs("deepseek-v2-lite-16b", router="lp")
    calls = []
    orig = simplex_cuda.simplex

    def counted(*args, **kw):
        calls.append(kw["spec"])
        return orig(*args, **kw)

    monkeypatch.setattr(simplex_cuda, "simplex", counted)
    rng = np.random.default_rng(5)
    p = _torch_tree(_ffn_params(cfg, 5))
    moe.route(torch.as_tensor(rng.standard_normal((10, cfg.d_model)).astype(np.float32)), p, cfg)
    assert [(s.m, s.n) for s in calls] == [(16, 64)]
    moe.route(torch.as_tensor(rng.standard_normal((10, cfg.d_model)).astype(np.float32)), p,
              dataclasses.replace(cfg, router="topk"))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# The FFN: dispatch, experts, combine, shared experts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router", ["topk", "lp"])
@pytest.mark.parametrize("arch,factor,drops", [
    ("deepseek-v2-lite-16b", 0.5, True), ("deepseek-v2-lite-16b", 8.0, False),
    ("dbrx-132b", 0.5, True), ("dbrx-132b", 4.0, False)])
def test_moe_ffn_matches_reference(arch, factor, drops, router):
    cfg, rcfg = _cfgs(arch, capacity_factor=factor, router=router)
    params = _ffn_params(cfg, 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    got = moe.moe_ffn(torch.as_tensor(x), _torch_tree(params), cfg)
    want = rmoe.moe_ffn(jnp.asarray(x), _jax_tree(params), rcfg)
    _close(got, want)
    # whether this case drops tokens, read from the dispatch itself
    t = x.shape[0] * x.shape[1]
    _, experts = moe.route(torch.as_tensor(x).reshape(t, -1), _torch_tree(params), cfg)
    _, _, keep = moe.dispatch(experts, moe._capacity(t, cfg), cfg.num_experts)
    assert bool((~keep).any()) is drops
    assert int(keep.sum()) <= cfg.num_experts * moe._capacity(t, cfg)


def test_moe_ffn_combines_in_ascending_expert_order():
    """Each token's kept outputs are summed in ascending expert order: the
    combine equals that sum written out."""
    cfg, _ = _cfgs("deepseek-v2-lite-16b", capacity_factor=8.0, num_shared_experts=0)
    p = _torch_tree(_ffn_params(cfg, 9))
    x = torch.as_tensor(np.random.default_rng(10).standard_normal((2, 8, cfg.d_model))
                        .astype(np.float32))
    got = moe.moe_ffn(x, p, cfg).reshape(16, -1)
    w, e = moe.route(x.reshape(16, -1), p, cfg)
    for tok in range(16):
        y = torch.zeros(cfg.d_model)
        for j in torch.argsort(e[tok]).tolist():
            h = x.reshape(16, -1)[tok] @ p["wi"][e[tok, j]]
            g, u = h.chunk(2)
            y = y + (torch.nn.functional.silu(g) * u) @ p["wo"][e[tok, j]] * w[tok, j]
        assert torch.allclose(got[tok], y, rtol=1e-5, atol=1e-6)


def test_dispatch_slots_and_scratch_row():
    experts = torch.tensor([[0, 1], [1, 0], [1, 2], [1, 0]])
    order, slot, keep = moe.dispatch(experts, cap=2, num_experts=3)
    # sorted by expert, stable: expert 0 rows (t0, t1, t3), 1 (t0, t1, t2, t3), 2 (t2)
    assert order.tolist() == [0, 3, 7, 1, 2, 4, 6, 5]
    assert keep.tolist() == [True, True, False, True, True, False, False, True]
    assert slot.tolist() == [0, 1, 6, 2, 3, 6, 6, 4]
