"""The catalog's last five configurations (qwen1.5-4b, internlm2-20b,
dbrx-132b, command-r-plus-104b, qwen2-vl-72b) on the CPU, without their
weights: dbrx's router LP at its full-width shape against the reference's,
each config's parameter tree at full width on the ``meta`` device against
the reference's spec tree, ``Model.init``'s draws, ``chip_smoke.py``'s
slice-16 phase rehearsed on the reduced configs, and the committed
catalog fixtures' metadata.

The router LP depends only on G, E, top-k and the capacity factor, so the
reduced dbrx with dbrx's 16 experts and top-4 builds the 24 x 128 LP that
every MoE layer of the full model solves.  The port's LP goes through
``kernels/ops.py:simplex_solve`` on CPU tensors (the simplex kernel's plain
version); it must give the reference's status, iterations and basis, and
the bias within 1e-5 relative in float32 (the parity contract's x gate)
and 1e-9 in float64.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import simplex as rsimplex
from repro.models import Model as RModel
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import Model, moe
from repro_torch.models.convert import reference_leaf_of
from repro_torch.sharding import leaves, materialize
from test_torch_lm_serve import _module, _ReducedConfigs, _stub_the_card

ROOT = Path(__file__).resolve().parents[1]
CATALOG = ["qwen1.5-4b", "internlm2-20b", "dbrx-132b", "command-r-plus-104b", "qwen2-vl-72b"]
#: dbrx's router at full width: experts, experts a token, token groups.
DBRX_E, DBRX_K, DBRX_G = 16, 4, 8
#: Tokens of the router LP's test: 512 (64 a group).
ROUTER_TOKENS = 512
BIAS_RTOL = {"float32": 1e-5, "float64": 1e-9}


# ---------------------------------------------------------------------------
# dbrx's router LP at its real shape
# ---------------------------------------------------------------------------


def _dbrx_router_cfgs():
    kw = dict(num_experts=DBRX_E, top_k=DBRX_K, router="lp")
    cfg = dataclasses.replace(configs.get_config("dbrx-132b", reduced=True), **kw)
    rcfg = dataclasses.replace(rconfigs.get_config("dbrx-132b", reduced=True), **kw)
    full = configs.get_config("dbrx-132b")
    assert (cfg.num_experts, cfg.top_k, cfg.router_groups, cfg.capacity_factor) == \
        (full.num_experts, full.top_k, full.router_groups, full.capacity_factor) == \
        (DBRX_E, DBRX_K, DBRX_G, full.capacity_factor)
    return cfg, rcfg


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dbrx_router_lp_at_its_full_width_shape_matches_the_reference(dtype, monkeypatch):
    """512 tokens of NumPy-seeded router logits through the port's
    ``_lp_balance_bias`` and the reference's: the same 24 x 128 LP, solved
    to the same status, iterations and basis, and the same bias."""
    cfg, rcfg = _dbrx_router_cfgs()
    logits = (np.random.default_rng(16).standard_normal((ROUTER_TOKENS, DBRX_E)) * 2.0
              ).astype(dtype)
    ref_calls, port_calls = [], []
    rsolve, psolve = rsimplex.solve_batched, ops.simplex_solve

    def rspy(a, b, c, **kw):
        sol = rsolve(a, b, c, **kw)
        ref_calls.append({k: np.asarray(v) for k, v in
                          dict(a=a, status=sol.status, iterations=sol.iterations,
                               basis=sol.basis, x=sol.x).items()})
        return sol

    def pspy(a, b, c, **kw):
        sol = psolve(a, b, c, **kw)
        port_calls.append(dict(a=a, status=sol.status, iterations=sol.iterations,
                               basis=sol.basis, x=sol.x))
        return sol

    monkeypatch.setattr(rsimplex, "solve_batched", rspy)
    monkeypatch.setattr(ops, "simplex_solve", pspy)
    want = np.asarray(rmoe._lp_balance_bias(None, jnp.asarray(logits), rcfg))
    got = moe._lp_balance_bias(torch.as_tensor(logits), cfg)
    (ref,), (port,) = ref_calls, port_calls
    assert port["a"].shape == ref["a"].shape == (1, DBRX_G + DBRX_E, DBRX_G * DBRX_E)
    assert np.array_equal(port["a"].numpy(), ref["a"])
    assert np.array_equal(port["status"].numpy(), ref["status"]) and int(ref["status"][0]) == 1
    assert np.array_equal(port["iterations"].numpy(), ref["iterations"])
    assert int(ref["iterations"][0]) > 0
    assert np.array_equal(port["basis"].numpy(), ref["basis"])
    assert got.dtype == getattr(torch, dtype) and got.shape == (ROUTER_TOKENS, DBRX_E)
    got = got.numpy().astype(np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BIAS_RTOL[dtype], rel


# ---------------------------------------------------------------------------
# The five configurations at full width, without a byte of weights
# ---------------------------------------------------------------------------


def _reference_shapes(rcfg):
    """The reference's parameter tree at full width: each leaf's shape by
    its ``/``-joined path (``abstract_params`` allocates nothing)."""
    tree = RModel(rcfg).abstract_params()
    return {"/".join(path): tuple(spec.shape) for path, spec in leaves(tree)}


@pytest.mark.parametrize("arch", CATALOG)
def test_full_width_parameter_tree_on_meta_matches_the_reference(arch):
    """``Model`` at full width and depth on the ``meta`` device: each
    parameter maps to a reference leaf (``reference_leaf_of``), the layers
    of a leaf stack to its shape, no leaf is missing or extra, and
    ``param_count()`` (equal in both packages) is the parameters' count
    without what it leaves out: the norms' and biases' vectors, and the
    vocabulary's padding rows."""
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    model = Model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    named = dict(model.named_parameters())
    by_leaf = {}
    for name, leaf in reference_leaf_of(model).items():
        by_leaf.setdefault(leaf, []).append(tuple(named[name].shape))
    got = {}
    for leaf, shapes in by_leaf.items():
        assert len(set(shapes)) == 1, (leaf, set(shapes))
        stacked = leaf.split("/")[0].startswith("g") and leaf.split("/")[0][1:].isdigit()
        got[leaf] = ((len(shapes),) + shapes[0]) if stacked else shapes[0]
    assert got == _reference_shapes(rcfg)
    count = sum(p.numel() for p in model.parameters())
    vectors = sum(p.numel() for name, p in named.items()
                  if p.dim() == 1 or name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"))
    padding = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * len(model.embed)
    assert count - vectors - padding == cfg.param_count() == rcfg.param_count()


def test_full_width_sizes_past_two_to_the_31():
    """command-r-plus's tied embedding holds 256,000 x 12,288 elements, past
    2**31: counted without overflow, and the serve row's cut of 8 layers
    is 15.8 G parameters (31.5 GB in bfloat16)."""
    cfg = configs.get_config("command-r-plus-104b")
    model = Model(dataclasses.replace(cfg, num_layers=8), device="meta")
    table = model.embed["embedding"]
    assert cfg.tie_embeddings and "unembed" not in model.embed
    assert table.numel() == 256_000 * 12_288 > 2 ** 31
    total = sum(p.numel() for p in model.parameters())
    assert 31.0e9 < 2 * total < 32.0e9
    assert sum(p.numel() * p.element_size() for p in model.parameters()) == 2 * total


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen1.5-4b"])
def test_model_init_draws_what_materialize_draws(arch):
    """``Model.init`` sets each parameter as it is drawn; the bits are those
    of ``materialize`` over the whole spec tree, in the same order."""
    cfg = configs.get_config(arch, reduced=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    made = materialize(model.abstract_params(), torch.Generator().manual_seed(3), "cpu")
    named = dict(model.named_parameters())
    assert sorted(made) == sorted(named)
    for name, value in made.items():
        assert value.dtype == named[name].dtype and torch.equal(value, named[name]), name


# ---------------------------------------------------------------------------
# chip_smoke.py's slice-16 phase, rehearsed on the reduced configs
# ---------------------------------------------------------------------------


def _counters(monkeypatch):
    """The four wrappers' modules, their launch counts set to 0 for the
    length of the test (the counts are module state: left raised, they
    would reach the next test in the process)."""
    from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda

    mods = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
            "pdhg": pdhg_cuda}
    for mod in mods.values():
        monkeypatch.setattr(mod, "launches", 0)
        if hasattr(mod, "variant_launches"):
            monkeypatch.setattr(mod, "variant_launches", dict.fromkeys(mod.variant_launches, 0))
    return mods


def test_chip_smoke_lm_catalog_phase_on_reduced_configs(monkeypatch, capsys):
    """``lm_catalog_phase`` whole on the CPU at small sizes, the card's clock
    stubbed: qwen2-vl's serve row on a loaded reduced model, then each
    catalog row made by ``Model.init`` (dbrx cut to 4 layers, command-r to
    8), every line printed.  Off the card the wrappers count no launches,
    so the plain simplex is wrapped to count them as the kernel would;
    dbrx's ``lp`` row alone launches it, once a MoE layer a call."""
    from repro_torch.kernels import simplex_cuda
    from repro_torch.models.convert import load_reference_params, reference_weights

    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    _stub_the_card(monkeypatch, smoke)
    counters = _counters(monkeypatch)
    plain = simplex_cuda.simplex_plain

    def counted(*args, **kw):
        simplex_cuda.launches += 1
        simplex_cuda.variant_launches["cluster"] += 1
        return plain(*args, **kw)

    def reset():
        for mod in counters.values():
            mod.launches = 0
            for v in getattr(mod, "variant_launches", {}):
                mod.variant_launches[v] = 0

    monkeypatch.setattr(simplex_cuda, "simplex_plain", counted)
    # a warm-up prompt shorter than qwen2-vl's 8 patches, as 128 tokens are
    # shorter than its 256 on the card
    for name, value in (("LM_SERVE_BATCH", 2), ("LM_SERVE_PROMPT", 24), ("LM_CATALOG_STEPS", 4),
                        ("LM_WARM_PROMPT", 4)):
        monkeypatch.setattr(smoke, name, value)
    timed = []  # the router LP's timing needs the card: its arguments are kept instead
    monkeypatch.setattr(smoke, "lm_router_lp_case",
                        lambda serve, dev, **kw: timed.append((serve, kw)) or {"row": kw["row"]})
    cfg = configs.get_config("qwen2-vl-72b", reduced=True)
    vlm = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, 2))
    out = smoke.lm_catalog_phase(_ReducedConfigs(), torch.device("cpu"), seed=0,
                                 counters=counters, reset=reset, vlm_model=vlm)
    rows = out["rows"]
    assert sorted(rows) == sorted(["lm_vlm_serve"] + [r[0] for r in smoke.LM_CATALOG_ROWS])
    for row in ("lm_vlm_serve", "lm_qwen15_serve", "lm_internlm2_serve", "lm_command_r_serve"):
        res = rows[row]
        assert res["all_logits_finite"] and res["tokens_in_vocab"], row
        assert not any(res["port_kernel_launches"].values()), row
        assert res["prefill_bound_ms"] > 0 and res["decode_bound_ms"] > 0, row
    dbrx = rows["lm_dbrx_serve"]
    assert dbrx["topk"]["port_kernel_launches"]["simplex"] == 0
    assert dbrx["lp"]["port_kernel_launches"]["simplex"] == 4 * 4  # 4 calls x 4 MoE layers
    assert dbrx["lp"]["captured_lps"] == dbrx["lp"]["captured_bit_identical"] == 4 * 4  # all
    for router in ("topk", "lp"):
        assert dbrx[router]["all_logits_finite"] and dbrx[router]["decode_bound_ms"] > 0
        assert dbrx[router]["cache_bytes_median"] > 0 and dbrx[router]["prefill_bound_ms"] > 0
    (serve, kw), = timed
    assert serve is dbrx and kw["n_moe"] == 4 and kw["row"] == "lm_dbrx_serve_router_lp"
    assert kw["launches"] == out["launches"]["simplex"] > 0
    lines = capsys.readouterr().out
    for phase in ("lm_vlm_serve", "lm_qwen15_serve_setup", "lm_qwen15_serve",
                  "lm_internlm2_serve", "lm_dbrx_serve_setup", "lm_dbrx_serve",
                  "lm_command_r_serve_setup", "lm_command_r_serve", "slice16_lm_catalog"):
        assert f'"{phase}"' in lines, phase


def test_chip_smoke_table_rows_case_catches_a_wrong_lookup(monkeypatch, capsys):
    """``lm_table_rows_case`` (command-r's rows past element 2**31 on the
    card) on a reduced model: the rows agree, and a lookup that reads the
    neighbouring row fails the check."""
    from repro_torch.models import model as model_mod

    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    cfg = configs.get_config("command-r-plus-104b", reduced=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    res = smoke.lm_table_rows_case(model, "lm_command_r_serve")
    assert res["rows_equal"] and res["ids"] == [0, cfg.padded_vocab - 1]
    assert '"lm_command_r_serve_table"' in capsys.readouterr().out
    embed = model_mod.embed
    monkeypatch.setattr(model_mod, "embed",
                        lambda tokens, table, c: embed((tokens + 1) % table.shape[0], table, c))
    with pytest.raises(SystemExit, match="past element 2"):
        smoke.lm_table_rows_case(model, "lm_command_r_serve")


def test_moe_prefill_flops_count_gqa_attention_for_dbrx():
    """The MoE serve row's prefill FLOPs on dbrx (GQA, no latent rank):
    the attention part is the dense rows' (``lm_prefill_flops``) for the
    same layers, and each kept assignment adds one expert's 6 d f."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    cfg = dataclasses.replace(configs.get_config("dbrx-132b"), num_layers=4)
    model = Model(cfg, device="meta")
    dense = Model(dataclasses.replace(cfg, family="dense", num_experts=0, top_k=0, d_ff=0),
                  device="meta")
    b, s = 8, 4096
    attn = smoke.lm_prefill_flops(dense, b, s)["bf16"]
    base = smoke.lm_moe_prefill_flops(model, b, s, 0)
    router = 4 * b * s * 2 * cfg.d_model * cfg.num_experts
    assert base == pytest.approx(attn + router, rel=1e-12)
    more = smoke.lm_moe_prefill_flops(model, b, s, 1000)
    assert more - base == pytest.approx(1000 * 6 * cfg.d_model * cfg.d_ff, rel=1e-9)


# ---------------------------------------------------------------------------
# The committed catalog fixtures (held on the card by the ``gpu`` tier)
# ---------------------------------------------------------------------------

#: Each fixture: its file, its config, the depth it was cut to, its routers.
FIXTURES = {
    "qwen1.5-4b": ("lm_qwen15_4b_reference.npz", 2, None),
    "internlm2-20b": ("lm_internlm2_20b_reference.npz", 2, None),
    "dbrx-132b": ("lm_dbrx_132b_reference.npz", 1, ["topk", "lp"]),
    "command-r-plus-104b": ("lm_command_r_plus_104b_reference.npz", 1, None),
}


@pytest.mark.parametrize("arch", sorted(FIXTURES))
def test_committed_catalog_fixture_metadata(arch):
    """The fixture's config, depth, seed, vocabulary subset, prompts and
    weight digest's length (one entry a leaf value, 8 a leaf, counted from
    the spec tree at full width: no weight is drawn), as ``chip_smoke.py``
    names it; the file the ``gpu`` tier reads."""
    from repro_torch.models.convert import reference_specs, vocab_subset

    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    tool = _module("lm_reference_fixture", ROOT / "tools" / "lm_reference_fixture.py")
    name, layers, routers = FIXTURES[arch]
    path = ROOT / "tests" / "data" / name
    held = dict(smoke.LM_CATALOG_FIXTURES.values())
    held.update([smoke.LM_CATALOG_MOE_FIXTURE])
    assert held[arch] == path
    fx = dict(np.load(path))
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
    assert str(fx["arch"]) == arch and int(fx["layers"]) == layers and int(fx["seed"]) == tool.SEED
    assert (int(fx["prompt_len"]), int(fx["steps"])) == (tool.PROMPT_LEN, tool.STEPS)
    assert np.array_equal(fx["vocab_ids"], vocab_subset(cfg.vocab_size, tool.SUBSET, tool.SEED + 1))
    specs = reference_specs(Model(cfg, device="meta"))
    assert fx["weights_digest"].shape == (sum(min(8, int(np.prod(s.shape)))
                                              for _, s in leaves(specs)),)
    prompts = configs.make_inputs(cfg, configs.Shape("t", tool.PROMPT_LEN, tool.PROMPTS, "prefill"),
                                  tool.SEED, device="cpu")["tokens"].numpy()
    prefixes = [f"{r}__" for r in routers] if routers else [""]
    if routers:
        assert [str(r) for r in fx["routers"]] == routers
    for prefix in prefixes:
        tokens = fx[prefix + "tokens"]
        assert tokens.shape == (tool.PROMPTS, tool.PROMPT_LEN + tool.STEPS)
        assert np.array_equal(tokens[:, :tool.PROMPT_LEN], prompts)
        assert np.array_equal(tokens[:, tool.PROMPT_LEN:], fx[prefix + "argmax"][:, :-1])
        assert fx[prefix + "logits"].shape == (tool.PROMPTS, tool.STEPS + 1, tool.SUBSET)
        assert np.isfinite(fx[prefix + "logits_f64"]).all()


def test_committed_dbrx_fixture_router_lps_on_the_plain_version():
    """dbrx's fixture under ``lp``: one router LP (24 x 128) a call of its
    one MoE layer, re-solved by the port's plain simplex to the stored
    status, iterations and basis, x within 1e-5."""
    fx = dict(np.load(ROOT / "tests" / "data" / FIXTURES["dbrx-132b"][0]))
    calls = int(fx["steps"]) + 1
    assert fx["lp__router_a"].shape == (calls, DBRX_G + DBRX_E, DBRX_G * DBRX_E)
    assert fx["lp__router_call"].tolist() == list(range(calls))
    assert fx["lp__router_layer"].tolist() == [0] * calls
    a, b, c = (torch.as_tensor(fx[f"lp__router_{k}"]).float() for k in "abc")
    sol = ops.simplex_solve(a, b, c, max_iters=8 * (a.shape[1] + a.shape[2]))
    assert np.array_equal(sol.status.numpy(), fx["lp__router_status"])
    assert np.array_equal(sol.iterations.numpy(), fx["lp__router_iterations"])
    assert np.array_equal(sol.basis.numpy(), fx["lp__router_basis"])
    x = fx["lp__router_x"]
    assert float(np.abs(sol.x.numpy() - x).max()) <= 1e-5 * max(1.0, float(np.abs(x).max()))
