"""Transformer, SSM and hybrid blocks and the per-arch layer plan.

Follows ``repro/models/blocks.py``.  A model is a sequence of *groups* of
one layer kind; the reference scans each group over stacked parameters,
the port holds one ``nn.Module`` a layer.  Layer kinds:

    gqa_dense   attention + gated MLP                (dense archs)
    gqa_moe     attention + MoE FFN                  (dbrx)
    mla_dense   MLA attention + gated MLP            (deepseek layer 0)
    mla_moe     MLA attention + MoE FFN              (deepseek 1..L)
    mamba       Mamba2 mixer only                    (mamba2, zamba2 core)
    enc         bidirectional attention + MLP        (seamless encoder)
    dec_cross   causal self + cross attention + MLP  (seamless decoder)

The zamba2 hybrid also owns ONE shared attention block (attention + MLP,
``shared_attn_specs``) applied before every ``shared_attn_every``-th
mamba layer; its parameters are shared across the sites, and each site
has its own KV cache (``models/model.py``).

Under a mesh the residual stream is sequence-parallel, the reference's
``("batch", "seq_tp", None)`` (its Megatron-SP pattern): between
sublayers a rank holds its batch rows and its block of the positions
``partition.global_seq`` names (``collectives.stream_range``; every
position where the model axes do not divide them, as in every decode
step).  Norms and residual adds run on the block; each sublayer gathers
its normalised input along the sequence where it needs every position
and reduce-scatters its row-parallel sums back into the block
(``sharding/collectives.py``).  ``_res`` marks the stream at the
reference's call sites of ``partition.constrain``: both operands of
every ``x + sublayer(...)`` are in that layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..sharding import ParamSpec, partition
from ..sharding import collectives as coll
from . import attention as attn
from . import mamba2 as mb
from . import moe as moe_mod
from .config import ModelConfig
from .layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec


@dataclasses.dataclass(frozen=True)
class Group:
    kind: str
    count: int


def plan(cfg: ModelConfig) -> List[Group]:
    if cfg.family == "dense":
        return [Group("gqa_dense", cfg.num_layers)]
    if cfg.family == "moe":
        if cfg.use_mla:
            groups = []
            if cfg.first_dense_layers:
                groups.append(Group("mla_dense", cfg.first_dense_layers))
            groups.append(Group("mla_moe", cfg.num_layers - cfg.first_dense_layers))
            return groups
        return [Group("gqa_moe", cfg.num_layers)]
    if cfg.family in ("ssm", "hybrid"):  # the hybrid's shared block is the model's
        return [Group("mamba", cfg.num_layers)]
    if cfg.family == "encdec":
        return [Group("enc", cfg.enc_layers), Group("dec_cross", cfg.num_layers)]
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Parameter specs and the parameters they describe
# ---------------------------------------------------------------------------


def block_specs(kind: str, cfg: ModelConfig):
    d = cfg.d_model
    if kind in ("gqa_dense", "gqa_moe"):
        s = {
            "ln_attn": rmsnorm_spec(d, cfg.dtype),
            "attn": attn.gqa_specs(cfg),
            "ln_ffn": rmsnorm_spec(d, cfg.dtype),
        }
        if cfg.post_norms:
            s["ln_attn_post"] = rmsnorm_spec(d, cfg.dtype)
            s["ln_ffn_post"] = rmsnorm_spec(d, cfg.dtype)
        s["ffn"] = moe_mod.moe_specs(cfg) if kind == "gqa_moe" else mlp_specs(d, cfg.d_ff, cfg.dtype)
        return s
    if kind in ("mla_dense", "mla_moe"):
        f = cfg.d_ff_dense if kind == "mla_dense" and cfg.d_ff_dense else cfg.d_ff
        return {
            "ln_attn": rmsnorm_spec(d, cfg.dtype),
            "attn": attn.mla_specs(cfg),
            "ln_ffn": rmsnorm_spec(d, cfg.dtype),
            "ffn": moe_mod.moe_specs(cfg) if kind == "mla_moe" else mlp_specs(d, f, cfg.dtype),
        }
    if kind == "mamba":
        return {"ln": rmsnorm_spec(d, cfg.dtype), "mixer": mb.mamba_specs(cfg)}
    if kind == "enc":
        return {
            "ln_attn": rmsnorm_spec(d, cfg.dtype),
            "attn": attn.gqa_specs(cfg),
            "ln_ffn": rmsnorm_spec(d, cfg.dtype),
            "ffn": mlp_specs(d, cfg.d_ff, cfg.dtype),
        }
    if kind == "dec_cross":
        return {
            "ln_attn": rmsnorm_spec(d, cfg.dtype),
            "attn": attn.gqa_specs(cfg),
            "ln_cross": rmsnorm_spec(d, cfg.dtype),
            "cross": attn.gqa_specs(cfg),
            "ln_ffn": rmsnorm_spec(d, cfg.dtype),
            "ffn": mlp_specs(d, cfg.d_ff, cfg.dtype),
        }
    raise ValueError(kind)


def shared_attn_specs(cfg: ModelConfig):
    """zamba2: the one shared (attention + MLP) block."""
    return {
        "ln_attn": rmsnorm_spec(cfg.d_model, cfg.dtype),
        "attn": attn.gqa_specs(cfg),
        "ln_ffn": rmsnorm_spec(cfg.d_model, cfg.dtype),
        "ffn": mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def empty_param(spec: ParamSpec, device) -> nn.Parameter:
    """An uninitialised parameter of the spec's dtype on ``device``: the
    spec's shape, or under a ``DeviceMesh`` this rank's slice of it
    (``partition.local_shape``).  It keeps its spec as ``.spec``, which
    ``sharding/collectives.py`` reads to gather it at use."""
    shape = partition.local_shape(spec.shape, spec.axes)
    p = nn.Parameter(torch.empty(shape, dtype=getattr(torch, spec.dtype), device=device))
    p.spec = spec
    return p


def empty_params(specs, device) -> nn.Module:
    """Uninitialised parameters for a tree of specs: a ``ParameterDict``
    where every leaf is a spec, else a :class:`ParamTree`."""
    if all(isinstance(s, ParamSpec) for s in specs.values()):
        return nn.ParameterDict({k: empty_param(s, device) for k, s in sorted(specs.items())})
    return ParamTree(specs, device)


class ParamTree(nn.Module):
    """Parameters and nested trees of them under their spec names (an MoE
    FFN's ``router``/``wi``/``wo`` beside its ``shared`` MLP); indexed
    like a dict, as the reference's parameter trees are."""

    def __init__(self, specs, device):
        super().__init__()
        _register(self, dict(sorted(specs.items())), device)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _register(module: nn.Module, specs, device) -> None:
    """Register ``specs``' leaves on ``module`` as parameters and its
    subtrees as child modules, in the tree's order."""
    for name, spec in specs.items():
        if isinstance(spec, ParamSpec):
            module.register_parameter(name, empty_param(spec, device))
        else:
            module.add_module(name, empty_params(spec, device))


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------


def _res(x: torch.Tensor) -> torch.Tensor:
    """The residual stream at a block boundary: this rank's rows and its
    block of the positions (``collectives.stream_range``), which is the
    reference's constraint of it (a plain tensor is one rank's value)."""
    return partition.constrain(x, ("batch", "seq_tp", None))


class GQABlock(nn.Module):
    """Pre-norm attention + gated MLP (``gqa_dense``) or MoE FFN
    (``gqa_moe``), with gemma2's post-norms when ``cfg.post_norms``;
    ``window`` is this layer's sliding window (None for none)."""

    def __init__(self, cfg: ModelConfig, *, window: Optional[int], device, kind: str = "gqa_dense",
                 specs=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.window = window
        _register(self, specs or block_specs(kind, cfg), device)

    def forward(self, x, *, positions, cache=None, cache_index=None):
        cfg = self.cfg
        h = rmsnorm(x, self.ln_attn, cfg.norm_eps)
        a, cache = attn.gqa_attention(
            h, self.attn, cfg, positions=positions, window=self.window,
            cache=cache, cache_index=cache_index,
        )
        if cfg.post_norms:
            a = rmsnorm(a, self.ln_attn_post, cfg.norm_eps)
        x = _res(x + _res(a))
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        if self.kind == "gqa_moe":
            f = moe_mod.moe_ffn(h, self.ffn, cfg)
        else:
            f = mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)
        if cfg.post_norms:
            f = rmsnorm(f, self.ln_ffn_post, cfg.norm_eps)
        return _res(x + _res(f)), cache


class MLABlock(nn.Module):
    """Pre-norm MLA attention + gated MLP (``mla_dense``, of width
    ``d_ff_dense``) or MoE FFN (``mla_moe``)."""

    window = None

    def __init__(self, cfg: ModelConfig, *, device, kind: str):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        _register(self, block_specs(kind, cfg), device)

    def forward(self, x, *, positions, cache=None, cache_index=None):
        cfg = self.cfg
        h = rmsnorm(x, self.ln_attn, cfg.norm_eps)
        a, cache = attn.mla_attention(
            h, self.attn, cfg, positions=positions, cache=cache, cache_index=cache_index,
        )
        x = _res(x + _res(a))
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        if self.kind == "mla_moe":
            f = moe_mod.moe_ffn(h, self.ffn, cfg)
        else:
            f = mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)
        return _res(x + _res(f)), cache


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 mixer (``mamba``); no attention, so no positions."""

    window = None

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        _register(self, block_specs("mamba", cfg), device)

    def forward(self, x, *, positions=None, cache=None, cache_index=None):
        h = rmsnorm(x, self.ln, self.cfg.norm_eps)
        m, cache = mb.mamba_mixer(h, self.mixer, self.cfg, cache=cache, cache_index=cache_index)
        return _res(x + _res(m)), cache


class EncBlock(nn.Module):
    """Pre-norm bidirectional attention + gated MLP (``enc``); no cache."""

    window = None

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        _register(self, block_specs("enc", cfg), device)

    def forward(self, x, *, positions, cache=None, cache_index=None):
        cfg = self.cfg
        h = rmsnorm(x, self.ln_attn, cfg.norm_eps)
        x = _res(x + attn.encoder_attention(h, self.attn, cfg, positions))
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        return _res(x + mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)), None


class DecCrossBlock(nn.Module):
    """Decoder block (``dec_cross``): causal self-attention (cached), cross
    attention over the encoder's output, gated MLP.

    The cache holds the self-attention's ``k``/``v`` and the cross
    attention's ``ck``/``cv`` (B, H, Senc, hd): a call given ``enc_out``
    (the forward, the prefill) projects the encoder's k and v and, with a
    cache, writes them in (in place when the cache was sized for this
    encoder length, else by replacing the two entries, as the reference
    returns them whatever ``init_cache``'s ``enc_len``); a call without
    it (a decode step) attends the cached ones."""

    window = None

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        _register(self, block_specs("dec_cross", cfg), device)

    def forward(self, x, *, positions, enc_out=None, cache=None, cache_index=None):
        cfg = self.cfg
        h = rmsnorm(x, self.ln_attn, cfg.norm_eps)
        self_cache = {"k": cache["k"], "v": cache["v"]} if cache is not None else None
        a, _ = attn.gqa_attention(h, self.attn, cfg, positions=positions, cache=self_cache,
                                  cache_index=cache_index)
        x = _res(x + a)
        h = rmsnorm(x, self.ln_cross, cfg.norm_eps)
        if cache is not None and enc_out is None:
            c, _ = attn.cross_attention(h, self.cross, cfg, kv=(cache["ck"], cache["cv"]))
        else:
            c, kv = attn.cross_attention(h, self.cross, cfg, enc_out=enc_out)
            if cache is not None:
                for key, t in zip(("ck", "cv"), kv):
                    _store_cross(cache, key, t)
        x = _res(x + c)
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        return _res(x + mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)), cache


def _store_cross(cache, key: str, t: torch.Tensor) -> None:
    """Write the encoder's k or v ``t`` (every head and position of this
    rank's rows) into ``cache[key]``: this rank's block of positions
    (all of them without a mesh), in place when the cache was sized for
    this encoder length, else by replacing the entry."""
    old = cache[key]
    lo, hi, _ = coll.dim_range(t.shape[2], "kv_seq_tp")
    part = t[:, :, lo:hi]
    if old.shape == part.shape:
        old.copy_(part)
        return
    new = part.to(old.dtype)
    spec = getattr(old, "spec", None)
    if spec is not None:
        new.spec = ParamSpec((spec.shape[0], *t.shape[1:]), spec.axes, spec.dtype, "zeros")
    cache[key] = new


def make_block(kind: str, cfg: ModelConfig, *, window: Optional[int], device) -> nn.Module:
    """The layer module of ``kind``."""
    if kind in ("gqa_dense", "gqa_moe"):
        return GQABlock(cfg, window=window, device=device, kind=kind)
    if kind in ("mla_dense", "mla_moe"):
        return MLABlock(cfg, device=device, kind=kind)
    if kind == "mamba":
        return MambaBlock(cfg, device=device)
    if kind == "enc":
        return EncBlock(cfg, device=device)
    if kind == "dec_cross":
        return DecCrossBlock(cfg, device=device)
    raise ValueError(kind)


def make_shared_block(cfg: ModelConfig, *, device) -> GQABlock:
    """zamba2's shared attention block: a ``gqa_dense`` block of
    ``shared_attn_specs``, with no window."""
    return GQABlock(cfg, window=None, device=device, specs=shared_attn_specs(cfg))
