"""Transformer blocks and the per-arch layer plan.

Follows ``repro/models/blocks.py`` for the dense and MoE families.  A
model is a sequence of *groups* of one layer kind; the reference scans
each group over stacked parameters, the port holds one ``nn.Module`` a
layer.  Layer kinds:

    gqa_dense   attention + gated MLP                (dense archs)
    gqa_moe     attention + MoE FFN                  (dbrx)
    mla_dense   MLA attention + gated MLP            (deepseek layer 0)
    mla_moe     MLA attention + MoE FFN              (deepseek 1..L)

``plan`` raises ``NotImplementedError`` for the families still to port,
naming the ``ROADMAP.md`` item (queue 1, item 6) that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..sharding import ParamSpec
from . import attention as attn
from . import moe as moe_mod
from .config import ModelConfig
from .layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec

#: Families and features still to port, and the ROADMAP item of each.
_LATER = {
    "ssm": "queue 1 item 6.2 (Mamba2/zamba2)",
    "hybrid": "queue 1 item 6.2 (Mamba2/zamba2)",
    "encdec": "queue 1 item 6.3 (encoder-decoder and M-RoPE)",
}


@dataclasses.dataclass(frozen=True)
class Group:
    kind: str
    count: int


def plan(cfg: ModelConfig) -> List[Group]:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; see ROADMAP.md, "
            f"{_LATER[cfg.family]}"
        )
    if cfg.mrope_sections or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE and the {cfg.frontend} frontend are not ported yet; see "
            f"ROADMAP.md, {_LATER['encdec']}"
        )
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
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def empty_param(spec: ParamSpec, device) -> nn.Parameter:
    """An uninitialised parameter of the spec's shape and dtype on ``device``."""
    return nn.Parameter(torch.empty(spec.shape, dtype=getattr(torch, spec.dtype), device=device))


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


class GQABlock(nn.Module):
    """Pre-norm attention + gated MLP (``gqa_dense``) or MoE FFN
    (``gqa_moe``), with gemma2's post-norms when ``cfg.post_norms``;
    ``window`` is this layer's sliding window (None for none)."""

    def __init__(self, cfg: ModelConfig, *, window: Optional[int], device, kind: str = "gqa_dense"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.window = window
        _register(self, block_specs(kind, cfg), device)

    def forward(self, x, *, positions, cache=None, cache_index=None):
        cfg = self.cfg
        h = rmsnorm(x, self.ln_attn, cfg.norm_eps)
        a, cache = attn.gqa_attention(
            h, self.attn, cfg, positions=positions, window=self.window,
            cache=cache, cache_index=cache_index,
        )
        if cfg.post_norms:
            a = rmsnorm(a, self.ln_attn_post, cfg.norm_eps)
        x = x + a
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        if self.kind == "gqa_moe":
            f = moe_mod.moe_ffn(h, self.ffn, cfg)
        else:
            f = mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)
        if cfg.post_norms:
            f = rmsnorm(f, self.ln_ffn_post, cfg.norm_eps)
        return x + f, cache


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
        x = x + a
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        if self.kind == "mla_moe":
            f = moe_mod.moe_ffn(h, self.ffn, cfg)
        else:
            f = mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)
        return x + f, cache


def make_block(kind: str, cfg: ModelConfig, *, window: Optional[int], device) -> nn.Module:
    """The layer module of ``kind``."""
    if kind in ("gqa_dense", "gqa_moe"):
        return GQABlock(cfg, window=window, device=device, kind=kind)
    if kind in ("mla_dense", "mla_moe"):
        return MLABlock(cfg, device=device, kind=kind)
    raise NotImplementedError(f"block kind {kind!r} is not ported yet")
