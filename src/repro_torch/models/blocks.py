"""Transformer blocks and the per-arch layer plan.

Follows ``repro/models/blocks.py`` for the dense family.  A model is a
sequence of *groups* of one layer kind; the reference scans each group
over stacked parameters, the port holds one ``nn.Module`` a layer.  This
slice runs the kind ``gqa_dense`` (attention + gated MLP); ``plan``
raises ``NotImplementedError`` for the others, naming the ``ROADMAP.md``
item (queue 1, item 6) that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..sharding import ParamSpec
from . import attention as attn
from .config import ModelConfig
from .layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec

#: Families and features still to port, and the ROADMAP item of each.
_LATER = {
    "moe": "queue 1 item 6.1 (MoE with the LP router)",
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
    if cfg.family != "dense":
        raise ValueError(cfg.family)
    if cfg.mrope_sections or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE and the {cfg.frontend} frontend are not ported yet; see "
            f"ROADMAP.md, {_LATER['encdec']}"
        )
    return [Group("gqa_dense", cfg.num_layers)]


# ---------------------------------------------------------------------------
# Parameter specs and the parameters they describe
# ---------------------------------------------------------------------------


def block_specs(kind: str, cfg: ModelConfig):
    if kind != "gqa_dense":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    s = {
        "ln_attn": rmsnorm_spec(d, cfg.dtype),
        "attn": attn.gqa_specs(cfg),
        "ln_ffn": rmsnorm_spec(d, cfg.dtype),
        "ffn": mlp_specs(d, cfg.d_ff, cfg.dtype),
    }
    if cfg.post_norms:
        s["ln_attn_post"] = rmsnorm_spec(d, cfg.dtype)
        s["ln_ffn_post"] = rmsnorm_spec(d, cfg.dtype)
    return s


def empty_param(spec: ParamSpec, device) -> nn.Parameter:
    """An uninitialised parameter of the spec's shape and dtype on ``device``."""
    return nn.Parameter(torch.empty(spec.shape, dtype=getattr(torch, spec.dtype), device=device))


def empty_params(specs, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: empty_param(s, device) for k, s in sorted(specs.items())})


# ---------------------------------------------------------------------------
# The dense block
# ---------------------------------------------------------------------------


class GQABlock(nn.Module):
    """Pre-norm attention + gated MLP, with gemma2's post-norms when
    ``cfg.post_norms``; ``window`` is this layer's sliding window (None
    for none)."""

    def __init__(self, cfg: ModelConfig, *, window: Optional[int], device):
        super().__init__()
        self.cfg = cfg
        self.window = window
        specs = block_specs("gqa_dense", cfg)
        for name, spec in specs.items():
            if isinstance(spec, ParamSpec):
                self.register_parameter(name, empty_param(spec, device))
            else:
                self.add_module(name, empty_params(spec, device))

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
        f = mlp(h, self.ffn["wi"], self.ffn["wo"], cfg.act)
        if cfg.post_norms:
            f = rmsnorm(f, self.ln_ffn_post, cfg.norm_eps)
        return x + f, cache
