"""Model orchestration: init, forward, prefill and decode.

Follows ``repro/models/model.py`` for the dense and MoE families.
``Model`` is an ``nn.Module`` with one block a layer, over the groups of
``blocks.plan`` in order: the reference's stacked ``g0``, ``g1``, ...
leaves are unstacked (``models/convert.py`` moves weights between the
two layouts).  The reference's ``params`` argument is gone: the module
holds its parameters.  Caches are preallocated tensors a layer, written
in place by ``prefill`` and ``decode_step`` (the reference donates them
to its jitted step): k/v of shape (B, Hkv, T, hd) for GQA layers, the
MLA latents ``ckv`` (B, T, R) and rotary keys ``kpe`` (B, T, rope).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..core.lp import resolve_device
from ..sharding import ParamSpec, leaves, materialize
from . import blocks as blk
from .config import ModelConfig
from .layers import embed, embed_specs, rmsnorm, rmsnorm_spec, unembed

_GLOBAL_WINDOW = 1 << 30  # the reference's "no window" value of a global layer


class Model(nn.Module):
    """A decoder on ``device`` (the card unless the caller passes
    ``device="cpu"``).  Its parameters are uninitialised until ``init``
    or ``convert.load_reference_params`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg.validate()
        self.groups = blk.plan(cfg)
        device = resolve_device(device)
        self.embed = blk.empty_params(embed_specs(cfg), device)
        self.layers = nn.ModuleList(
            blk.make_block(kind, cfg, window=w, device=device)
            for kind, w in zip(self.kinds(), self.windows())
        )
        self.final_norm = blk.empty_param(rmsnorm_spec(cfg.d_model, cfg.dtype), device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def kinds(self) -> List[str]:
        """Each layer's block kind, the groups of ``blocks.plan`` in order."""
        return [g.kind for g in self.groups for _ in range(g.count)]

    def windows(self) -> List[Optional[int]]:
        """Each layer's sliding window: gemma2 alternates local (even layers)
        and global (odd layers, ``_GLOBAL_WINDOW``); None where there is none."""
        cfg = self.cfg
        count = cfg.num_layers
        if cfg.local_global_pattern and cfg.sliding_window:
            return [cfg.sliding_window if i % 2 == 0 else _GLOBAL_WINDOW for i in range(count)]
        if cfg.sliding_window:
            return [cfg.sliding_window] * count
        return [None] * count

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def abstract_params(self) -> Dict[str, ParamSpec]:
        """A ``ParamSpec`` for every parameter, by its ``named_parameters`` name."""
        cfg = self.cfg
        tree = {
            "embed": embed_specs(cfg),
            "layers": {str(i): blk.block_specs(kind, cfg) for i, kind in enumerate(self.kinds())},
            "final_norm": rmsnorm_spec(cfg.d_model, cfg.dtype),
        }
        return {".".join(path): spec for path, spec in leaves(tree)}

    def set_param(self, name: str, value: torch.Tensor) -> None:
        """Replace the parameter ``name`` by ``value`` (shape checked)."""
        owner, _, leaf = name.rpartition(".")
        mod = self.get_submodule(owner) if owner else self
        old = getattr(mod, leaf)
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(old.shape)}")
        setattr(mod, leaf, nn.Parameter(value, requires_grad=old.requires_grad))

    def init(self, generator: torch.Generator, dtype_override: Optional[str] = None) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device) by
        ``sharding.materialize``; ``dtype_override`` sets their dtype."""
        specs = self.abstract_params()
        made = materialize(specs, generator, self.device, dtype_override)
        for name, value in made.items():
            self.set_param(name, value)
        return self

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> List[Dict[str, torch.Tensor]]:
        """Zeroed caches for each layer, in ``cfg.dtype``: k/v of shape
        (B, Hkv, max_len, hd) for GQA layers; ``ckv`` (B, max_len, R) and
        ``kpe`` (B, max_len, rope) for MLA layers."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        caches = []
        for kind in self.kinds():
            if kind in ("mla_dense", "mla_moe"):
                caches.append({"ckv": zeros(batch, max_len, cfg.kv_lora_rank),
                               "kpe": zeros(batch, max_len, cfg.qk_rope_dim)})
            else:
                shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
                caches.append({"k": zeros(*shape), "v": zeros(*shape)})
        return caches

    # ------------------------------------------------------------------
    # Forward, prefill, decode
    # ------------------------------------------------------------------

    def _positions(self, inputs, batch: int, s: int, offset: int = 0) -> torch.Tensor:
        if "positions" in inputs:
            return inputs["positions"]
        pos = offset + torch.arange(s, device=self.device)[None, :]
        return pos.expand(batch, s)

    def _run(self, inputs, *, cache=None, cache_index=None, offset: int = 0) -> torch.Tensor:
        x = embed(inputs["tokens"], self.embed["embedding"], self.cfg)
        b, s = x.shape[0], x.shape[1]
        positions = self._positions(inputs, b, s, offset)
        for i, layer in enumerate(self.layers):
            x, _ = layer(
                x, positions=positions,
                cache=cache[i] if cache is not None else None, cache_index=cache_index,
            )
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Final hidden states (B, S, D) of the full causal forward."""
        return self._run(inputs)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden, self.embed.get("unembed", self.embed["embedding"]), self.cfg)

    @torch.inference_mode()
    def prefill(self, inputs, cache):
        """Run the prompt once and fill the cache; returns (last logits (B, 1, V), cache)."""
        hidden = self._run(inputs, cache=cache, cache_index=0)
        return self.logits(hidden[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, inputs, cache, cache_index: int):
        """One decode step: ``inputs["tokens"]`` (B, 1) -> (logits (B, 1, V), cache)."""
        hidden = self._run(
            {"tokens": inputs["tokens"]}, cache=cache, cache_index=cache_index, offset=cache_index
        )
        return self.logits(hidden), cache
