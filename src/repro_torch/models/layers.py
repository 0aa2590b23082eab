"""Shared layers: norms, rotary embeddings, gated MLPs, embedding.

Follows ``repro/models/layers.py``.  Plain functions on tensors, and the
specs that describe their parameters.  The reference's
``partition.constrain`` calls do nothing on one device and are left out.
``layernorm`` is ported although the reference calls it nowhere.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding import ParamSpec
from .config import ModelConfig

_NEG = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int, dtype: str) -> ParamSpec:
    return ParamSpec((d,), (None,), dtype=dtype, init="zeros")  # (1 + w) convention


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with the ``(1 + w)`` scale, cast back to ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layernorm_specs(d: int, dtype: str):
    return {
        "scale": ParamSpec((d,), (None,), dtype=dtype, init="ones"),
        "bias": ParamSpec((d,), (None,), dtype=dtype, init="zeros"),
    }


def layernorm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32 (``p["scale"]``, ``p["bias"]``), cast back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, hd), positions: (B, S) int.  Half-split convention."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[:, None, :, None].float() * freqs  # (B, 1, S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: Tuple[int, ...],
                theta: float) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): x (B, H, S, hd), positions (B, S, 3) for
    (t, h, w).  The hd/2 frequency slots are split into ``sections`` (summing
    to hd/2), and each section rotates by its own coordinate."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    sec_ids = np.concatenate([np.full(n, i) for i, n in enumerate(sections)])
    sec_ids = torch.as_tensor(sec_ids, dtype=torch.long, device=x.device)
    pos = positions.float()[..., sec_ids]  # (B, S, half): slot i's coordinate
    ang = pos[:, None, :, :] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(s: int, d: int, device=None) -> torch.Tensor:
    """(s, d) float32: sines then cosines of ``pos / 10000^(2i/d)``, made in
    float64 by NumPy as the reference makes them."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def mlp_specs(d: int, f: int, dtype: str):
    return {
        "wi": ParamSpec((d, 2 * f), ("fsdp", "embed_tp"), dtype=dtype),
        "wo": ParamSpec((f, d), ("embed_tp", "fsdp"), dtype=dtype),
    }


def mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: SwiGLU, or GeGLU with the tanh GELU."""
    h = x @ wi
    g, u = h.chunk(2, dim=-1)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ wo


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig):
    v = cfg.padded_vocab
    s = {"embedding": ParamSpec((v, cfg.d_model), ("vocab_tp", "fsdp"), dtype=cfg.dtype, scale=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((v, cfg.d_model), ("vocab_tp", "fsdp"), dtype=cfg.dtype)
    return s


def embed(tokens: torch.Tensor, table: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of ``table``; gemma2's ``sqrt(d)`` scale is applied in the table's dtype."""
    x = table[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits: the product in the parameter dtype, then float32, the final
    softcap, and the padded rows masked to -1e30 after it."""
    logits = softcap((x @ table.t()).float(), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        vid = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vid < cfg.vocab_size, logits, _NEG)
    return logits
