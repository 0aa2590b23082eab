"""Shared layers: norms, rotary embeddings, gated MLPs, embedding.

Follows ``repro/models/layers.py`` (the dense family's part of it;
``apply_mrope``, ``layernorm`` and ``sinusoidal_positions`` come with the
families that use them).  Plain functions on tensors, and the specs that
describe their parameters.  The reference's ``partition.constrain`` calls
do nothing on one device and are left out.
"""

from __future__ import annotations

import math

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
