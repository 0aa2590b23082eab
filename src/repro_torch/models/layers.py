"""Shared layers: norms, rotary embeddings, gated MLPs, embedding.

Follows ``repro/models/layers.py``.  Plain functions on tensors, and the
specs that describe their parameters.  ``layernorm`` is ported although
the reference calls it nowhere.

Under a ``DeviceMesh`` (``sharding/partition.py``) the parameters are
this rank's slices; each function gathers what is split over the data
axes (``collectives.weight``) and splits its compute over the model axis
where the weights are split there, as the reference's SPMD does:

* ``embed``: each model rank looks up the tokens of its vocabulary rows
  (zeros for the others), and a sum over the model axis completes the
  rows (a sum of one value and zeros, so exact), reduce-scattered along
  the sequence: the result is the residual stream's block of positions
  (``sharding/collectives.py``); the table's width, split over the data
  axes, is not gathered: the looked-up rows are (the same values, fewer
  bytes);
* ``unembed``: each model rank's logits of its vocabulary rows, softcap
  and pad mask applied, gathered over the model axis; where the data
  axes split the table's width, each data rank multiplies every data
  rank's rows by its columns, an all-to-all hands each rank the partial
  products of its rows, and they are summed in float32 in rank order
  (the reference's SPMD sums a contraction split this way);
* ``mlp``: the stream's block is gathered along the sequence; ``wi``'s
  columns split, so each rank's product columns are gathered into the
  whole ``[gate | up]`` pair, the gate applied, and each rank multiplies
  its block of ``wo``'s rows; the partial products are reduce-scattered
  along the sequence, each rank keeping its block of the stream.  Where
  the model axes split neither weight, it runs on the block alone.

``partition.constrain`` is called where the reference calls it (a plain
tensor is one rank's value and comes back unchanged).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding import ParamSpec, partition
from ..sharding import collectives as coll
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
    """Gated MLP: SwiGLU, or GeGLU with the tanh GELU (tensor-parallel
    under a mesh: the module's docstring)."""
    _, _, cols = coll.model_range(wi, 1)
    lo, hi, rows = coll.model_range(wo, 0)
    split = bool(cols or rows)
    if split:  # every position of the stream's block
        x = coll.seq_whole(x)
    h = x @ coll.weight(wi)
    if cols:
        h = coll.all_gather(h, cols, -1)
    g, u = h.chunk(2, dim=-1)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    h = partition.constrain(g * u, ("batch", None, "embed_tp"))
    y = h[..., lo:hi] @ coll.weight(wo)
    return coll.seq_sum(y, rows) if split else y


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
    dax = coll.data_axes(table, 1)
    ids = tokens.long()
    if dax:  # every data rank's tokens, in its columns of the table
        ids = coll.all_gather(ids.reshape(1, *ids.shape), dax, 0)
    lo, hi, axes = coll.model_range(table, 0)
    seq = ids.dim() - 1
    if axes:  # the rows summed over the model axes, left as the stream's block
        ids = ids - lo
        inside = (ids >= 0) & (ids < hi - lo)
        x = table[ids.clamp(0, hi - lo - 1)]
        x = coll.seq_sum(torch.where(inside[..., None], x, torch.zeros_like(x)), axes, seq)
    else:
        x = table[coll.seq_part(ids, seq)]
    if dax:  # each rank its own rows, every rank's columns
        x = coll.all_to_all(x, dax, 0, x.dim() - 1)[0]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return partition.constrain(x, ("batch", "seq_tp", None))


def unembed(x: torch.Tensor, table: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits: the product in the parameter dtype, then float32, the final
    softcap, and the padded rows masked to -1e30 after it."""
    lo, hi, axes = coll.model_range(table, 0)
    dax = coll.data_axes(table, 1)
    if dax:
        d0, d1 = coll.local_range(table, 1)
        rows = coll.all_gather(x.reshape(1, *x.shape), dax, 0)[..., d0:d1]
        parts = coll.all_to_all((rows @ table.t()).float(), dax, 0, 0)
        logits = parts[0]
        for part in parts[1:]:
            logits = logits + part
    else:
        logits = (x @ table.t()).float()
    logits = softcap(logits, cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        vid = torch.arange(lo, hi, device=logits.device)
        logits = torch.where(vid < cfg.vocab_size, logits, _NEG)
    if axes:
        logits = coll.all_gather(logits, axes, -1)
    return partition.constrain(logits, ("batch", None, "vocab_tp"))
