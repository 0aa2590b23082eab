"""Attention: chunked flash GQA with local/global windows and softcap.

Follows ``repro/models/attention.py`` for the dense family:
``flash_attention`` (prefill and training), ``decode_attention`` (one
decode step over the cache), ``gqa_specs``, ``_project_qkv`` and
``gqa_attention``.  MLA, cross and encoder attention come with the
families that use them; the reference's head-TP and sequence-sharding
helpers have no meaning on one device.

* Scores are float32 whatever the activation dtype, as the reference's
  ``preferred_element_type=float32`` makes them: q and k are upcast
  before the product (a product of bfloat16 values is exact in float32).
* GQA never repeats KV heads: q is viewed as (B, Hkv, G*Sq, hd) and
  contracted against the raw KV.
* ``flash_attention`` carries the running maximum from chunk to chunk.
  The reference's scan carries the old maximum instead, so with more
  than one KV chunk it keeps only the last chunk that holds a valid key
  (``ROADMAP.md``, kept divergences); with one chunk, as in every reduced config,
  the two agree.
* Not ``F.scaled_dot_product_attention``: it has no softcap and does not
  follow the float32 score path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..sharding import ParamSpec
from .config import ModelConfig
from .layers import _NEG, apply_rope, softcap


# ---------------------------------------------------------------------------
# Flash attention (chunked online softmax)
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, dk)
    k: torch.Tensor,  # (B, Hkv, Skv, dk)
    v: torch.Tensor,  # (B, Hkv, Skv, dv)
    *,
    window: Optional[int] = None,  # None = full; int = sliding window
    chunk: int = 512,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Causal attention over KV chunks of ``chunk`` keys with an online
    softmax in float32; nothing of shape (Sq, Skv) is materialized."""
    b, hq, sq, dk = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dk)
    chunk = min(chunk, skv)
    dev = q.device

    qg = q.float().reshape(b, hkv, g * sq, dk)
    q_pos = torch.arange(sq, device=dev)
    o = torch.zeros((b, hkv, g * sq, dv), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g * sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g * sq), dtype=torch.float32, device=dev)
    for start in range(0, skv, chunk):
        kj = k[:, :, start:start + chunk].float()
        vj = v[:, :, start:start + chunk].float()
        c = kj.shape[2]
        s = (qg @ kj.transpose(-1, -2)) * scale  # (B, Hkv, G*Sq, C)
        s = softcap(s, attn_softcap)
        k_pos = start + torch.arange(c, device=dev)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = s.view(b, hkv, g, sq, c).masked_fill(~mask, _NEG).view(b, hkv, g * sq, c)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p @ vj
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, 1, dk)
    k: torch.Tensor,  # (B, Hkv, T, dk)  the cache
    v: torch.Tensor,  # (B, Hkv, T, dv)
    cache_index: int,
    *,
    window: Optional[int] = None,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """One pass over the cache for a single new token.

    The reference scores all T slots and masks those outside
    ``cache_index - window < pos <= cache_index``; the port reads just
    those slots, which gives the same softmax (a masked slot's weight is
    exactly 0).  Softmax in float32; the weights are cast to the cache
    dtype before the PV product, as the reference casts them.
    """
    b, hq, sq, dk = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    lo = 0 if window is None else max(0, cache_index - window + 1)
    kk = k[:, :, lo:cache_index + 1]
    vv = v[:, :, lo:cache_index + 1]
    qg = q.float().reshape(b, hkv, g * sq, dk)
    s = (qg @ kk.float().transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    s = softcap(s, attn_softcap)
    p = torch.softmax(s, dim=-1)
    o = p.to(vv.dtype) @ vv
    return o.reshape(b, hq, sq, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def gqa_specs(cfg: ModelConfig, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    s = {
        "wq": ParamSpec((d, cfg.num_heads, cfg.head_dim), ("fsdp", "heads_tp", None), dtype=cfg.dtype),
        "wk": ParamSpec((d, cfg.num_kv_heads, cfg.head_dim), ("fsdp", "heads_tp", None), dtype=cfg.dtype),
        "wv": ParamSpec((d, cfg.num_kv_heads, cfg.head_dim), ("fsdp", "heads_tp", None), dtype=cfg.dtype),
        "wo": ParamSpec((cfg.num_heads, cfg.head_dim, d), ("heads_tp", None, "fsdp"), dtype=cfg.dtype),
    }
    if cfg.attn_bias:
        s["bq"] = ParamSpec((cfg.num_heads, cfg.head_dim), (None, None), dtype=cfg.dtype, init="zeros")
        s["bk"] = ParamSpec((cfg.num_kv_heads, cfg.head_dim), (None, None), dtype=cfg.dtype, init="zeros")
        s["bv"] = ParamSpec((cfg.num_kv_heads, cfg.head_dim), (None, None), dtype=cfg.dtype, init="zeros")
    return s


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bhsk", x, w)`` as one matrix product."""
    b, s, d = x.shape
    h, hd = w.shape[1], w.shape[2]
    return (x @ w.reshape(d, h * hd)).view(b, s, h, hd).transpose(1, 2)


def _project_qkv(x, p, cfg: ModelConfig, positions):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(
    x: torch.Tensor,  # (B, S, D)
    p,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S)
    window: Optional[int] = None,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,  # tokens already in the cache
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention.

    * no cache: full causal flash (forward).
    * cache and S > 1: prefill: attend over the fresh k/v only, then write
      them into the cache at ``cache_index``.
    * cache and S == 1: decode: write k/v at ``cache_index`` in place and
      attend over the cache.

    The cache's tensors are updated in place (where the reference's jit
    donates them) and returned.
    """
    s = x.shape[1]
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cache is not None:
        cache["k"][:, :, cache_index:cache_index + s] = k
        cache["v"][:, :, cache_index:cache_index + s] = v
    if cache is not None and s == 1:
        out = decode_attention(
            q, cache["k"], cache["v"], cache_index,
            window=window, attn_softcap=cfg.attn_softcap,
        )
    else:
        out = flash_attention(
            q, k, v, window=window,
            chunk=cfg.attn_chunk, attn_softcap=cfg.attn_softcap,
        )
    b, h, _, hd = out.shape
    wo = p["wo"]
    y = out.transpose(1, 2).reshape(b, s, h * hd) @ wo.reshape(h * hd, wo.shape[-1])
    return y, cache
