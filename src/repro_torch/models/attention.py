"""Attention: chunked flash GQA with local/global windows and softcap.

Follows ``repro/models/attention.py`` for the dense and MoE families:
``flash_attention`` (prefill and training), ``decode_attention`` (one
decode step over the cache), ``gqa_specs``, ``_project_qkv`` (RoPE, or
qwen2-vl's M-RoPE), ``gqa_attention``, the encoder-decoder's
``cross_attention`` and ``encoder_attention``, and DeepSeek-V2's MLA
(``mla_specs``, ``_mla_latents``, ``_mla_q``, ``mla_attention``).  The
reference's head-TP and sequence-sharding helpers have no meaning on one
device.

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
from .layers import _NEG, apply_mrope, apply_rope, rmsnorm, rmsnorm_spec, softcap


# ---------------------------------------------------------------------------
# Flash attention (chunked online softmax)
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, dk)
    k: torch.Tensor,  # (B, Hkv, Skv, dk)
    v: torch.Tensor,  # (B, Hkv, Skv, dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # None = full; int = sliding window
    chunk: int = 512,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Attention over KV chunks of ``chunk`` keys with an online softmax in
    float32 (causal unless ``causal=False``, as the encoder and the cross
    attention run it); nothing of shape (Sq, Skv) is materialized."""
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
        mask = torch.ones((sq, c), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        if causal or window is not None:
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
    """q, k, v (B, H, S, hd) with biases if any; M-RoPE on q and k when the
    config has sections (positions (B, S, 3)), else RoPE on the first
    coordinate of 3-D positions, or on 2-D positions as they are."""
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        pos2d = positions if positions.ndim == 2 else positions[..., 0]
        q = apply_rope(q, pos2d, cfg.rope_theta)
        k = apply_rope(k, pos2d, cfg.rope_theta)
    return q, k, v


def gqa_attention(
    x: torch.Tensor,  # (B, S, D)
    p,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S), or (B, S, 3) for M-RoPE
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
    return _out_proj(out, p["wo"]), cache


def cross_attention(
    x: torch.Tensor,  # (B, S, D)
    p,
    cfg: ModelConfig,
    *,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # the cached encoder k, v
    enc_out: Optional[torch.Tensor] = None,  # (B, Senc, D), to project
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Encoder-decoder cross attention: no rope, not causal, no biases.
    Returns the output and the encoder's (k, v), each (B, H, Senc, hd)."""
    q = _heads(x, p["wq"])
    if kv is None:
        kv = (_heads(enc_out, p["wk"]), _heads(enc_out, p["wv"]))
    k, v = kv
    out = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return _out_proj(out, p["wo"]), kv


def encoder_attention(x, p, cfg: ModelConfig, positions):
    """Bidirectional self-attention of the encoder (rope on q and k)."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return _out_proj(out, p["wo"])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bhsv,hvd->bsd", out, wo)`` as one matrix product."""
    b, h, s, v = out.shape
    return out.transpose(1, 2).reshape(b, s, h * v) @ wo.reshape(h * v, wo.shape[-1])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2) attention
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig):
    d = cfg.d_model
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": ParamSpec((d, cfg.num_heads, qk), ("fsdp", "heads_tp", None), dtype=cfg.dtype),
        "w_dkv": ParamSpec((d, cfg.kv_lora_rank + cfg.qk_rope_dim), ("fsdp", None), dtype=cfg.dtype),
        "kv_norm": rmsnorm_spec(cfg.kv_lora_rank, cfg.dtype),
        "w_uk": ParamSpec((cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_dim), (None, "heads_tp", None), dtype=cfg.dtype),
        "w_uv": ParamSpec((cfg.kv_lora_rank, cfg.num_heads, cfg.v_head_dim), (None, "heads_tp", None), dtype=cfg.dtype),
        "wo": ParamSpec((cfg.num_heads, cfg.v_head_dim, d), ("heads_tp", None, "fsdp"), dtype=cfg.dtype),
    }


def _mla_latents(x, p, cfg: ModelConfig, positions):
    """The compressed latent ``c_kv`` (B, S, R), normed, and the shared
    rotary key ``k_pe`` (B, S, rope): what the MLA cache stores."""
    full = x @ p["w_dkv"]
    c_kv, k_pe = full.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, None], positions, cfg.rope_theta)[:, 0]
    return c_kv, k_pe


def _mla_q(x, p, cfg: ModelConfig, positions):
    q = _heads(x, p["wq"])  # (B, H, S, nope + rope)
    q_nope, q_pe = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def mla_attention(
    x: torch.Tensor,  # (B, S, D)
    p,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S)
    cache: Optional[dict] = None,  # {"ckv": (B, T, R), "kpe": (B, T, rope)}
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Multi-head latent attention.

    * cache and S == 1: the absorbed decode.  The new latents are written
      into the cache at ``cache_index`` in place; ``w_uk`` is folded into
      q, the scores against the cached latents and rotary keys are
      float32, the probabilities are cast to the cache dtype before the
      latent product (as the reference casts them), and ``w_uv`` is
      applied after it.  Only the slots up to ``cache_index`` are read,
      which gives the reference's masked softmax.
    * otherwise (forward, prefill): the latents are expanded to per-head
      keys and values and go through ``flash_attention`` (causal); with a
      cache, the latents are also written at ``cache_index``.
    """
    b, s, _ = x.shape
    q_nope, q_pe = _mla_q(x, p, cfg, positions)
    c_kv, k_pe = _mla_latents(x, p, cfg, positions)
    if cache is not None:
        cache["ckv"][:, cache_index:cache_index + s] = c_kv
        cache["kpe"][:, cache_index:cache_index + s] = k_pe

    if cache is not None and s == 1:
        # The heads ride in the rows of each product (q is (B, H, .) with one
        # position), so no product broadcasts the cache over the heads.
        h = cfg.num_heads
        ckv = cache["ckv"][:, :cache_index + 1]  # (B, T, R)
        kpe = cache["kpe"][:, :cache_index + 1]  # (B, T, rope)
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, :, 0], p["w_uk"])  # (B, H, R)
        s_lat = torch.bmm(q_lat.float(), ckv.float().transpose(1, 2))  # (B, H, T)
        s_pe = torch.bmm(q_pe[:, :, 0].float(), kpe.float().transpose(1, 2))
        scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        attn = torch.softmax((s_lat + s_pe) * scale, dim=-1)
        ctx_lat = torch.bmm(attn.to(ckv.dtype), ckv)  # (B, H, R)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat, p["w_uv"])  # (B, H, v)
        return _out_proj(out.view(b, h, 1, -1), p["wo"]), cache

    k_nope = _heads(c_kv, p["w_uk"])  # (B, H, S, nope)
    v = _heads(c_kv, p["w_uv"])  # (B, H, S, v)
    k = torch.cat([k_nope, k_pe[:, None].expand(b, cfg.num_heads, s, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = flash_attention(q, k, v, chunk=cfg.attn_chunk)
    return _out_proj(out, p["wo"]), cache
