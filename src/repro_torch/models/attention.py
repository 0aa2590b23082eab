"""Attention: chunked flash GQA with local/global windows and softcap.

Follows ``repro/models/attention.py`` for the dense and MoE families:
``flash_attention`` (prefill and training), ``decode_attention`` (one
decode step over the cache), ``gqa_specs``, ``_project_qkv`` (here
``_proj``: RoPE, or qwen2-vl's M-RoPE), ``gqa_attention``, the
encoder-decoder's ``cross_attention`` and ``encoder_attention``, and
DeepSeek-V2's MLA (``mla_specs``, ``_mla_latents``, ``_mla_q``,
``mla_attention``).

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

Each function is written for a ``DeviceMesh`` (the reference's
``_head_tp`` / ``_shard_heads_or_seq``, ``attention.py:145-170``).
Without one, or where an axis holds one rank, every range below is
whole and every collective returns its input, so the same body runs the
meshless function.  Inside a model the input ``x`` is this rank's block
of the residual stream's positions (``partition.global_seq``; every
position where the model axes do not divide them, as in every decode
step), and the output is returned in that layout
(``sharding/collectives.py``); a function called alone takes and
returns every position:

* **Heads split over the model axis** where the heads count divides
  (the weights ``wq``/``wo`` are then stored split by heads): ``x`` is
  gathered along the sequence, each rank projects and attends its heads
  over every position, over the KV heads they read (its own KV heads
  when ``wk`` is split too, else those of its q heads, as the
  reference's ``_expand_kv``), and the output projections' partial
  products are reduce-scattered along the sequence (the Megatron-SP
  pattern the reference's constraint asks of XLA).
* **Otherwise the sequence** (the reference's ``seq_tp``): each model
  rank attends its block of query positions (causal offset
  ``q_offset``), which is its block of the stream, against K and V from
  the gathered input; the output is already that block.
* **Caches** are split over positions (``kv_seq_tp``) and batch rows.  A
  prefill writes each rank's block of positions (cut over the cache's
  length, from the gathered k and v); a decode step writes the new token
  on the rank that owns its slot.  Decode attends the whole heads on
  each rank's block of positions, and the softmax is combined across
  the model axis exactly as the reference's one softmax: the maximum
  over all positions, the sum of the exponentials, then the
  probabilities (cast to the cache's dtype) times each block's values,
  summed.  With the positions whole, the rank attends its heads alone.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..sharding import ParamSpec, partition
from ..sharding import collectives as coll
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
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention over KV chunks of ``chunk`` keys with an online softmax in
    float32 (causal unless ``causal=False``, as the encoder and the cross
    attention run it); nothing of shape (Sq, Skv) is materialized.  Query
    i sits at position ``q_offset + i`` (a block of a split sequence)."""
    b, hq, sq, dk = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dk)
    chunk = min(chunk, skv)
    dev = q.device

    qg = q.float().reshape(b, hkv, g * sq, dk)
    q_pos = q_offset + torch.arange(sq, device=dev)
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


def _proj(x, w, bias, cfg: ModelConfig, positions, rope: bool) -> torch.Tensor:
    """One of q, k, v (B, H, S, hd): the product, the bias if any, and with
    ``rope`` M-RoPE when the config has sections (positions (B, S, 3)),
    else RoPE on the first coordinate of 3-D positions, or on 2-D
    positions as they are."""
    t = _heads(x, w)
    if bias is not None:
        t = t + bias[None, :, None, :]
    if not rope:
        return t
    if cfg.mrope_sections:
        return apply_mrope(t, positions, cfg.mrope_sections, cfg.rope_theta)
    pos2d = positions if positions.ndim == 2 else positions[..., 0]
    return apply_rope(t, pos2d, cfg.rope_theta)


def gqa_attention(
    x: torch.Tensor,  # (B, S, D)
    p,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S), or (B, S, 3) for M-RoPE
    window: Optional[int] = None,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,  # tokens already in the cache
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention on this rank's slices (the module's docstring).

    * no cache: full flash (forward), causal unless ``causal=False`` (the
      encoder's).
    * cache and S > 1: prefill: attend over the fresh k/v only, then write
      them into the cache at ``cache_index``.
    * cache and S == 1: decode: write k/v at ``cache_index`` in place and
      attend over the cache.

    The cache's tensors are updated in place (where the reference's jit
    donates them) and returned.
    """
    x = coll.seq_whole(x)
    s = x.shape[1]
    w = _gathered(p)
    lo, hi, hax = coll.model_range(p["wq"], 1)
    klo, khi, kax = coll.model_range(p["wk"], 1)
    groups = cfg.num_heads // max(cfg.num_kv_heads, 1)
    bias = {n: w[n] if n in w else None for n in ("bq", "bk", "bv")}
    bq = None if bias["bq"] is None else bias["bq"][lo:hi]
    bk = None if bias["bk"] is None else bias["bk"][klo:khi]
    bv = None if bias["bv"] is None else bias["bv"][klo:khi]
    decode = cache is not None and s == 1
    s0, s1, sax = (0, s, ()) if hax or decode else coll.dim_range(s, "seq_tp")
    q = _proj(x[:, s0:s1], w["wq"], bq, cfg, positions[:, s0:s1], True)
    q = partition.constrain(q, ("batch", "heads_tp", None, None) if _head_tp(cfg.num_heads)
                            else ("batch", None, "seq_tp", None))
    k = _proj(x, w["wk"], bk, cfg, positions, True)
    v = _proj(x, w["wv"], bv, cfg, positions, False)
    if cache is not None:
        kf = coll.all_gather(k, kax, 1) if kax else k
        vf = coll.all_gather(v, kax, 1) if kax else v
        _write(cache["k"], kf, cache_index, 2)
        _write(cache["v"], vf, cache_index, 2)
    if decode:
        t0, _, tax = coll.model_range(cache["k"], 2)
        if tax:
            qf = coll.all_gather(q, hax, 1) if hax else q
            out = _split_decode(qf, cache["k"], cache["v"], tax, t0=t0, upto=cache_index,
                                window=window, attn_softcap=cfg.attn_softcap)[:, lo:hi]
        else:
            out = decode_attention(q, _kv_for_heads(cache["k"], lo, hi, groups),
                                   _kv_for_heads(cache["v"], lo, hi, groups), cache_index,
                                   window=window, attn_softcap=cfg.attn_softcap)
    else:
        out = flash_attention(q, _kv_for_heads(k, lo, hi, groups, klo),
                              _kv_for_heads(v, lo, hi, groups, klo), causal=causal,
                              window=window, chunk=cfg.attn_chunk,
                              attn_softcap=cfg.attn_softcap, q_offset=s0)
    return _to_stream(_out_proj(out, w["wo"]), hax, sax), cache


def cross_attention(
    x: torch.Tensor,  # (B, S, D)
    p,
    cfg: ModelConfig,
    *,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # the cached encoder k, v
    enc_out: Optional[torch.Tensor] = None,  # (B, Senc, D), to project
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Encoder-decoder cross attention: no rope, not causal, no biases.

    Projecting (``enc_out`` given), it returns the output and the
    encoder's (k, v), each (B, H, Senc, hd) with every head and position
    of this rank's rows; given the cached ``kv``, those are this rank's
    block of positions of the cache."""
    x = coll.seq_whole(x)
    s = x.shape[1]
    w = _gathered(p)
    lo, hi, hax = coll.model_range(p["wq"], 1)
    if kv is not None:
        ck, cv = kv
        groups = cfg.num_heads // ck.shape[1]
        t0, _, tax = coll.model_range(ck, 2)
        q = _heads(x, w["wq"])
        if tax:
            qf = coll.all_gather(q, hax, 1) if hax else q
            out = _split_decode(qf, ck, cv, tax, t0=t0, upto=None)[:, lo:hi]
        else:
            out = flash_attention(q, _kv_for_heads(ck, lo, hi, groups),
                                  _kv_for_heads(cv, lo, hi, groups), causal=False,
                                  chunk=cfg.attn_chunk)
        return _to_stream(_out_proj(out, w["wo"]), hax, ()), kv
    klo, khi, kax = coll.model_range(p["wk"], 1)
    groups = cfg.num_heads // max(cfg.num_kv_heads, 1)
    s0, s1, sax = (0, s, ()) if hax else coll.dim_range(s, "seq_tp")
    q = _heads(x[:, s0:s1], w["wq"])
    k, v = _heads(enc_out, w["wk"]), _heads(enc_out, w["wv"])
    out = flash_attention(q, _kv_for_heads(k, lo, hi, groups, klo),
                          _kv_for_heads(v, lo, hi, groups, klo), causal=False,
                          chunk=cfg.attn_chunk)
    y = _to_stream(_out_proj(out, w["wo"]), hax, sax)
    if kax:
        k, v = coll.all_gather(k, kax, 1), coll.all_gather(v, kax, 1)
    return y, (k, v)


def encoder_attention(x, p, cfg: ModelConfig, positions):
    """Bidirectional self-attention of the encoder (rope on q and k)."""
    return gqa_attention(x, p, cfg, positions=positions, causal=False)[0]


def _to_stream(y: torch.Tensor, hax, sax) -> torch.Tensor:
    """The output projection ``y`` in the residual stream's layout: the
    block of query positions cut over ``sax`` (the ``seq_tp`` case), else
    every position's partial products over the heads' axes ``hax`` (none:
    whole), summed and reduce-scattered along the sequence.  The queries'
    block is the stream's own where the stream is split (both are
    ``dim_range(S, "seq_tp")``); a sublayer called outside a stream
    gathers it."""
    if not sax:
        return coll.seq_sum(y, hax)
    return y if coll.stream_range()[2] else coll.all_gather(y, sax, 1)


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
    x = coll.seq_whole(x)
    b, s, _ = x.shape
    w = _gathered(p)
    lo, hi, hax = coll.model_range(p["wq"], 1)
    decode = cache is not None and s == 1
    s0, s1, sax = (0, s, ()) if hax or decode else coll.dim_range(s, "seq_tp")
    q_nope, q_pe = _mla_q(x[:, s0:s1], w, cfg, positions[:, s0:s1])
    c_kv, k_pe = _mla_latents(x, w, cfg, positions)
    if cache is not None:
        _write(cache["ckv"], c_kv, cache_index, 1)
        _write(cache["kpe"], k_pe, cache_index, 1)
    if decode:
        t0, _, tax = coll.model_range(cache["ckv"], 1)
        if not tax:
            y = _mla_decode(q_nope, q_pe, cache["ckv"][:, :cache_index + 1],
                            cache["kpe"][:, :cache_index + 1], w, cfg)
            return _to_stream(y, hax, ()), cache
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, :, 0], w["w_uk"])  # (B, h, R)
        q_rot = q_pe[:, :, 0]
        if hax:
            q_lat, q_rot = coll.all_gather(q_lat, hax, 1), coll.all_gather(q_rot, hax, 1)
        n = min(max(cache_index + 1 - t0, 0), cache["ckv"].shape[1])
        ckv, kpe = cache["ckv"][:, :n], cache["kpe"][:, :n]
        scores = (torch.bmm(q_lat.float(), ckv.float().transpose(1, 2))
                  + torch.bmm(q_rot.float(), kpe.float().transpose(1, 2)))
        attn = _split_softmax(scores * (1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)), tax)
        ctx = coll.all_reduce(torch.bmm(attn.to(ckv.dtype).float(), ckv.float()), tax)
        out = torch.einsum("bhr,rhv->bhv", ctx[:, lo:hi].to(ckv.dtype), w["w_uv"])
        y = _out_proj(out.view(b, hi - lo, 1, -1), w["wo"])
        return _to_stream(y, hax, ()), cache
    k_nope = _heads(c_kv, w["w_uk"])  # (B, h, S, nope)
    v = _heads(c_kv, w["w_uv"])
    k = torch.cat([k_nope, k_pe[:, None].expand(b, k_nope.shape[1], s, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = flash_attention(q, k, v, chunk=cfg.attn_chunk, q_offset=s0)
    return _to_stream(_out_proj(out, w["wo"]), hax, sax), cache


def _mla_decode(q_nope, q_pe, ckv, kpe, p, cfg: ModelConfig) -> torch.Tensor:
    """The absorbed decode of one position over the latents ``ckv`` (B, T, R)
    and rotary keys ``kpe`` (B, T, rope) it may read, for the heads of
    ``q_nope``/``q_pe`` (B, h, 1, .) and the weights of those heads.

    The heads ride in the rows of each product (q is (B, h, .) with one
    position), so no product broadcasts the cache over the heads."""
    b, h = q_nope.shape[0], q_nope.shape[1]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, :, 0], p["w_uk"])  # (B, h, R)
    s_lat = torch.bmm(q_lat.float(), ckv.float().transpose(1, 2))  # (B, h, T)
    s_pe = torch.bmm(q_pe[:, :, 0].float(), kpe.float().transpose(1, 2))
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    attn = torch.softmax((s_lat + s_pe) * scale, dim=-1)
    ctx_lat = torch.bmm(attn.to(ckv.dtype), ckv)  # (B, h, R)
    out = torch.einsum("bhr,rhv->bhv", ctx_lat, p["w_uv"])  # (B, h, v)
    return _out_proj(out.view(b, h, 1, -1), p["wo"])


# ---------------------------------------------------------------------------
# The split's helpers
# ---------------------------------------------------------------------------


def _head_tp(n_heads: int) -> bool:
    """The reference's test: heads split over the model axis when it divides them."""
    tp = partition.axis_size("heads_tp")
    return tp > 1 and n_heads % tp == 0


def _gathered(p) -> dict:
    """The block's parameters with their data-axis splits gathered (``coll.weight``)."""
    return {k: coll.weight(v) for k, v in p.items()}


def _kv_for_heads(k: torch.Tensor, lo: int, hi: int, groups: int, kv_lo: int = 0) -> torch.Tensor:
    """The K (or V) that q heads ``[lo, hi)`` read, from ``k`` (B, n, S, d)
    holding KV heads ``[kv_lo, kv_lo + n)``: their own KV heads when the
    block holds whole groups (the grouped layout), else one KV head per q
    head (the reference's ``_expand_kv``)."""
    if lo % groups == 0 and hi % groups == 0:
        return k[:, lo // groups - kv_lo:hi // groups - kv_lo]
    return k[:, torch.arange(lo, hi, device=k.device) // groups - kv_lo]


def _write(cache_t: torch.Tensor, new: torch.Tensor, start: int, dim: int) -> None:
    """Write ``new``, positions ``[start, start + n)`` along ``dim``, into the
    rank's block of the cache's positions (nothing if it holds none)."""
    t0, t1, _ = coll.model_range(cache_t, dim)
    a, e = max(start, t0), min(start + new.shape[dim], t1)
    if a < e:
        cache_t.narrow(dim, a - t0, e - a).copy_(new.narrow(dim, a - start, e - a))


def _split_softmax(scores: torch.Tensor, axes) -> torch.Tensor:
    """The float32 softmax over positions split across ``axes``: ``scores``
    (..., n) are this rank's (n may be 0); returns this rank's probabilities."""
    if scores.shape[-1]:
        m = scores.amax(dim=-1)
    else:
        m = torch.full(scores.shape[:-1], _NEG, dtype=torch.float32, device=scores.device)
    m = coll.all_reduce(m, axes, "max")
    e = torch.exp(scores - m[..., None])
    return e / coll.all_reduce(e.sum(dim=-1), axes)[..., None]


def _split_decode(q, k, v, axes, *, t0: int, upto: Optional[int], window=None,
                  attn_softcap: float = 0.0) -> torch.Tensor:
    """Attention of q (B, H, Sq, dk), every head, over the positions
    ``[t0, t0 + T_local)`` of k/v (B, Hkv, T_local, d) this rank holds,
    combined across ``axes``: positions up to ``upto`` (inclusive; None for
    all) and within ``window`` of it count.  Returns (B, H, Sq, dv)."""
    b, hq, sq, dk = q.shape
    hkv, tl = k.shape[1], k.shape[2]
    g = hq // hkv
    lo = 0 if window is None else max(0, upto - window + 1)
    hi = t0 + tl if upto is None else upto + 1
    a, e = min(max(lo - t0, 0), tl), min(max(hi - t0, 0), tl)
    a = min(a, e)
    kk, vv = k[:, :, a:e], v[:, :, a:e]
    qg = q.float().reshape(b, hkv, g * sq, dk)
    s = softcap((qg @ kk.float().transpose(-1, -2)) * (1.0 / math.sqrt(dk)), attn_softcap)
    p = _split_softmax(s, axes)
    o = coll.all_reduce(p.to(vv.dtype).float() @ vv.float(), axes)
    return o.reshape(b, hq, sq, -1).to(q.dtype)
