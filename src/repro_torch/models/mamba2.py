"""Mamba2 (SSD, state-space duality) mixer: chunked prefill and O(1) decode.

Follows ``repro/models/mamba2.py``: the chunked SSD algorithm (Dao & Gu,
arXiv:2405.21060), an intra-chunk quadratic term and an inter-chunk
state recurrence; decode advances the recurrent state one token at a
time, in constant memory whatever the context length.  The reference
computes all of it outside Pallas, so it stays plain PyTorch here.

* The reference's three-operand einsums are written as explicit products
  in its order (the first two operands multiplied, then one batched
  matrix product), so that no (..., q, q, p) intermediate appears.  At
  zamba2's width (112 heads, chunks of 64, 8 x 4,096 tokens) the largest
  tensor is the (B, nc, H, q, q) decay matrix, 0.94 GB in float32, and a
  layer holds three tensors of that size at once.
* The inter-chunk ``lax.scan`` is a Python loop over the chunks in the
  reference's order (state x decay + chunk state), one ``addcmul`` launch
  a chunk, and one ``stack`` of the states entering the chunks.
* Caches are written in place (the reference returns new ones): ``conv``
  (B, ssm_conv - 1, conv channels) in the model's dtype, the
  *pre-convolution* inputs of the last ssm_conv - 1 tokens; ``state``
  (B, H, P, N), always float32.
* Under a ``DeviceMesh`` the weights are stored by their placements:
  ``in_proj``'s ``embed_tp`` split cuts the packed ``[z, xBC, dt]``
  dimension, not the heads, so the mixer gathers its weights whole at
  use and runs every head on each model rank (a head-aligned split is
  queued in ``ROADMAP.md``).  The caches keep their placements (``conv``
  split over channels, ``state`` over heads): a step gathers them over
  the model axis and writes back the rank's slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import ParamSpec, partition
from ..sharding import collectives as coll
from .config import ModelConfig
from .layers import rmsnorm, rmsnorm_spec


def mamba_specs(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * g * n + h), ("fsdp", "embed_tp"), dtype=cfg.dtype),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), (None, "embed_tp"), dtype=cfg.dtype, scale=0.5),
        "conv_b": ParamSpec((conv_ch,), (None,), dtype=cfg.dtype, init="zeros"),
        "dt_bias": ParamSpec((h,), (None,), dtype="float32", init="zeros"),
        "a_log": ParamSpec((h,), (None,), dtype="float32", init="zeros"),
        "d_skip": ParamSpec((h,), (None,), dtype="float32", init="ones"),
        "norm": rmsnorm_spec(di, cfg.dtype),
        "out_proj": ParamSpec((di, d), ("embed_tp", "fsdp"), dtype=cfg.dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) with out[i, j] = sum_{j<k<=i} x_k, -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return seg.masked_fill(~mask, float("-inf"))


def _ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) float32, after the softplus
    a: torch.Tensor,  # (H,) float32, negative
    b_: torch.Tensor,  # (B, S, G, N)
    c_: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: y (B, S, H, P) float32 and the final state
    (B, H, P, N) float32."""
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    hg = h // g
    s_orig = s
    pad = (-s) % chunk
    if pad:
        # Padding tokens have dt = 0, so dA = 0 (decay 1), and B = C = 0:
        # they neither change the state nor emit output; y is cut back.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_ = F.pad(b_, (0, 0, 0, 0, 0, pad))
        c_ = F.pad(c_, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    q = chunk

    xdt = x.float() * dt[..., None]
    da = dt * a[None, None, :]  # (B, S, H)

    xc = xdt.reshape(bsz, nc, q, h, p)
    dac = da.reshape(bsz, nc, q, h)
    bc = b_.reshape(bsz, nc, q, g, n).float()
    cc = c_.reshape(bsz, nc, q, g, n).float()
    da_cum = torch.cumsum(dac, dim=2)  # (B, nc, q, H)

    # ---- intra-chunk (diagonal blocks): (cb * L) @ x --------------------
    l = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # (B, nc, H, q, q)
    lg = l.view(bsz, nc, g, hg, q, q)
    cb = cc.permute(0, 1, 3, 2, 4) @ bc.permute(0, 1, 3, 4, 2)  # (B, nc, g, i, j)
    m = cb[:, :, :, None] * lg  # (B, nc, g, hg, i, j)
    del l, lg, cb
    xg = xc.view(bsz, nc, q, g, hg, p)
    y_diag = m @ xg.permute(0, 1, 3, 4, 2, 5)  # (B, nc, g, hg, i, p)
    del m

    # ---- chunk states: B^T @ (decay * x) -------------------------------
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (B, nc, q, H)
    w = decay_states.view(bsz, nc, q, g, hg)[..., None] * xg  # (B, nc, j, g, hg, p)
    w = w.permute(0, 1, 3, 2, 4, 5).reshape(bsz, nc, g, q, hg * p)
    states = bc.permute(0, 1, 3, 4, 2) @ w  # (B, nc, g, n, hg*p)
    del w
    states = states.view(bsz, nc, g, n, hg, p).permute(1, 0, 2, 4, 5, 3).reshape(nc, bsz, h, p, n)

    # ---- inter-chunk recurrence ------------------------------------------
    chunk_decay = torch.exp(da_cum[:, :, -1, :]).permute(1, 0, 2)  # (nc, B, H)
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    prev_states, final_state = _chunk_recurrence(states, chunk_decay, init_state.float())
    del states
    prev_states = prev_states.view(nc, bsz, g, hg * p, n)

    # ---- state -> output (off-diagonal blocks): (C @ state^T) * decay ---
    state_decay_in = torch.exp(da_cum)  # (B, nc, q, H)
    cp = cc.permute(1, 0, 3, 2, 4)  # (nc, B, g, i, n)
    y_off = cp @ prev_states.transpose(-1, -2)  # (nc, B, g, i, hg*p)
    y_off = y_off.view(nc, bsz, g, q, hg, p).permute(1, 0, 3, 2, 4, 5)  # (B, nc, i, g, hg, p)
    y_off = y_off * state_decay_in.view(bsz, nc, q, g, hg)[..., None]

    y = y_diag.permute(0, 1, 4, 2, 3, 5) + y_off  # (B, nc, i, g, hg, p)
    y = y.reshape(bsz, s, h, p)[:, :s_orig]
    return y, final_state


def _chunk_recurrence(states: torch.Tensor, decay: torch.Tensor, init: torch.Tensor):
    """The reference's ``lax.scan`` over chunks, in its order: the state
    entering chunk c+1 is (state entering c) x decay[c] + states[c].

    states (nc, B, H, P, N), decay (nc, B, H), init (B, H, P, N), float32.
    Returns the states entering each chunk, stacked (nc, B, H, P, N), and
    the final state.  One ``addcmul`` launch a chunk."""
    carry, entering = init, []
    for ci in range(states.shape[0]):
        entering.append(carry)
        carry = torch.addcmul(states[ci], carry, decay[ci][:, :, None, None])
    return torch.stack(entering), carry


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, S, C), w (K, C); silu after the bias.

    The reference's K explicit tap shifts, y[t] = sum_j w[K-1-j] x[t-j]:
    each shifted tap is added to the rows it reaches (the reference adds
    zeros of its left padding to the others)."""
    k = w.shape[0]
    xf = x.float()
    wf = w.float()
    out = xf * wf[k - 1]
    for j in range(1, k):
        out[:, j:] = out[:, j:] + xf[:, :-j] * wf[k - 1 - j]
    return F.silu(out + b.float()).to(x.dtype)


def mamba_mixer(
    x: torch.Tensor,  # (B, S, D)
    params,
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """The Mamba2 block body (the pre-norm residual is the caller's).

    * cache and S == 1: decode, the conv through the rolling buffer and
      one step of the recurrence; both cache tensors are rewritten.
    * otherwise: the causal conv and the chunked scan (from the cache's
      state if there is a cache); a cache gets the last ssm_conv - 1
      pre-convolution inputs (left-padded with zeros when the prompt is
      shorter) and the final state.
    """
    if partition.distributed():
        return _mixer_mesh(x, params, cfg, cache=cache, cache_index=cache_index)
    return _mixer(x, params, cfg, cache=cache, cache_index=cache_index)


def _mixer(x, params, cfg: ModelConfig, *, cache=None, cache_index=None):
    bsz, s, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    p_ = cfg.ssm_headdim
    conv_ch = di + 2 * g * n

    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = zxbcdt.split([di, conv_ch, h], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, S, H)

    decode = cache is not None and s == 1
    if decode:
        window = torch.cat([cache["conv"], xbc], dim=1)  # (B, K, C)
        xbc_c = (window.float() * params["conv_w"].float()).sum(dim=1)
        xbc_c = F.silu(xbc_c + params["conv_b"].float())[:, None].to(x.dtype)
        cache["conv"].copy_(window[:, 1:])
    else:
        xbc_c = _causal_conv(xbc, params["conv_w"], params["conv_b"])

    xs, b_, c_ = xbc_c.split([di, g * n, g * n], dim=-1)
    xs = partition.constrain(xs.reshape(bsz, s, h, p_), ("batch", None, "heads_tp", None))
    b_ = b_.reshape(bsz, s, g, n)
    c_ = c_.reshape(bsz, s, g, n)
    a = -torch.exp(params["a_log"])  # (H,)

    if decode:
        state = cache["state"].float()  # (B, H, P, N)
        dt1 = dt[:, 0]  # (B, H)
        da = torch.exp(dt1 * a[None, :])
        bh = b_[:, 0].float().repeat_interleave(h // g, dim=1)  # (B, H, N)
        ch = c_[:, 0].float().repeat_interleave(h // g, dim=1)
        xt = xs[:, 0].float()  # (B, H, P)
        new_state = state * da[:, :, None, None] + (xt * dt1[..., None])[..., None] * bh[:, :, None, :]
        y = (new_state @ ch[..., None])[..., 0]  # (B, H, P)
        y = y + params["d_skip"][None, :, None] * xt
        y = y.reshape(bsz, 1, di).to(x.dtype)
        cache["state"].copy_(new_state)
    else:
        init_state = cache["state"] if cache is not None else None
        y, final_state = _ssd_chunked(xs, dt, a, b_, c_, min(cfg.ssm_chunk, s), init_state)
        y = y + params["d_skip"][None, None, :, None] * xs.float()
        y = y.reshape(bsz, s, di).to(x.dtype)
        if cache is not None:  # prefill: leave the cache ready to decode
            kconv = cfg.ssm_conv - 1
            if s >= kconv:
                cache["conv"].copy_(xbc[:, s - kconv:])
            else:
                cache["conv"].zero_()
                cache["conv"][:, kconv - s:] = xbc
            cache["state"].copy_(final_state)

    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], cache


def mamba_cache_specs(cfg: ModelConfig, batch: int, dtype: str):
    """Shapes and dtypes of one layer's decode cache."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": ((batch, cfg.ssm_conv - 1, conv_ch), dtype),
        "state": ((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), "float32"),
    }


#: The cache's logical axes (the reference's ``model.py:cache_specs``).
CACHE_AXES = {"conv": ("batch", None, "embed_tp"), "state": ("batch", "heads_tp", None, None)}


def _mixer_mesh(x, params, cfg: ModelConfig, *, cache=None, cache_index=None):
    """``mamba_mixer`` on this rank's slices: the weights gathered whole, the
    cache gathered over the model axis, the rank's slices written back."""
    whole = {k: coll.whole(v) for k, v in params.items()}
    if cache is None:
        return _mixer(x, whole, cfg)
    full = {k: coll.model_whole(v) for k, v in cache.items()}
    y, full = _mixer(x, whole, cfg, cache=full, cache_index=cache_index)
    for k, v in cache.items():
        v.copy_(coll.model_part(full[k], v))
    return y, cache
