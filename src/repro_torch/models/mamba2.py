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
* Under a ``DeviceMesh`` every weight and cache leaf is stored by its
  placements, and no weight or cache leaf is gathered over the model
  axis.  Where the model axes that ``heads_tp`` resolves to hold more
  than one rank and divide ``ssm_heads`` (the reference's rule:
  ``partition.resolve_spec`` drops an indivisible axis), rank r of t
  runs the heads [r H/t, (r+1) H/t), as the reference's constraint of
  the scan's input to ``("batch", None, "heads_tp", None)`` does
  (``head_split``); elsewhere every rank runs every head.  ``in_proj``
  is column-parallel on its stored block of the packed ``[z, xBC, dt]``
  columns, the product (an activation) gathered over the model axis and
  indexed by the heads' own column ranges; the depthwise conv runs on
  the channels the rank stores (its blocks of ``conv_w`` and of the
  conv cache, which is used in place), its output gathered over the
  model axis and cut to the channels the rank's heads read (their x,
  their groups' B and C: the channel split does not line up with
  heads); the scan and the decode step run on the rank's heads, the
  ``state`` cache used in place; the gated RMSNorm's sum of squares is
  summed over the head axes in float32; ``out_proj`` is row-parallel on
  its stored rows (exactly the rank's heads where the heads are split),
  the partial products summed over the model axis.  Without a mesh, or
  on one that splits nothing, these are the plain products.  Inside a
  model the mixer's input arrives as this rank's block of the residual
  stream's positions (``sharding/collectives.py``): it is gathered along
  the sequence first (the conv and the scan run over every position of
  the rank's heads), and ``out_proj``'s partial products are
  reduce-scattered along the sequence into the block (cut to it where
  no model axis splits them); a decode step's one position is whole.  CPU
  coverage on gloo ranks: ``tests/test_torch_mamba2_mesh.py``,
  ``tests/test_torch_lm_mesh_families.py``, ``tests/test_torch_mesh_train.py``;
  on the card, ``chip_smoke.py``'s slice 14 (alone: ``python3
  tools/lm_mesh_phase.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import ParamSpec
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
    """The Mamba2 block body (the pre-norm residual is the caller's), on
    this rank's heads under a mesh (the module's docstring): inside a
    model ``x`` is this rank's block of the residual stream's positions,
    and so is the output.

    * cache and S == 1: decode, the conv through the rolling buffer and
      one step of the recurrence; both cache tensors are rewritten.
    * otherwise: the causal conv and the chunked scan (from the cache's
      state if there is a cache); a cache gets the last ssm_conv - 1
      pre-convolution inputs (left-padded with zeros when the prompt is
      shorter) and the final state.
    """
    h0, h1, axes = head_split(params, cfg)
    x = coll.seq_whole(x)  # the conv and the scan run over every position
    bsz, s, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    p_, hl = cfg.ssm_headdim, h1 - h0
    gl = max(1, hl * g // h)
    conv_ch = di + 2 * g * n

    zxbcdt = x @ coll.weight(params["in_proj"])
    _, _, cols = coll.model_range(params["in_proj"], 1)
    if cols:  # the product's columns from every rank (its backward: the reduce-scatter)
        zxbcdt = coll.all_gather(zxbcdt, cols, -1)
    z, xbc, dt = zxbcdt.split([di, conv_ch, h], dim=-1)
    z = z[..., h0 * p_:h1 * p_]
    dt = F.softplus(dt[..., h0:h1].float() + params["dt_bias"][h0:h1])  # (B, S, H)

    # the depthwise conv on the channels this rank stores (conv_w, the conv
    # cache), its output gathered and cut to the channels these heads read
    c0, c1, caxes = coll.model_range(params["conv_w"], 1)
    conv_w, conv_b = coll.weight(params["conv_w"]), params["conv_b"][c0:c1]
    xbc = xbc[..., c0:c1]
    decode = cache is not None and s == 1
    if decode:
        xbc_c = _conv_step(cache["conv"], xbc, conv_w, conv_b)
    else:
        xbc_c = _causal_conv(xbc, conv_w, conv_b)
    if caxes:
        xbc_c = coll.all_gather(xbc_c, caxes, -1)
    if hl < h:
        xbc_c = _own_channels(xbc_c, cfg, h0, h1)

    xs, b_, c_ = xbc_c.split([hl * p_, gl * n, gl * n], dim=-1)
    xs = xs.reshape(bsz, s, hl, p_)
    b_ = b_.reshape(bsz, s, gl, n)
    c_ = c_.reshape(bsz, s, gl, n)
    a = -torch.exp(params["a_log"][h0:h1])  # (H,)
    d_skip = params["d_skip"][h0:h1]

    if decode:
        y = _decode_step(cache["state"], xs, dt, a, b_, c_, d_skip)
        y = y.reshape(bsz, 1, hl * p_).to(x.dtype)
    else:
        init_state = cache["state"] if cache is not None else None
        y, final_state = _ssd_chunked(xs, dt, a, b_, c_, min(cfg.ssm_chunk, s), init_state)
        y = y + d_skip[None, None, :, None] * xs.float()
        y = y.reshape(bsz, s, hl * p_).to(x.dtype)
        if cache is not None:  # prefill: leave the cache ready to decode
            _write_conv(cache["conv"], xbc, cfg.ssm_conv - 1)
            cache["state"].copy_(final_state)

    y = y * F.silu(z.float()).to(x.dtype)
    if axes:
        y = _split_rmsnorm(y, params["norm"][h0 * p_:h1 * p_], di, cfg.norm_eps, axes)
    else:
        y = rmsnorm(y, params["norm"], cfg.norm_eps)
    # out_proj's stored rows: these heads' where they are split (head_split)
    lo, hi, rows = coll.model_range(params["out_proj"], 0)
    y = y[..., lo - h0 * p_:hi - h0 * p_] @ coll.weight(params["out_proj"])
    return coll.seq_sum(y, rows), cache


def _conv_step(conv: torch.Tensor, xbc: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One decode token's depthwise conv: the window of the ``conv`` cache
    (B, K - 1, C) and ``xbc`` (B, 1, C) against ``w`` (K, C), silu after
    the bias; the cache advanced in place."""
    window = torch.cat([conv, xbc], dim=1)  # (B, K, C)
    out = (window.float() * w.float()).sum(dim=1)
    conv.copy_(window[:, 1:])
    return F.silu(out + b.float())[:, None].to(xbc.dtype)


def _decode_step(state, xs, dt, a, b_, c_, d_skip) -> torch.Tensor:
    """One step of the recurrence on the heads of ``xs`` (B, 1, H, P), with
    ``dt`` (B, 1, H), ``a`` and ``d_skip`` (H,), ``b_`` and ``c_`` (B, 1,
    G, N): the ``state`` cache (B, H, P, N) advanced in place; returns y
    (B, H, P) float32, the skip term added."""
    h, g = xs.shape[2], b_.shape[2]
    st = state.float()
    dt1 = dt[:, 0]  # (B, H)
    da = torch.exp(dt1 * a[None, :])
    bh = b_[:, 0].float().repeat_interleave(h // g, dim=1)  # (B, H, N)
    ch = c_[:, 0].float().repeat_interleave(h // g, dim=1)
    xt = xs[:, 0].float()  # (B, H, P)
    new_state = st * da[:, :, None, None] + (xt * dt1[..., None])[..., None] * bh[:, :, None, :]
    y = (new_state @ ch[..., None])[..., 0]  # (B, H, P)
    state.copy_(new_state)
    return y + d_skip[None, :, None] * xt


def _write_conv(conv: torch.Tensor, xbc: torch.Tensor, kconv: int) -> None:
    """A prefill's conv cache: the last ``kconv`` pre-convolution inputs
    of ``xbc`` (B, S, C), left-padded with zeros when S is shorter."""
    s = xbc.shape[1]
    if s >= kconv:
        conv.copy_(xbc[:, s - kconv:])
    else:
        conv.zero_()
        conv[:, kconv - s:] = xbc


def mamba_cache_specs(cfg: ModelConfig, batch: int, dtype: str):
    """Shapes and dtypes of one layer's decode cache."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": ((batch, cfg.ssm_conv - 1, conv_ch), dtype),
        "state": ((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), "float32"),
    }


#: The cache's logical axes (the reference's ``model.py:cache_specs``).
CACHE_AXES = {"conv": ("batch", None, "embed_tp"), "state": ("batch", "heads_tp", None, None)}


def head_split(params, cfg: ModelConfig) -> Tuple[int, int, Tuple[str, ...]]:
    """``(h0, h1, axes)``: the heads [h0, h1) this rank runs and the model
    axes that split them, where those axes hold more than one rank and
    divide ``ssm_heads``; every head and no axes elsewhere.  Raises where
    ``out_proj``'s rows are not split into exactly those heads, or where
    the rank's heads cut a group of B and C otherwise than whole or
    within one."""
    h0, h1, axes = coll.dim_range(cfg.ssm_heads, "heads_tp")
    if not axes:
        return h0, h1, axes
    p_ = cfg.ssm_headdim
    if coll.model_range(params["out_proj"], 0) != (h0 * p_, h1 * p_, axes):
        raise ValueError(f"mamba2: out_proj's rows are not split at the heads [{h0}, {h1})")
    hg, mine = cfg.ssm_heads // cfg.ssm_ngroups, h1 - h0
    if mine % hg and hg % mine:
        raise ValueError(f"mamba2: {mine} heads a rank cut the groups of {hg} heads")
    return h0, h1, axes


def _own_channels(t: torch.Tensor, cfg: ModelConfig, h0: int, h1: int) -> torch.Tensor:
    """The conv channels (``t``'s last dimension, the packed ``[x, B, C]``)
    that heads [h0, h1) read: their x, and their groups' B and C."""
    di, g, n, p_ = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    hg = cfg.ssm_heads // g
    g0, g1 = h0 // hg, (h1 - 1) // hg + 1
    return torch.cat([t[..., h0 * p_:h1 * p_], t[..., di + g0 * n:di + g1 * n],
                      t[..., di + (g + g0) * n:di + (g + g1) * n]], dim=-1)


def _norm_sum(sq: torch.Tensor, axes) -> torch.Tensor:
    """The gated RMSNorm's sum of squares completed over the model axes (a
    function of its own so that a negative control can leave it out)."""
    return coll.all_reduce(sq, axes)


def _split_rmsnorm(u: torch.Tensor, w: torch.Tensor, width: int, eps: float, axes) -> torch.Tensor:
    """``rmsnorm`` over a dimension of ``width`` whose slices the ranks of
    ``axes`` hold (``u`` and the weight ``w`` this rank's): the sum of
    squares in float32, summed over the axes."""
    uf = u.float()
    var = _norm_sum((uf * uf).sum(dim=-1, keepdim=True), axes) / width
    return (uf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(u.dtype)
