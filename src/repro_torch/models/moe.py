"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, the LP router.

Follows ``repro/models/moe.py``.  Dispatch is sort-based with a static
per-expert capacity (GShard-style): tokens (flattened to T = B*S) pick
their top-k experts; assignments are ranked within each expert by a
stable sort, and those past the capacity are dropped (their contribution
is zero; the residual stream passes them through).

``router="lp"``: the paper's batched simplex solves a (G x E)-variable
transportation relaxation per call (token groups -> experts, maximize
affinity under capacity), and its solution biases the router scores.
The LP goes to ``kernels/ops.py:simplex_solve``: on the card the
hand-written simplex kernel, on CPU tensors its plain version (the
reference calls the kernel's XLA twin, ``core/simplex.py:solve_batched``).

Differences from the reference, none of which changes a result:

* The dispatch keeps the reference's group axis with g = 1: without a
  mesh, ``partition.axis_size("batch")`` is 1 (expert parallelism, g > 1,
  comes with the multi-device slice).  The reference's
  ``partition.constrain`` calls do nothing on one device and are left out.
* ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  does not promise that order, so the top k come from a stable
  descending sort.
* The combine is ``y.at[st].add(eo)`` in the reference, whose updates
  arrive sorted by expert.  ``index_add_`` adds with atomics on the card,
  in an order that changes from run to run; here each token sums its k
  weighted outputs in ascending expert order, the reference's order, so
  results are deterministic on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..sharding import ParamSpec
from .config import ModelConfig
from .layers import mlp, mlp_specs


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": ParamSpec((d, e), ("fsdp", None), dtype="float32"),
        "wi": ParamSpec((e, d, 2 * f), ("expert_tp", "fsdp", None), dtype=cfg.dtype),
        "wo": ParamSpec((e, f, d), ("expert_tp", None, "fsdp"), dtype=cfg.dtype),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(d, f * cfg.num_shared_experts, cfg.dtype)
    return s


def _capacity(t: int, cfg: ModelConfig) -> int:
    """Rows an expert takes from ``t`` tokens: ``t * top_k * capacity_factor /
    E`` rounded up to a multiple of 8, and at least 8.

    The rounding reads like the TPU's sublane padding, but it decides
    which tokens are dropped, so it is part of the function and is kept
    (unlike the kernels' padding, which the port leaves out).
    """
    c = math.ceil(t * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def lp_router_problem(logits: torch.Tensor, cfg: ModelConfig):
    """The router's transportation LP for logits (T, E), as the reference
    builds it, in float32 whatever the model's dtype.

    Tokens are grouped by ``t mod G``; the decision variable y[g, e] is the
    fraction of group g routed to expert e:

        max   sum affinity[g,e] * y[g,e]
        s.t.  sum_e y[g,e] <= 1                      (per group)
              sum_g (count_g / T) y[g,e] <= cap_e    (per expert)

    Returns ``(a (1, G+E, G*E), b (1, G+E), c (1, G*E), groups (T,))``.
    """
    t, e = logits.shape
    g = cfg.router_groups
    dev = logits.device
    groups = torch.arange(t, device=dev) % g  # static grouping (cheap, deterministic)
    # (T, G) one-hot by comparison: F.one_hot checks its range on the host
    onehot = (groups[:, None] == torch.arange(g, device=dev)).to(logits.dtype)
    counts = onehot.sum(dim=0)  # (G,)
    affinity = onehot.t() @ torch.softmax(logits, dim=-1)
    affinity = affinity / torch.clamp(counts[:, None], min=1.0)

    nvar, ncon = g * e, g + e
    cols = torch.arange(nvar, device=dev)
    row_g = torch.arange(g, device=dev).repeat_interleave(e)
    col_e = torch.arange(e, device=dev).repeat(g)
    a = torch.zeros((1, ncon, nvar), dtype=torch.float32, device=dev)
    a[0, row_g, cols] = 1.0  # group rows
    a[0, g + col_e, cols] = (counts[row_g] / t).float()  # weight by group mass
    cap = torch.full((e,), cfg.top_k * cfg.capacity_factor / e, dtype=torch.float32, device=dev)
    b = torch.cat([torch.ones((g,), dtype=torch.float32, device=dev), cap])[None]
    c = affinity.reshape(1, nvar).float()
    return a, b, c, groups


def _lp_balance_bias(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LP-balanced routing bias (T, E): the LP of :func:`lp_router_problem`
    solved by the simplex kernel (its plain version on CPU tensors) with
    the default rule, LPC; ``log(clip(y, 0, 1) + 1e-6)`` of the optimal y,
    each token taking its group's row."""
    from ..kernels import ops  # the kernels load at first use

    a, b, c, groups = lp_router_problem(logits, cfg)
    g, e = cfg.router_groups, logits.shape[1]
    nvar, ncon = a.shape[2], a.shape[1]
    sol = ops.simplex_solve(a, b, c, max_iters=8 * (nvar + ncon))
    y = torch.clamp(sol.x.reshape(g, e), 0.0, 1.0)
    bias = torch.log(y + 1e-6)  # (G, E)
    return bias[groups].to(logits.dtype)


def route(xf: torch.Tensor, p, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: (T, D) -> (weights (T, k) in ``xf``'s dtype, experts (T, k))."""
    logits = xf.float() @ p["router"]
    if cfg.router == "lp":
        logits = logits + _lp_balance_bias(logits, cfg)
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights, experts = top.values[:, :cfg.top_k], top.indices[:, :cfg.top_k]
    weights = torch.softmax(weights, dim=-1)
    return weights.to(xf.dtype), experts


def dispatch(experts: torch.Tensor, cap: int, num_experts: int):
    """The capacity dispatch of one group's (T, k) expert choices.

    Returns ``(order, slot, keep)``, each (T*k,): the stable sort of the
    flattened choices by expert, and for each sorted assignment its row
    in the (E*C + 1)-row buffer (the last row is the scratch row that
    takes every assignment past its expert's capacity) and whether it
    was kept.
    """
    flat_e = experts.reshape(-1)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = torch.searchsorted(se, torch.arange(num_experts, device=se.device,
                                                    dtype=se.dtype))
    rank = torch.arange(n, device=se.device) - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, torch.full_like(se, num_experts * cap))
    return order, slot, keep


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    Group-local dispatch with one group (g = 1) on one device: route, sort
    the assignments by expert, gather each expert's rows into (E, C, D)
    buffers, run the experts as batched products, and combine each
    token's kept outputs weighted by its router weights.
    """
    b, s, d = x.shape
    t = b * s
    g = 1  # the reference's partition.axis_size("batch") without a mesh
    tl = t // g
    cap = _capacity(tl, cfg)

    xg = x.reshape(g, tl, d)
    weights, experts = route(xg.reshape(t, d), p, cfg)  # (T, k), (T, k)
    ys = []
    for gi in range(g):
        ys.append(_group_ffn(xg[gi], weights[gi * tl:(gi + 1) * tl],
                             experts[gi * tl:(gi + 1) * tl], p, cfg, cap))
    y = torch.stack(ys)
    if cfg.num_shared_experts:
        y = y + mlp(x, p["shared"]["wi"], p["shared"]["wo"], cfg.act).reshape(g, tl, d)
    return y.reshape(b, s, d)


def _group_ffn(xt, weights, experts, p, cfg: ModelConfig, cap: int) -> torch.Tensor:
    """One group's routed experts: (T, D) tokens -> (T, D)."""
    tl, d = xt.shape
    k, e = cfg.top_k, cfg.num_experts
    order, slot, keep = dispatch(experts, cap, e)
    tok_of = torch.arange(tl, device=xt.device).repeat_interleave(k)
    st = tok_of[order]
    sw = weights.reshape(-1)[order]

    # Every kept slot is written once; the overflow all lands on the
    # scratch row, which is dropped (no boolean indexing: it would wait
    # for the device).
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt[st]
    buf = buf[:-1].view(e, cap, d)

    h = torch.bmm(buf, p["wi"])
    gg, u = h.chunk(2, dim=-1)
    gg = F.silu(gg) if cfg.act == "silu" else F.gelu(gg, approximate="tanh")
    out = torch.bmm(gg * u, p["wo"]).reshape(e * cap, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=out.dtype, device=out.device)])

    expert_out = out[slot] * (sw * keep).to(xt.dtype)[:, None]
    # Each token's k outputs in sorted position order, which is ascending
    # expert order (the sort is stable and a token picks distinct experts).
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=order.device)
    pos = pos.view(tl, k).sort(dim=1).values
    parts = expert_out[pos]  # (T, k, D)
    y = torch.zeros((tl, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        y = y + parts[:, j]
    return y
