"""A plain two-phase tableau simplex, batched over LPs, in float64.

    maximize c . x   subject to   A x <= b,   x >= 0

``a`` (B, m, n), ``b`` (B, m), ``c`` (B, n).  Textbook method: one slack
a row, one artificial for each row with ``b_i < 0`` (the row is negated
first), phase I maximizes minus the artificials' sum, phase II the
objective.  Dantzig's rule (the largest reduced cost enters, the lowest
column on a tie), the minimum ratio leaves (the lowest row on a tie).
An artificial still basic at zero in phase II leaves at ratio 0 as soon
as the entering column would raise it.  Artificial columns never enter,
so they are not stored; the basis records which rows hold one.

This module is the benchmark's yardstick of what an answer is: it
imports nothing of the system under test and takes only the LPs.

``tf32=True`` is the control: the same method in float32, with every
product's operands rounded to TF32 (10 stored mantissa bits, as the
card's tensor cores read float32) and the sums in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

OPTIMAL, UNBOUNDED, INFEASIBLE, ITER_LIMIT = 1, 2, 3, 4

#: Reduced-cost and pivot tolerance, and the phase-I feasibility factor.
TOL = {torch.float64: 1e-9, torch.float32: 1e-5}


class Answer(NamedTuple):
    objective: torch.Tensor  # (B,) float64; +-inf or nan where not OPTIMAL
    x: torch.Tensor  # (B, n) float64; 0 where not OPTIMAL
    status: torch.Tensor  # (B,) int64
    iterations: torch.Tensor  # (B,) int64: pivots over both phases


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to the nearest TF32 value (13 low mantissa bits cleared)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def solve(a, b, c, *, control: bool = False, max_iters: int = 0) -> Answer:
    """Solve every LP of the batch; see the module docstring."""
    dtype = torch.float32 if control else torch.float64
    mul = (lambda u, v: tf32(u) * tf32(v)) if control else (lambda u, v: u * v)
    a, b, c = (t.to(dtype) for t in (a, b, c))
    bsz, m, n = a.shape
    dev = a.device
    tol = TOL[dtype]
    cap = max_iters if max_iters > 0 else 50 * (m + n)
    rows = torch.arange(m, device=dev)
    ar = torch.arange(bsz, device=dev)

    neg = b < 0
    sign = torch.where(neg, -1.0, 1.0).to(dtype)
    q = 1 + n + m  # rhs, originals, slacks
    tab = torch.zeros((bsz, m + 1, q), dtype=dtype, device=dev)
    tab[:, :m, 0] = b * sign
    tab[:, :m, 1:1 + n] = a * sign[:, :, None]
    tab[:, rows, 1 + n + rows] = sign
    art = neg.clone()  # (B, m): the row's basic variable is its artificial
    basis = torch.where(neg, -1, 1 + n + rows[None, :])
    phase = torch.where(neg.any(dim=1), 1, 2)
    # Phase I: reduced costs of minus the artificials' sum; phase II: c.
    tab[:, m, :] = (tab[:, :m, :] * neg[:, :, None].to(dtype)).sum(dim=1)
    p2 = phase == 2
    tab[p2, m, :] = 0
    tab[p2, m, 1:1 + n] = c[p2]
    c_ext = torch.zeros((bsz, q), dtype=dtype, device=dev)
    c_ext[:, 1:1 + n] = c
    feas = 1e-9 if dtype == torch.float64 else 1e-5
    feas_tol = feas * torch.clamp(b.abs().amax(dim=1), min=1.0)

    status = torch.zeros(bsz, dtype=torch.int64, device=dev)
    iters = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for _ in range(2 * cap + 2):
        live = status == 0
        if not bool(live.any()):
            break
        d = tab[:, m, 1:]
        best, e = d.max(dim=1)
        e = e + 1
        at_opt = live & (best <= tol)
        # Phase I optimum: feasible (on to phase II) or not.
        done1 = at_opt & (phase == 1)
        if bool(done1.any()):
            left = torch.where(art, tab[:, :m, 0], 0.0).sum(dim=1)
            ok = done1 & (left <= feas_tol)
            status = torch.where(done1 & ~ok, INFEASIBLE, status)
            if bool(ok.any()):
                cb = torch.where(art | (basis < 0), 0.0,
                                 torch.gather(c_ext, 1, basis.clamp(min=0)))
                priced = c_ext - mul(cb[:, :, None], tab[:, :m, :]).sum(dim=1)
                tab[:, m, :] = torch.where(ok[:, None], priced, tab[:, m, :])
                phase = torch.where(ok, 2, phase)
        status = torch.where(at_opt & (phase == 2) & ~done1, OPTIMAL, status)
        step = live & ~at_opt
        status = torch.where(step & (iters >= cap), ITER_LIMIT, status)
        step = step & (iters < cap)
        if not bool(step.any()):
            continue
        col = torch.gather(tab, 2, e[:, None, None].expand(bsz, m + 1, 1))[..., 0]
        colm, rhs = col[:, :m], tab[:, :m, 0]
        pos = colm > tol
        ratio = torch.where(pos, rhs / torch.where(pos, colm, 1.0), torch.inf)
        ratio = torch.where(art & (phase == 2)[:, None] & (colm < -tol), 0.0, ratio)
        best_ratio, l = ratio.min(dim=1)
        unbounded = step & torch.isinf(best_ratio)
        status = torch.where(unbounded, UNBOUNDED, status)
        step = step & ~unbounded
        piv = tab[ar, l, :] / col[ar, l][:, None]
        new = tab - mul(col[:, :, None], piv[:, None, :])
        new[ar, l, :] = piv
        tab = torch.where(step[:, None, None], new, tab)
        hit = step[:, None] & (rows[None, :] == l[:, None])
        basis = torch.where(hit, e[:, None], basis)
        art = art & ~hit
        iters = iters + step.to(torch.int64)

    ok = status == OPTIMAL
    x = torch.zeros((bsz, n + 1), dtype=torch.float64, device=dev)
    orig = (basis >= 1) & (basis <= n) & ~art
    x.scatter_add_(1, torch.where(orig, basis, 0), torch.where(orig, tab[:, :m, 0], 0.0).double())
    x = torch.where(ok[:, None], x[:, 1:], 0.0)
    objective = torch.where(ok, -tab[:, m, 0].double(), torch.nan)
    objective = torch.where(status == UNBOUNDED, torch.inf, objective)
    return Answer(objective, x, status, iters)
