"""Batched simplex iteration engine in plain PyTorch.

Follows ``repro/core/engine.py``: the pivot machinery (pricing under
three rules, the in-loop phase I -> II switch, the ratio test with the
degenerate-artificial escape, the rank-1 pivot, solution extraction) as
functions on batched tableaus ``(B, m+1, q)``.  The lockstep loop
``core/simplex.py`` runs them, and together they are the plain version
the CUDA simplex kernel (``kernels/csrc/simplex.cu``) is held against
bit for bit on the card.  The determinism rules that make that hold:

* every product and sum is its own rounded operation (no fused
  multiply-add; the kernel is built with ``-fmad=false``), except the
  float32 rank-1 update (:func:`rank1_update`), which rounds once as
  XLA's contracted loop does;
* the phase-II pricing ``c_ext - c_B . T`` and the phase-I value
  (:func:`phase1_value`) sum over the m rows in ascending order, one
  multiply and one add per row (no ``bmm``);
* every arg-reduction breaks ties toward the lowest index, which
  ``torch.argmax``/``argmin`` document;
* the constants ``tol`` and ``BIG`` are compared in the tableau's dtype.

Only one extraction form exists (gather); the reference's one-hot form
served Mosaic only.

One deliberate difference from the reference: the phase-I feasibility
test reads the basic artificials' values (:func:`phase1_value`) instead
of the objective row's ``-z0``, whose float32 cancellation residue makes
the reference call some feasible LPs infeasible.

Pivot rules: ``"lpc"`` largest positive coefficient (Dantzig, the
paper's default), ``"rpc"`` a random eligible positive column keyed on
the counter hash :func:`rpc_noise`, ``"bland"`` the smallest eligible
positive index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .lp import INFEASIBLE, OPTIMAL, RUNNING
from .tableau import TableauSpec

LPC = "lpc"
RPC = "rpc"
BLAND = "bland"

#: Valid pivot rules, in paper order (lpc is the default everywhere).
RULES = (LPC, RPC, BLAND)

#: Masked-out ratios take this value; ``min_ratio >= BIG / 2`` <=> unbounded.
BIG = 1e30

_MASK32 = 0xFFFFFFFF


def default_tolerance(dtype) -> float:
    """The library-wide reduced-cost/pivot tolerance for a tableau dtype."""
    return 1e-9 if dtype == torch.float64 else 1e-5


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as a 0-dim tensor."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def rank1_update(tab: torch.Tensor, col: torch.Tensor, npr: torch.Tensor) -> torch.Tensor:
    """``tab - col[:, :, None] * npr[:, None, :]``, in float32 rounded once.

    The reference's jitted loop contracts this update into a fused
    multiply-add (``repro/core/engine.py:pivot_update``), and at the
    paper's 100x100 size twice-rounded float32 updates change pivot
    trajectories.  So float32 computes the product (exact in float64)
    and the difference in float64 and rounds once to float32; the CUDA
    kernel takes the same route (``csrc/common.cuh:Arith::fms``), bit for
    bit.  It can differ from a true FMA by a double rounding in rare last
    bits.  float64 stays one multiply and one subtract.
    """
    if tab.dtype == torch.float32:
        wide = torch.float64
        prod = col.to(wide)[:, :, None] * npr.to(wide)[:, None, :]
        return (tab.to(wide) - prod).to(tab.dtype)
    return tab - col[:, :, None] * npr[:, None, :]


def phase1_feasibility_tol(b: torch.Tensor) -> torch.Tensor:
    """(B,) threshold under which the phase-I optimum counts as feasible.

    ``1e-5 * max(1, max|b|)`` in ``b``'s dtype.
    """
    return _const(1e-5, b) * torch.clamp(b.abs().amax(dim=-1), min=1.0)


def eligible_mask(q_total: int, m: int, n: int, device=None) -> torch.Tensor:
    """(1, q_total) bool: originals and slacks (columns ``1..n+m``) may enter."""
    ids = torch.arange(q_total, device=device)[None, :]
    return (ids >= 1) & (ids < 1 + n + m)


# ---------------------------------------------------------------------------
# RPC noise: stateless counter-based hash, uint32 arithmetic in int64
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(x * k) mod 2**32`` for int64 ``x`` in [0, 2**32), without overflow.

    ``k`` is split in 16-bit halves so every partial product stays below
    2**48; the high half only contributes its low 16 bits.
    """
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 avalanche finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def rpc_noise(seed, step, row_offset, bsz: int, q: int, dtype, device=None):
    """(bsz, q) uniform noise in ``dtype``, keyed on (seed, step, row, col).

    Bit-equal to the reference's uint32 hash: torch has no ``>>`` on
    ``uint32`` on the CPU, so the words live in int64 and every product
    is reduced mod 2**32.  The top 24 bits become a float in [0, 1),
    exact in float32 and float64.
    """
    rows = torch.arange(bsz, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(q, dtype=torch.int64, device=device)[None, :]
    rows = (rows + (int(row_offset) & _MASK32)) & _MASK32
    key = (int(seed) & _MASK32) * 0x9E3779B9 & _MASK32
    ctr = (int(step) & _MASK32) * 0x85EBCA6B & _MASK32
    x = _mix32(_mul32(rows, 0xC2B2AE35) ^ cols ^ key ^ ctr)
    scale = torch.tensor(1.0 / (1 << 24), dtype=dtype, device=device)
    return (x >> 8).to(dtype) * scale


# ---------------------------------------------------------------------------
# iteration building blocks
# ---------------------------------------------------------------------------


def select_entering(
    obj: torch.Tensor,
    elig: torch.Tensor,
    rule: str,
    tol: float,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entering column ``e`` (B,) int32 and the largest eligible reduced cost.

    ``max_c <= tol`` certifies optimality under any rule.  Bland's rule
    takes the first eligible positive column: ``torch.argmax`` refuses
    bool input, so the mask is cast to int32 first (first-index ties).
    """
    big = _const(BIG, obj)
    tol_t = _const(tol, obj)
    cand = torch.where(elig, obj, -big)
    max_c = cand.amax(dim=-1)
    if rule == LPC:
        e = cand.argmax(dim=-1)
    elif rule == BLAND:
        pos = elig & (obj > tol_t)
        e = pos.to(torch.int32).argmax(dim=-1)
    elif rule == RPC:
        if noise is None:
            raise ValueError("rpc rule needs a noise array (engine.rpc_noise)")
        pos = elig & (obj > tol_t)
        e = torch.where(pos, noise, -big).argmax(dim=-1)
    else:
        raise ValueError(f"unknown pivot rule {rule!r}; expected one of {RULES}")
    return e.to(torch.int32), max_c


def phase2_objective(
    tab: torch.Tensor, basis: torch.Tensor, spec: TableauSpec, c_ext: torch.Tensor
) -> torch.Tensor:
    """The phase-II objective row ``c_ext - c_B . rows`` for the current basis.

    The sum over the m basic rows runs in ascending row order, one
    multiply and one add per row: the order the CUDA kernel uses.  A
    basic artificial's ID lies past ``c_ext`` in the compact layout, so
    the gather clamps onto the last column, a zero-cost slack lane.
    """
    qe = c_ext.shape[-1]
    idx = torch.clamp(basis.to(torch.int64), max=qe - 1)
    cb = torch.gather(c_ext, 1, idx)  # (B, m)
    priced = torch.zeros_like(c_ext)
    for i in range(spec.m):
        priced = priced + cb[:, i : i + 1] * tab[:, i, :]
    return c_ext - priced


def phase1_value(tab: torch.Tensor, basis: torch.Tensor, spec: TableauSpec) -> torch.Tensor:
    """(B,) phase-I objective: the sum of the basic artificials' values.

    Summed over the rows in ascending order, as the kernel does.  In exact
    arithmetic this is ``-z0 = tab[:, m, 0]``, which the reference reads;
    in float32 ``-z0`` carries the cancellation residue of every phase-I
    pivot (about 1e-5 after 100 pivots on the paper's type-2 LPs), enough
    to push feasible LPs over the feasibility threshold.  The basic
    artificials' values are 0 once they have left the basis.
    """
    value = torch.zeros_like(tab[:, 0, 0])
    for i in range(spec.m):
        value = value + torch.where(
            basis[:, i] >= spec.art_start, tab[:, i, 0], torch.zeros_like(value)
        )
    return value


def phase_transition(
    tab, basis, phase, status, at_opt, c_ext, feas_tol, spec: TableauSpec
):
    """Finish phase II, enter phase II, or declare infeasible; returns
    ``(tab, phase, status)``.

    LPs at a phase-I optimum whose basic artificials sum to at most
    ``feas_tol`` (:func:`phase1_value`) get their objective row rewritten
    by :func:`phase2_objective`; those above it end INFEASIBLE.  Both are
    computed only when some LP needs them.  LPs at a phase-II optimum end
    OPTIMAL.
    """
    active = status == RUNNING
    p1_done = active & at_opt & (phase == 1)
    if bool(p1_done.any()):
        feasible = phase1_value(tab, basis, spec) <= feas_tol
    else:
        feasible = torch.zeros_like(p1_done)
    to_phase2 = p1_done & feasible
    status = torch.where(p1_done & ~feasible, torch.full_like(status, INFEASIBLE), status)
    status = torch.where(
        active & at_opt & (phase == 2), torch.full_like(status, OPTIMAL), status
    )
    if bool(to_phase2.any()):
        new_obj = phase2_objective(tab, basis, spec, c_ext)
        tab = tab.clone()
        tab[:, spec.m, :] = torch.where(to_phase2[:, None], new_obj, tab[:, spec.m, :])
        phase = torch.where(to_phase2, torch.full_like(phase, 2), phase)
    return tab, phase, status


def ratio_test(tab, basis, e, spec: TableauSpec, tol: float):
    """Min-ratio leaving row ``l``, the winning ratio, and the full column.

    Ratios with a non-positive pivot-column entry become :data:`BIG`; a
    basic artificial at value 0 whose column entry is negative is forced
    out at ratio 0 (``zero_art``), which keeps it from growing.
    """
    m = spec.m
    big = _const(BIG, tab)
    tol_t = _const(tol, tab)
    idx = e.to(torch.int64)[:, None, None].expand(tab.shape[0], tab.shape[1], 1)
    full_col = torch.gather(tab, 2, idx)[..., 0]  # (B, m+1)
    col = full_col[:, :m]
    rhs = tab[:, :m, 0]
    pos = col > tol_t
    ratios = torch.where(pos, rhs / torch.where(pos, col, torch.ones_like(col)), big)
    zero_art = (basis >= spec.art_start) & (rhs <= tol_t) & (col < -tol_t)
    ratios = torch.where(zero_art, torch.zeros_like(ratios), ratios)
    l = ratios.argmin(dim=-1).to(torch.int32)
    min_ratio = ratios.amin(dim=-1)
    return l, min_ratio, full_col


def pivot_update(tab, basis, e, l, full_col, do_pivot, spec: TableauSpec, tol: float):
    """Masked rank-1 Gauss-Jordan step around pivot ``(l, e)``.

    ``tab[l] /= tab[l, e]``; every other row subtracts its pivot-column
    multiple of the normalized row (:func:`rank1_update`).  LPs with
    ``do_pivot`` False keep their tableau and basis.
    """
    m = spec.m
    bsz = tab.shape[0]
    l64 = l.to(torch.int64)
    ar = torch.arange(bsz, device=tab.device)
    pr = tab[ar, l64, :]  # (B, Q)
    pe = full_col[ar, l64]  # (B,)
    pe_safe = torch.where(pe.abs() > _const(tol, tab), pe, torch.ones_like(pe))
    npr = pr / pe_safe[:, None]
    updated = rank1_update(tab, full_col, npr)
    updated[ar, l64, :] = npr
    tab = torch.where(do_pivot[:, None, None], updated, tab)
    row_ids = torch.arange(m, device=tab.device)[None, :]
    hit = do_pivot[:, None] & (row_ids == l64[:, None])
    basis = torch.where(hit, e[:, None].to(basis.dtype), basis)
    return tab, basis


def extract_solution(tab, basis, status, spec: TableauSpec, n_out: int, fill: float):
    """Objective and primal point from a terminal tableau.

    ``objective = -tab[:, m, 0]`` where OPTIMAL, else ``fill``; ``x`` puts
    the RHS of each basic original variable into its slot (basis column
    ``j+1`` <-> ``x_j``), and non-optimal LPs report 0.
    """
    m = spec.m
    ok = status == OPTIMAL
    objective = torch.where(ok, -tab[:, m, 0], _const(fill, tab))
    rhs = tab[:, :m, 0]
    var_ids = torch.arange(1, n_out + 1, device=tab.device)[None, None, :]
    hit = basis[:, :, None] == var_ids
    x = torch.where(hit, rhs[:, :, None], torch.zeros_like(rhs)[:, :, None]).sum(dim=1)
    x = torch.where(ok[:, None], x, torch.zeros_like(x))
    return objective, x
