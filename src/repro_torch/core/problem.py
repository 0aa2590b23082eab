"""General-form LP problems and canonicalization to the paper's standard form.

Follows ``repro/core/problem.py``.  Users speak general form

    minimize|maximize  c . x
    subject to         bl <= A x <= bu        (equality rows: bl == bu)
                       lo <= x  <= hi         (free vars: lo = -inf)

and the solver consumes ``max c.x, Ax <= b, x >= 0``.  ``canonicalize``
lowers an :class:`LPProblem` with value masking over fixed shapes:

  * objective     max (s c) . x'   with s = +1 (maximize) / -1 (minimize)
  * shift         x = lo' + x_pos - x_neg, lo' = lo where finite else 0
  * upper rows    A x <= bu        ->  A x' <= bu - A lo'      (finite bu)
  * lower rows    bl <= A x        -> -A x' <= A lo' - bl      (finite bl)
  * bound rows    x_j <= hi_j      ->  x'_j <= hi_j - lo'_j    (finite hi)
  * free split    x_neg columns exist iff any lo_j = -inf

A row whose bound is infinite becomes the always-satisfied ``0 . x' <= 1``.
The structure flags (``maximize``, ``split``, ``boxlike``, ``row_lower``,
``var_upper``) are plain dataclass fields fixed by :meth:`LPProblem.make`
from the concrete bounds; ``boxlike`` problems (no rows, finite box) go
to the closed-form hyperbox path instead of the simplex.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .lp import (INFEASIBLE, NUMERICAL, OPTIMAL, LPBatch, LPSolution, SharedLPBatch, _writable,
                 resolve_device, row_sum)

_INF = float("inf")


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def validate_problem(problem: "LPProblem", where: str = "LPProblem") -> None:
    """Reject NaN anywhere, and Inf in ``c``/``a``, naming the field.

    Infinite bounds are legitimate: they mean "unbounded".
    """
    for field, inf_ok in (("c", False), ("a", False), ("bl", True), ("bu", True),
                          ("lo", True), ("hi", True)):
        v = getattr(problem, field)
        if bool(torch.isnan(v).any()):
            raise ValueError(f"{where}.{field} contains NaN")
        if not inf_ok and bool(torch.isinf(v).any()):
            raise ValueError(f"{where}.{field} contains non-finite values (Inf)")


@dataclasses.dataclass(frozen=True)
class LPProblem:
    """A batch of B general-form LPs of identical (m, n) shape.

    Build instances with :meth:`LPProblem.make`, which fills defaults
    (``lo = 0``, ``hi = +inf``, no rows) and derives the structure flags.
    """

    c: torch.Tensor  # (B, n) objective
    a: torch.Tensor  # (B, m, n) general rows (m may be 0)
    bl: torch.Tensor  # (B, m) row lower bounds (-inf = none)
    bu: torch.Tensor  # (B, m) row upper bounds (+inf = none)
    lo: torch.Tensor  # (B, n) variable lower bounds (-inf = free below)
    hi: torch.Tensor  # (B, n) variable upper bounds (+inf = none)
    # Optional warm-start basis in CANONICAL column space; a hint only.
    basis0: Optional[torch.Tensor] = None  # (B, m') int32
    maximize: bool = True
    split: bool = False  # canonical form carries x_neg columns
    boxlike: bool = False  # no rows + finite box: hyperbox route
    row_lower: bool = True  # any finite bl: emit the -Ax <= -bl block
    var_upper: bool = True  # any finite hi: emit the x <= hi block

    @property
    def batch(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[1]

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    @property
    def device(self) -> torch.device:
        return self.c.device

    @classmethod
    def make(cls, c, a=None, bl=None, bu=None, lo=None, hi=None, maximize: bool = True,
             dtype=None, basis0=None, validate: bool = True, device=None) -> "LPProblem":
        """Normalize user inputs into a batched ``LPProblem`` on ``device``.

        Inputs may be numpy arrays, sequences or tensors; ``c`` is
        ``(n,)`` or ``(B, n)``, ``a`` ``(m, n)`` or ``(B, m, n)``, and the
        bounds broadcast over the batch.  ``device=None`` means the card
        (and raises without one); pass ``device="cpu"`` for the CPU.
        ``dtype`` defaults to ``c``'s floating dtype, else float64.
        """
        dev = resolve_device(device)
        if dtype is None:
            if isinstance(c, torch.Tensor):
                dtype = c.dtype if c.is_floating_point() else torch.float64
            else:
                cn = np.asarray(c)
                dtype = cn.dtype if np.issubdtype(cn.dtype, np.floating) else np.float64
        dtype = _torch_dtype(dtype)

        def tensor(v):
            if isinstance(v, torch.Tensor):
                return v.to(device=dev, dtype=dtype)
            return torch.as_tensor(_writable(v), dtype=dtype, device=dev)

        c = tensor(c)
        if c.dim() == 1:
            c = c[None]
        bsz, n = c.shape
        if a is None:
            a = torch.zeros((bsz, 0, n), dtype=dtype, device=dev)
        else:
            a = tensor(a)
            if a.dim() == 2:
                a = a[None].expand(bsz, *a.shape)
            a = a.contiguous()
        m = a.shape[1]

        def bound(v, fill, width):
            if v is None:
                return torch.full((bsz, width), fill, dtype=dtype, device=dev)
            v = tensor(v)
            if v.dim() == 0:
                v = v[None]
            return v.expand(bsz, width).contiguous()

        bl = bound(bl, -_INF, m)
        bu = bound(bu, _INF, m)
        lo = bound(lo, 0.0, n)
        hi = bound(hi, _INF, n)

        split = bool(torch.isneginf(lo).any())
        boxlike = m == 0 and bool(torch.isfinite(lo).all() and torch.isfinite(hi).all())
        problem = cls(
            c=c, a=a, bl=bl, bu=bu, lo=lo, hi=hi,
            basis0=None if basis0 is None else (
                basis0 if isinstance(basis0, torch.Tensor) else torch.as_tensor(_writable(basis0))
            ).to(device=dev, dtype=torch.int32),
            maximize=bool(maximize),
            split=split,
            boxlike=boxlike,
            row_lower=bool(torch.isfinite(bl).any()),
            var_upper=bool(torch.isfinite(hi).any()),
        )
        if validate:
            validate_problem(problem)
        return problem

    @classmethod
    def from_batch(cls, batch: LPBatch) -> "LPProblem":
        """Wrap an already-canonical ``LPBatch`` (max, Ax <= b, x >= 0)."""
        bsz, m, _ = batch.a.shape
        return cls(
            c=batch.c,
            a=batch.a,
            bl=torch.full((bsz, m), -_INF, dtype=batch.a.dtype, device=batch.a.device),
            bu=batch.b,
            lo=torch.zeros_like(batch.c),
            hi=torch.full_like(batch.c, _INF),
            basis0=batch.basis0,
            maximize=True,
            split=False,
            boxlike=False,
            row_lower=False,
            var_upper=False,
        )

    def pad_to(self, m_pad: int, n_pad: int) -> "LPProblem":
        """Grow to shape class (m_pad, n_pad) with disabled rows and columns.

        Padding rows get (-inf, +inf) bounds; padding variables are dead
        columns (zero cost and coefficients, lo = 0, hi = +inf), except in
        boxlike problems, where they are pinned at lo = hi = 0.
        """
        if m_pad < self.m or n_pad < self.n:
            raise ValueError(
                f"pad_to({m_pad}, {n_pad}) smaller than problem ({self.m}, {self.n})"
            )
        if (m_pad, n_pad) == (self.m, self.n):
            return self
        dm, dn = m_pad - self.m, n_pad - self.n
        boxlike_pad = self.boxlike and m_pad == 0
        return LPProblem(
            c=F.pad(self.c, (0, dn)),
            a=F.pad(self.a, (0, dn, 0, dm)),
            bl=F.pad(self.bl, (0, dm), value=-_INF),
            bu=F.pad(self.bu, (0, dm), value=_INF),
            lo=F.pad(self.lo, (0, dn)),
            hi=F.pad(self.hi, (0, dn), value=0.0 if boxlike_pad else _INF),
            # Padding moves the canonical columns: a carried basis would
            # point at the wrong ones, so the hint is dropped.
            basis0=None,
            maximize=self.maximize,
            split=self.split,
            boxlike=boxlike_pad,
            row_lower=self.row_lower,
            var_upper=self.var_upper or (dn > 0 and boxlike_pad),
        )


def stack_problems(problems: Sequence[LPProblem]) -> LPProblem:
    """Concatenate same-shape, same-sense problems along the batch axis."""
    if not problems:
        raise ValueError("cannot stack an empty problem list")
    shapes = {(p.m, p.n) for p in problems}
    if len(shapes) > 1:
        raise ValueError(f"stack_problems needs one shape class, got {sorted(shapes)}")
    if len({p.maximize for p in problems}) > 1:
        raise ValueError("stack_problems needs a uniform objective sense")

    def cat(f):
        return torch.cat([getattr(p, f) for p in problems], dim=0)

    return LPProblem(
        c=cat("c"), a=cat("a"), bl=cat("bl"), bu=cat("bu"), lo=cat("lo"), hi=cat("hi"),
        basis0=cat("basis0") if all(p.basis0 is not None for p in problems) else None,
        maximize=problems[0].maximize,
        split=any(p.split for p in problems),
        boxlike=all(p.boxlike for p in problems),
        row_lower=any(p.row_lower for p in problems),
        var_upper=any(p.var_upper for p in problems),
    )


#: Rows a block of ``canonicalize``'s row-local ``A lo`` product holds.
A_LO_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class Canonicalized:
    """A canonical ``LPBatch`` plus the data needed to map solutions back."""

    batch: LPBatch  # or SharedLPBatch (canonicalize_shared)
    c_user: torch.Tensor  # (B, n) original objective
    shift: torch.Tensor  # (B, n) lo' applied as x = lo' + x'
    n: int = 0
    sign: int = 1  # +1 maximize, -1 minimize
    split: bool = False


def canonicalize(problem: LPProblem) -> Canonicalized:
    """Lower general form to the paper's ``max c.x, Ax <= b, x >= 0``."""
    p = problem
    bsz, m, n = p.a.shape
    dtype, dev = p.a.dtype, p.a.device
    sign = 1 if p.maximize else -1

    lo0 = torch.where(torch.isfinite(p.lo), p.lo, torch.zeros_like(p.lo))
    free = torch.isneginf(p.lo)
    # A lo by a fixed tree over each row (core/lp.py:row_sum), so a row's b
    # bits depend on that row alone: a batched einsum changes them with the
    # batch size on the card, and the serve loop admits requests a few at a
    # time.  In blocks of rows, which bounds the (rows, m, n) product.
    a_lo = torch.cat([row_sum(a * lo[:, None, :])
                      for a, lo in zip(p.a.split(A_LO_ROWS), lo0.split(A_LO_ROWS))])

    fin_u = torch.isfinite(p.bu)
    a_blocks = [torch.where(fin_u[:, :, None], p.a, 0.0)]
    b_blocks = [torch.where(fin_u, p.bu - a_lo, 1.0)]
    if p.row_lower:
        fin_l = torch.isfinite(p.bl)
        a_blocks.append(torch.where(fin_l[:, :, None], -p.a, 0.0))
        b_blocks.append(torch.where(fin_l, a_lo - p.bl, 1.0))
    if p.var_upper:
        fin_h = torch.isfinite(p.hi)
        eye = torch.eye(n, dtype=dtype, device=dev).expand(bsz, n, n)
        a_blocks.append(torch.where(fin_h[:, :, None], eye, 0.0))
        b_blocks.append(torch.where(fin_h, p.hi - lo0, 1.0))

    a_std = torch.cat(a_blocks, dim=1)  # (B, m', n), m' <= 2m+n
    b_std = torch.cat(b_blocks, dim=1)  # (B, m')
    if a_std.shape[1] == 0:
        # Constraint-free problems: one disabled row keeps the tableau
        # well-formed; the simplex then reports OPTIMAL at 0 or UNBOUNDED.
        a_std = torch.zeros((bsz, 1, n), dtype=dtype, device=dev)
        b_std = torch.ones((bsz, 1), dtype=dtype, device=dev)
    c_std = (sign * p.c).to(dtype)
    if p.split:
        a_neg = torch.where(free[:, None, :], -a_std, 0.0)
        a_std = torch.cat([a_std, a_neg], dim=2)  # (B, m', 2n)
        c_std = torch.cat([c_std, torch.where(free, -c_std, 0.0)], dim=1)

    basis0 = p.basis0
    if basis0 is not None and basis0.shape[-1] != a_std.shape[1]:
        raise ValueError(
            f"basis0 has {basis0.shape[-1]} rows but the canonical form has "
            f"{a_std.shape[1]} — feed a basis from a solve of a problem with "
            "the same structure flags"
        )
    return Canonicalized(
        batch=LPBatch(a_std.contiguous(), b_std.contiguous(), c_std.contiguous(), basis0),
        c_user=p.c,
        shift=lo0,
        n=n,
        sign=sign,
        split=p.split,
    )


def canonicalize_shared(problem: LPProblem) -> Canonicalized:
    """Canonicalize a batch whose rows share ONE constraint system.

    Runs :func:`canonicalize` and keeps a single copy of the canonical
    matrix (:class:`~repro_torch.core.lp.SharedLPBatch`), which the
    dispatch routes to the revised-simplex backends.  :func:`uncanonicalize`
    works unchanged on the result.  The canonical rows must be identical
    across the batch, the shared matrix finite, and ``b``/``c`` free of
    NaN; each failure raises ``ValueError``.
    """
    canon = canonicalize(problem)
    batch = canon.batch
    a0 = batch.a[0]
    if bool((batch.a != a0[None]).any()):
        raise ValueError(
            "canonicalize_shared: canonical constraint matrices differ across the "
            "batch; solve as a plain LPBatch instead"
        )
    if not bool(torch.isfinite(a0).all()):
        raise ValueError(
            "canonicalize_shared: the shared constraint matrix contains NaN/Inf; "
            "reject the input instead of poisoning every batched variant"
        )
    if bool(torch.isnan(batch.b).any()) or bool(torch.isnan(batch.c).any()):
        raise ValueError("canonicalize_shared: canonical b/c contain NaN")
    shared = SharedLPBatch(a0.contiguous(), batch.b, batch.c, basis0=batch.basis0)
    return dataclasses.replace(canon, batch=shared)


def uncanonicalize(canon: Canonicalized, sol: LPSolution) -> LPSolution:
    """Map a canonical-form solution back to user coordinates.

    ``x = shift + x_pos - x_neg``; the objective is re-evaluated as
    ``c_user . x`` (``core/lp.py:row_sum``, so a row's objective does not
    depend on the rows mapped back beside it).  Non-optimal LPs report -inf when maximizing, +inf
    when minimizing, and NaN for ``NUMERICAL``.  ``basis`` stays in
    canonical column space (the warm-start currency).
    """
    n = canon.n
    x = canon.shift + sol.x[:, :n]
    if canon.split:
        x = x - sol.x[:, n : 2 * n]
    ok = sol.status == OPTIMAL
    bad = -_INF if canon.sign > 0 else _INF
    objective = torch.where(ok, row_sum(canon.c_user * x), bad)
    objective = torch.where(sol.status == NUMERICAL, float("nan"), objective)
    x = torch.where(ok[:, None], x, 0.0)
    return LPSolution(objective=objective, x=x, status=sol.status,
                      iterations=sol.iterations, basis=sol.basis)


def solve_box(problem: LPProblem) -> LPSolution:
    """Closed-form solve for ``boxlike`` problems (paper Sec. 6, signed).

    Empty boxes (lo > hi anywhere) are reported INFEASIBLE.
    """
    p = problem
    if not p.boxlike:
        raise ValueError("solve_box requires a boxlike problem (no rows, finite box)")
    d = (1.0 if p.maximize else -1.0) * p.c
    pick = torch.where(d < 0, p.lo, p.hi)
    infeasible = (p.lo > p.hi).any(dim=-1)
    bad = -_INF if p.maximize else _INF
    objective = torch.where(infeasible, bad, (p.c * pick).sum(dim=-1))
    x = torch.where(infeasible[:, None], 0.0, pick)
    status = torch.where(infeasible, INFEASIBLE, OPTIMAL).to(torch.int32)
    return LPSolution(objective=objective, x=x, status=status,
                      iterations=torch.zeros((p.batch,), dtype=torch.int32, device=p.device))
