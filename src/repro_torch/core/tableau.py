"""Layout-polymorphic simplex tableau storage.

Follows ``repro/core/tableau.py``.  A :class:`TableauSpec` names the
column layout once; ``build_tableau`` and every consumer derive their
column arithmetic from it.

``"dense"``
    The paper's map: ``q = 1 + n + 2m`` columns (RHS, originals, slacks,
    an artificial identity block).

``"compact"`` (the default)
    Drops the write-only artificial block: ``q = 1 + n + m``.  No pricing,
    ratio or feasibility decision reads an artificial column, so both
    layouts give bit-identical solves.

Basis encoding is the same in both: ``1..n`` originals, ``n+1..n+m``
slacks, ``1+n+m+i`` row ``i``'s artificial (a pure ID in ``compact``).

Tensors are built fresh and written in place; the reference's
``.at[].set`` chains become slice assignments on a zero tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

#: Valid tableau layouts (see module docstring).
LAYOUTS = ("dense", "compact")

#: The library-wide default layout.
DEFAULT_LAYOUT = "compact"


@dataclasses.dataclass(frozen=True)
class TableauSpec:
    """Static column-layout descriptor for one (m, n) tableau shape class."""

    m: int
    n: int
    layout: str = DEFAULT_LAYOUT

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown tableau layout {self.layout!r}; expected one of {LAYOUTS}"
            )

    @property
    def q(self) -> int:
        """Total tableau columns under this layout."""
        base = 1 + self.n + self.m
        return base + self.m if self.layout == "dense" else base

    @property
    def slack_start(self) -> int:
        return 1 + self.n

    @property
    def art_start(self) -> int:
        """Basis-ID base of the artificials (also their first column in dense)."""
        return 1 + self.n + self.m

    @property
    def num_eligible(self) -> int:
        return self.n + self.m

    def bytes_per_lp(self, dtype=torch.float32) -> int:
        """Tableau bytes one LP occupies under this layout."""
        return (self.m + 1) * self.q * torch.empty((), dtype=dtype).element_size()

    @classmethod
    def from_tableau(cls, m: int, n: int, q: int) -> "TableauSpec":
        """Recover the layout of an existing ``(B, m+1, q)`` tableau."""
        for layout in LAYOUTS:
            spec = cls(m, n, layout)
            if spec.q == q:
                return spec
        raise ValueError(
            f"tableau with q={q} matches no layout for m={m}, n={n} "
            f"(dense q={1 + n + 2 * m}, compact q={1 + n + m})"
        )


def build_tableau(
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    basis0: Optional[torch.Tensor] = None,
    spec: Optional[TableauSpec] = None,
    phase1_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched two-phase tableau, basis and phase for ``(a, b, c)``.

    Returns ``tab`` (B, m+1, spec.q), ``basis`` (B, m) int32 and
    ``phase`` (B,) int32: 1 where some ``b_i < 0`` needs phase I, else 2.
    Rows of a usable warm basis ``basis0`` start from ``B^-1 [b | A | I]``
    in phase II; the others fall back to the cold start.
    ``phase1_rows`` are the indices of the LPs with some ``b_i < 0`` where
    the caller knows them already (a sweep, whose ``b`` never changes):
    finding them here reads the device back.
    """
    bsz, m, n = a.shape
    if spec is None:
        spec = TableauSpec(m, n)
    q = spec.q
    dtype, dev = a.dtype, a.device

    neg = b < 0  # (B, m) rows needing an artificial
    sgn = torch.ones_like(b)
    sgn[neg] = -1.0

    tab = torch.zeros((bsz, m + 1, q), dtype=dtype, device=dev)
    tab[:, :m, 0] = b * sgn
    tab[:, :m, 1 : 1 + n] = a * sgn[:, :, None]
    rows = torch.arange(m, device=dev)
    tab[:, rows, 1 + n + rows] = sgn
    if spec.layout == "dense":
        tab[:, rows, spec.art_start + rows] = neg.to(dtype)

    need_phase1 = neg.any(dim=1)  # (B,)
    # Phase-II objective row: reduced costs = c (slack basis has cost 0).
    tab[:, m, 1 : 1 + n] = c
    # Phase-I objective row (maximize -sum of artificials), priced out
    # over the artificial rows in ascending row order; built only for the
    # LPs that need it.
    p1 = need_phase1.nonzero().flatten() if phase1_rows is None else phase1_rows
    if p1.numel():
        negf = neg[p1].to(dtype)
        obj1 = torch.zeros((p1.numel(), q), dtype=dtype, device=dev)
        for i in range(m):
            obj1 = obj1 + tab[p1, i, :] * negf[:, i : i + 1]
        tab[p1, m, :] = obj1

    basis = torch.where(neg, spec.art_start + rows[None, :], 1 + n + rows[None, :])
    basis = basis.to(torch.int32)
    phase = torch.where(need_phase1, 1, 2).to(torch.int32)
    if basis0 is None:
        return tab, basis, phase
    warm_tab, warm_basis, ok = _warm_tableau(a, b, c, basis0, spec)
    tab = torch.where(ok[:, None, None], warm_tab, tab)
    basis = torch.where(ok[:, None], warm_basis, basis)
    phase = torch.where(ok, torch.full_like(phase, 2), phase)
    return tab, basis, phase


def _warm_tableau(a, b, c, basis0, spec: TableauSpec):
    """Tableau for a caller-supplied basis: rows = B^-1 [b | A | I].

    Returns ``(tab, basis, ok)``: ``ok`` (B,) marks LPs whose warm basis
    is usable (indices in range, basis matrix nonsingular, ``B^-1 b``
    primal feasible).  ``torch.linalg.solve`` raises on a singular batch
    element, so the solve is ``solve_ex`` and a row counts as singular
    when ``info != 0`` or its output is not finite.
    """
    bsz, m, n = a.shape
    q = spec.q
    dtype, dev = a.dtype, a.device
    basis0 = basis0.to(device=dev, dtype=torch.int64)

    in_range = (basis0 >= 1) & (basis0 <= n + m)  # (B, m)
    safe = torch.where(in_range, basis0, torch.ones_like(basis0))

    eye = torch.eye(m, dtype=dtype, device=dev).expand(bsz, m, m)
    ai = torch.cat([a, eye], dim=2)  # (B, m, n+m) var + slack columns
    bmat = torch.gather(ai, 2, (safe - 1)[:, None, :].expand(bsz, m, m))
    rhs_full = torch.cat([b[:, :, None], ai], dim=2)  # (B, m, 1+n+m)
    body, info = torch.linalg.solve_ex(bmat, rhs_full)

    scale = torch.clamp(b.abs().amax(dim=-1), min=1.0)
    feas_tol = torch.tensor(1e-9 if dtype == torch.float64 else 1e-6, dtype=dtype) * scale
    finite = torch.isfinite(body).all(dim=2).all(dim=1) & (info == 0)
    feasible = (body[:, :, 0] >= -feas_tol[:, None]).all(dim=1)
    ok = in_range.all(dim=1) & finite & feasible
    body = torch.where(torch.isfinite(body), body, torch.zeros_like(body))
    # Restore the rhs >= 0 invariant the ratio test relies on.
    body[:, :, 0] = torch.clamp(body[:, :, 0], min=0.0)

    c_full = torch.zeros((bsz, 1 + n + m), dtype=dtype, device=dev)
    c_full[:, 1 : 1 + n] = c
    cb = torch.gather(c_full, 1, safe)  # (B, m) basic costs
    obj = c_full - torch.einsum("bm,bmk->bk", cb, body)  # col 0 holds -z0

    tab = torch.zeros((bsz, m + 1, q), dtype=dtype, device=dev)
    tab[:, :m, : 1 + n + m] = body
    tab[:, m, : 1 + n + m] = obj
    return tab, safe.to(torch.int32), ok
