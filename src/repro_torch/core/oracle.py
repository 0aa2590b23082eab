"""Dense NumPy two-phase simplex — the sequential-CPU baseline.

A copy of ``repro/core/oracle.py`` (numpy only), kept in the port so
that ``repro_torch`` imports nothing of the JAX package.

This plays the role GLPK plays in the paper: a trustworthy, sequential,
one-LP-at-a-time CPU solver.  It shares the tableau conventions of
``core.lp`` but runs in float64 NumPy, so it doubles as the test oracle
for the batched torch/CUDA solvers (scipy.optimize.linprog is used as a
second, fully independent oracle in the test-suite).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .lp import INFEASIBLE, ITER_LIMIT, OPTIMAL, UNBOUNDED, auto_cap

_TOL = 1e-9
_BIG = 1e30


def _pivot(tab: np.ndarray, basis: np.ndarray, l: int, e: int) -> None:
    pr = tab[l, :] / tab[l, e]
    col = tab[:, e].copy()
    tab -= np.outer(col, pr)
    tab[l, :] = pr
    basis[l] = e


def _run_simplex(
    tab: np.ndarray,
    basis: np.ndarray,
    elig: np.ndarray,
    max_iters: int,
    art_start: int,
):
    """Iterate LPC-rule simplex until optimal/unbounded/limit. Returns status."""
    m = tab.shape[0] - 1
    for it in range(max_iters):
        obj = tab[m, :]
        cand = np.where(elig, obj, -np.inf)
        e = int(np.argmax(cand))
        if cand[e] <= _TOL:
            return OPTIMAL, it
        col = tab[:m, e]
        ratios = np.where(col > _TOL, tab[:m, 0] / np.maximum(col, _TOL), _BIG)
        # A basic artificial sits at 0 after phase I (degenerate rows); a
        # pivot with a negative coefficient there would make it GROW, i.e.
        # silently leave the feasible region.  Force such rows to leave at
        # ratio 0 (a degenerate pivot on the negative element is valid:
        # rhs is 0, so feasibility is preserved and the artificial exits).
        # Same escape as core/engine.py:ratio_test, implemented separately
        # on purpose — the oracle stays an independent cross-check.
        stuck_artificial = (basis >= art_start) & (tab[:m, 0] <= _TOL) & (col < -_TOL)
        ratios = np.where(stuck_artificial, 0.0, ratios)
        l = int(np.argmin(ratios))
        if ratios[l] >= _BIG / 2:
            return UNBOUNDED, it
        _pivot(tab, basis, l, e)
    return ITER_LIMIT, max_iters


def solve_lp(
    a: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    max_iters: int = 0,
) -> Tuple[float, np.ndarray, int, int]:
    """Solve one LP: max c.x s.t. Ax <= b, x >= 0.

    Returns (objective, x, status, iterations).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    m, n = a.shape
    if max_iters <= 0:
        max_iters = auto_cap(m, n)
    q = 1 + n + 2 * m

    neg = b < 0
    sgn = np.where(neg, -1.0, 1.0)
    tab = np.zeros((m + 1, q))
    tab[:m, 0] = b * sgn
    tab[:m, 1 : 1 + n] = a * sgn[:, None]
    rows = np.arange(m)
    tab[rows, 1 + n + rows] = sgn
    tab[rows[neg], 1 + n + m + rows[neg]] = 1.0

    basis = np.where(neg, 1 + n + m + rows, 1 + n + rows).astype(np.int64)
    elig = np.zeros(q, bool)
    elig[1 : 1 + n + m] = True  # b column and artificials never enter

    art_start = 1 + n + m
    total_it = 0
    if neg.any():
        tab[m, :] = tab[:m, :][neg].sum(axis=0)  # phase-I priced objective
        status, it = _run_simplex(tab, basis, elig, max_iters, art_start)
        total_it += it
        if status != OPTIMAL:
            return -np.inf, np.zeros(n), status, total_it
        if tab[m, 0] > 1e-7 * max(1.0, np.abs(b).max()):
            return -np.inf, np.zeros(n), INFEASIBLE, total_it
        # Rewrite objective row for phase II.
        c_ext = np.zeros(q)
        c_ext[1 : 1 + n] = c
        cb = c_ext[basis]
        tab[m, :] = c_ext - cb @ tab[:m, :]
        tab[m, 0] = -(cb @ tab[:m, 0])
    else:
        tab[m, 1 : 1 + n] = c

    status, it = _run_simplex(tab, basis, elig, max_iters, art_start)
    total_it += it
    x = np.zeros(n)
    if status == OPTIMAL:
        on_vars = (basis >= 1) & (basis <= n)
        x[basis[on_vars] - 1] = tab[:m, 0][on_vars]
        return float(-tab[m, 0]), x, OPTIMAL, total_it
    return -np.inf, x, status, total_it


def solve_batch(a: np.ndarray, b: np.ndarray, c: np.ndarray, max_iters: int = 0):
    """Sequential loop over the batch — the paper's 'GLPK' measurement mode."""
    a = np.asarray(a)
    bsz = a.shape[0]
    n = a.shape[2]
    obj = np.empty(bsz)
    xs = np.empty((bsz, n))
    status = np.empty(bsz, np.int32)
    iters = np.empty(bsz, np.int32)
    for i in range(bsz):
        obj[i], xs[i], status[i], iters[i] = solve_lp(a[i], b[i], c[i], max_iters)
    return obj, xs, status, iters


def solve_hyperbox(lo: np.ndarray, hi: np.ndarray, directions: np.ndarray):
    """Oracle for the closed-form hyperbox LP (paper Sec. 6)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = np.asarray(directions, np.float64)
    pick = np.where(d < 0, lo, hi)
    support = np.sum(d * pick, axis=-1)
    return support, pick
