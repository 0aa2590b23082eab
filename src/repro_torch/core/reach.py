"""Support-function reachability for linear systems (paper Sec. 7).

Follows ``repro/core/reach.py``.  System: ``xdot = A x + u``, ``u`` in U
(point or box), ``x(0)`` in X0.  Discretization with step delta gives
``Phi = expm(A delta)`` and the recurrence ``Omega_{k+1} = Phi Omega_k (+) V``,
whose support function telescopes to

    rho_k(l) = rho_{X0}((Phi^T)^k l) + sum_{i<k} rho_V((Phi^T)^i l)

K template directions x N time steps = K*N support LPs.  The direction
matrix ``D[k] = (Phi^T)^k L`` is computed on the host (``scipy``'s
``expm`` and N small products); the supports are evaluated in batched
solver calls on ``device`` (None = the card).

The 5-dim and 28-dim (helicopter: 8 motion + 20 controller states)
models are the reference's seeded synthetic stand-ins, with the same
numpy seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.linalg

from .backends import SolveOptions, SolveStats
from .support import Box, box_to_polytope, template_directions


@dataclasses.dataclass(frozen=True)
class AffineSystem:
    a: np.ndarray  # (d, d) dynamics
    x0: Box  # initial set
    u: Box  # input set (point set when lo == hi)

    @property
    def dim(self) -> int:
        return self.a.shape[0]


def _direction_tableau(phi: np.ndarray, directions: np.ndarray, steps: int) -> np.ndarray:
    """D: (steps, K, d) with D[k] = directions @ Phi^k (rows r <- r @ Phi)."""
    k, d = directions.shape
    out = np.empty((steps, k, d), directions.dtype)
    cur = directions.copy()
    for s in range(steps):
        out[s] = cur
        cur = cur @ phi
    return out


def direction_stack(sys: AffineSystem, delta: float, steps: int,
                    directions: Optional[np.ndarray] = None) -> np.ndarray:
    """The (steps, K, d) float64 directions ``reach_supports`` samples:
    ``directions`` (default the ``box`` template) moved by ``expm(A delta)``."""
    if directions is None:
        directions = template_directions(sys.dim, "box")
    phi = scipy.linalg.expm(sys.a * delta)
    return _direction_tableau(phi, np.asarray(directions, np.float64), steps)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def reach_supports(
    sys: AffineSystem,
    delta: float,
    steps: int,
    directions: Optional[np.ndarray] = None,
    options: Optional[SolveOptions] = None,
    use_hyperbox: bool = True,
    warm_start: bool = False,
    stats: Optional[SolveStats] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Support samples of the reach sequence: ``(supports (steps, K), directions (K, d))``.

    ``use_hyperbox`` evaluates rho_{X0} with the closed-form box path
    (paper Sec. 6); with False X0 becomes a polytope and every sample a
    simplex LP.  ``warm_start`` then solves the X0 supports as a per-step
    sweep that carries the optimal basis (``Polytope.support_sweep``;
    on a shared backend the revised kernel's sweep) instead of one cold
    batch.  ``stats`` accumulates LP and pivot counters across all
    solves, the closed-form box LPs included.
    """
    dirs = direction_stack(sys, delta, steps, directions)  # (steps, K, d)
    directions = dirs[0]
    k = directions.shape[0]
    flat = dirs.reshape(steps * k, sys.dim)

    if use_hyperbox:
        x0_sup = _numpy(sys.x0.support(flat.astype(np.float32), options, stats=stats,
                                       device=device)).reshape(steps, k)
    elif warm_start:
        poly = box_to_polytope(sys.x0)
        x0_sup = _numpy(poly.support_sweep(dirs.astype(np.float32), options, warm_start=True,
                                           stats=stats, device=device))
    else:
        poly = box_to_polytope(sys.x0)
        x0_sup = _numpy(poly.support_solutions(flat.astype(np.float32), options, stats=stats,
                                               device=device).objective).reshape(steps, k)

    # Input contribution: V = delta*U, rho_V on the same directions, then a
    # prefix sum over time (sum_{i<k} rho_V((Phi^T)^i l)).
    v = Box(np.asarray(sys.u.lo) * delta, np.asarray(sys.u.hi) * delta)
    v_sup = _numpy(v.support(flat.astype(np.float32), options, stats=stats,
                             device=device)).reshape(steps, k)
    v_cum = np.concatenate([np.zeros((1, k)), np.cumsum(v_sup, axis=0)[:-1]], axis=0)
    return x0_sup + v_cum, directions


def count_lps(steps: int, directions: int, point_input: bool) -> int:
    """Paper-style 'No. of LPs' accounting for one reach run."""
    per = 1 if point_input else 2
    return steps * directions * per


# ---------------------------------------------------------------------------
# Models (synthetic stand-ins; dimensions match the paper's experiments).
# ---------------------------------------------------------------------------


def five_dim_model() -> AffineSystem:
    """5-dim linear system (Girard'05-style): stable rotating dynamics.

    X0: box centered at (1,0,0,0,0), side 0.02; U: point 0.01*ones (paper
    Sec. 7.2).
    """
    a = np.array(
        [
            [-0.5, -1.0, 0.0, 0.0, 0.0],
            [1.0, -0.5, 0.0, 0.0, 0.0],
            [0.0, 0.0, -0.6, 1.0, 0.0],
            [0.0, 0.0, -1.0, -0.6, 0.0],
            [0.0, 0.0, 0.0, 0.0, -0.8],
        ]
    )
    center = np.array([1.0, 0.0, 0.0, 0.0, 0.0])
    half = 0.01
    x0 = Box(center - half, center + half)
    u = Box(np.full(5, 0.01), np.full(5, 0.01))
    return AffineSystem(a, x0, u)


def helicopter_model() -> AffineSystem:
    """28-dim helicopter-controller stand-in: 8 motion + 20 controller states.

    Seeded stable random dynamics with motion<->controller coupling; X0 a
    hyperbox, U a point set (paper Sec. 7.1).
    """
    rng = np.random.default_rng(28)
    d = 28
    raw = rng.normal(size=(d, d)) * 0.4
    # Make it stable: shift the spectrum left.
    a = raw - (np.abs(np.linalg.eigvals(raw).real).max() + 0.5) * np.eye(d)
    center = np.zeros(d)
    center[:8] = 0.1
    half = np.full(d, 0.05)
    x0 = Box(center - half, center + half)
    u = Box(np.zeros(d), np.zeros(d))
    return AffineSystem(a, x0, u)
