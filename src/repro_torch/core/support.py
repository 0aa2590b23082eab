"""Support-function sampling of convex sets (paper Sec. 7).

Follows ``repro/core/support.py``.  A support function of a convex set
takes a direction l and returns max_{x in set} l.x; sampling it in K
template directions turns a support-function representation into a
polytope, one small LP per direction.  Reachability tools solve
millions of these.

Polytope variables are free (``lo = -inf``); ``core/problem.py``
splits them as ``x = x+ - x-``.  Boxes bypass the simplex (paper Sec. 6)
through the hyperbox path.  A support sweep over one polytope can run on
the shared-A revised engine: the canonical ``[A | -A]`` system is built
once (:meth:`Polytope.to_shared_batch`) and every step launches the
revised kernel on the basis state carried from the step before.

Entry points take ``device=None``, which means the card (and raises
without one); pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import dispatch as _dispatch
from . import hyperbox as _hyperbox
from . import revised as _revised
from . import session as _session
from .backends import SHARED_BACKENDS, SolveOptions, SolveStats
from .lp import OPTIMAL, LPBatch, LPSolution, SharedLPBatch, _tensor, resolve_device
from .problem import LPProblem, canonicalize, uncanonicalize


def _dtype_of(directions):
    if isinstance(directions, torch.Tensor):
        return directions.dtype
    return np.asarray(directions).dtype


@dataclasses.dataclass(frozen=True)
class Box:
    lo: np.ndarray  # (n,)
    hi: np.ndarray  # (n,)

    @property
    def dim(self) -> int:
        return int(np.asarray(self.lo).shape[-1])

    def support(self, directions, options: Optional[SolveOptions] = None,
                stats: Optional[SolveStats] = None, device=None) -> torch.Tensor:
        """rho_B(l) for each row of directions: (K, n) -> (K,).

        Every backend but ``"torch"`` goes through the dispatch's box path,
        so the default reaches the hyperbox kernel; ``stats`` records the
        box LPs (paper-style LP counts include the closed-form solves).
        """
        opts = options or SolveOptions()
        if stats is not None or opts.backend != "torch":
            return _dispatch.solve_hyperbox(self.lo, self.hi, directions, opts, stats=stats,
                                            device=device).objective
        d = _tensor(directions, device=resolve_device(device))
        lo = _tensor(self.lo, dtype=d.dtype, device=d.device)
        hi = _tensor(self.hi, dtype=d.dtype, device=d.device)
        return _hyperbox.support(lo, hi, d)


@dataclasses.dataclass(frozen=True)
class Polytope:
    """{x : Ax <= b} with x free (not sign-restricted)."""

    a: np.ndarray  # (m, n)
    b: np.ndarray  # (m,)

    @property
    def dim(self) -> int:
        return int(np.asarray(self.a).shape[-1])

    def to_problem(self, directions, basis0=None, device=None) -> LPProblem:
        """One general-form LP per direction: max l.x, Ax <= b, x free.

        ``basis0`` is a canonical-space warm-start basis (e.g. the
        previous direction batch's ``LPSolution.basis`` over this same
        polytope: only the objective changes, so it stays primal feasible).
        """
        return LPProblem.make(c=directions, a=self.a, bu=self.b, lo=-np.inf, hi=np.inf,
                              dtype=_dtype_of(directions), basis0=basis0, device=device)

    def to_lp_batch(self, directions, device=None) -> LPBatch:
        """Canonical batch for the directions (``to_problem``, canonicalized)."""
        return canonicalize(self.to_problem(directions, device=device)).batch

    def to_shared_batch(self, directions, basis0=None, device=None) -> SharedLPBatch:
        """Canonical SHARED batch: one stored ``A`` for every direction.

        The support LP's canonical form is ``max [l, -l].x'`` s.t.
        ``[A | -A] x' <= b, x' >= 0``: the constraint system does not
        depend on the direction, so the batch shares one (m, 2n) matrix.
        Densifying the result reproduces :meth:`to_lp_batch`'s arrays.
        """
        dev = resolve_device(device)
        dirs = _tensor(directions, device=dev)
        a = _tensor(self.a, dtype=dirs.dtype, device=dev)
        b = _tensor(self.b, dtype=dirs.dtype, device=dev)
        k = dirs.shape[0]
        return SharedLPBatch(
            torch.cat([a, -a], dim=1).contiguous(),
            b.expand(k, b.shape[0]).contiguous(),
            torch.cat([dirs, -dirs], dim=1).contiguous(),
            basis0=None if basis0 is None else _tensor(basis0, torch.int32, dev),
        )

    def support_solutions(self, directions, options: Optional[SolveOptions] = None,
                          basis0=None, stats: Optional[SolveStats] = None,
                          device=None) -> LPSolution:
        """Full solutions for the directions; ``basis`` is the next batch's warm start."""
        canon = canonicalize(self.to_problem(directions, basis0=basis0, device=device))
        sol = _dispatch.solve_canonical(canon.batch, options, stats=stats)
        return uncanonicalize(canon, sol)

    def support(self, directions, options: Optional[SolveOptions] = None,
                device=None) -> torch.Tensor:
        """rho_P(l) for each row of directions: (K, n) -> (K,)."""
        return self.support_solutions(directions, options, device=device).objective

    def support_sweep(self, direction_stack, options: Optional[SolveOptions] = None,
                      warm_start: bool = True, stats: Optional[SolveStats] = None,
                      shared: Optional[bool] = None, device=None) -> torch.Tensor:
        """Support values over a sequence of direction batches, warm-started.

        ``direction_stack`` is (S, K, n), swept in order.  Step s's
        directions are step s-1's moved by the dynamics, and only the
        objective changes, so the optimal basis of step s-1 is primal
        feasible for step s: with ``warm_start`` each step starts from it
        and skips phase I.  ``shared`` (default: whether ``options`` names
        a shared backend) runs the sweep on the revised engine over one
        stored ``[A | -A]``.  Otherwise each step is a dense solve that
        carries ``LPSolution.basis``: through ``core/session.py:
        sweep_problems`` where it applies (a warm sweep on ``cuda``,
        ``torch`` or ``auto``, one round a step: a device loop read back
        once, at the end), else the loop :meth:`step_sweep`.  ``stats``
        accumulates the per-step counters, ``warm_started`` among them.
        Returns the (S, K) support values; a warm search may stop at
        another vertex of a non-unique optimum, never at another optimum
        value.
        """
        opts = options or SolveOptions()
        if shared is None:
            shared = opts.backend in SHARED_BACKENDS
        if shared:
            return self._shared_sweep(direction_stack, opts, warm_start, stats, device)
        if warm_start and _session.sweep_supported(opts):
            template = self.to_problem(direction_stack[0], device=device)
            return _session.sweep_problems(template, direction_stack, opts, stats=stats)
        return self.step_sweep(direction_stack, options, warm_start, stats, device)

    def step_sweep(self, direction_stack, options: Optional[SolveOptions] = None,
                   warm_start: bool = True, stats: Optional[SolveStats] = None,
                   device=None) -> torch.Tensor:
        """The dense sweep as a loop of solves, one solve a step.

        :meth:`support_sweep` takes it where ``core/session.py:
        sweep_problems`` does not apply (a cold sweep, chunking,
        compaction, another backend).  With ``warm_start`` each step
        passes the last step's bases of the LPs that ended OPTIMAL as
        ``basis0``.  Every step reads its results back.
        """
        outs = []
        basis = None
        for dirs in direction_stack:
            if stats is not None and basis is not None:
                stats.warm_started += int((basis > 0).any(dim=-1).sum())
            sol = self.support_solutions(dirs, options, basis0=basis, stats=stats,
                                         device=device)
            if warm_start and sol.basis is not None:
                # Reuse only bases of LPs that converged; a 0 entry is out of
                # range, so the tableau build cold-starts that LP.
                basis = torch.where((sol.status == OPTIMAL)[:, None], sol.basis, 0)
            outs.append(sol.objective)
        return torch.stack(outs)

    def shared_sweep_inputs(self, direction_stack, device=None):
        """What the shared sweep solves: ``(sb, c_stack)``.

        ``sb`` is :meth:`to_shared_batch` of the first step's directions
        (its ``c`` is step 0's costs) and ``c_stack`` the (S, K, 2n)
        canonical costs ``[l, -l]`` of every step, contiguous.
        """
        sb = self.to_shared_batch(direction_stack[0], device=device)
        dirs = _tensor(direction_stack, dtype=sb.a.dtype, device=sb.a.device)  # (S, K, n)
        return sb, torch.cat([dirs, -dirs], dim=2).contiguous()

    def _shared_sweep(self, direction_stack, opts: SolveOptions, warm_start: bool,
                      stats: Optional[SolveStats], device) -> torch.Tensor:
        """The sweep on the revised engine: the kernel on ``cuda-shared``.

        Support values come back in user coordinates through the same
        ``x = x+ - x-`` and re-evaluated ``l.x`` as ``uncanonicalize``.
        """
        sb, c_stack = self.shared_sweep_inputs(direction_stack, device=device)
        backend = _dispatch.resolve_backend(opts, shared=True, shape=(sb.m, sb.n),
                                            dtype=sb.a.dtype, batch=sb.batch, stats=stats,
                                            device=sb.a.device).backend
        if backend not in SHARED_BACKENDS:
            raise ValueError(f"a shared sweep runs on {SHARED_BACKENDS}, not {backend!r}")
        n = self.dim
        dirs = c_stack[..., :n]  # (S, K, n)
        kw = dict(rule=opts.rule, max_iters=opts.max_iters, seed=opts.seed,
                  tol=opts.tolerance, warm=warm_start)
        if backend == "cuda-shared":
            from ..kernels import ops as kernel_ops

            obj, x, status, iters = kernel_ops.revised_sweep(sb.a, sb.b, c_stack, **kw)
        else:
            obj, x, status, iters = _revised.sweep_batched(sb.a, sb.b, c_stack, **kw)
        ok = status == OPTIMAL
        xu = x[..., :n] - x[..., n : 2 * n]
        support = torch.where(ok, (dirs * xu).sum(dim=-1), -float("inf"))
        if stats is not None:
            for s in range(dirs.shape[0]):
                stats.record(LPSolution(objective=obj[s], x=x[s], status=status[s],
                                        iterations=iters[s]))
                if warm_start and s > 0:
                    stats.warm_started += int(ok[s - 1].sum())
            stats.record_tableau(sb.batch * _revised.state_bytes_per_lp(sb.m, sb.n, sb.a.dtype))
        return support


def box_to_polytope(box: Box) -> Polytope:
    n = box.dim
    eye = np.eye(n)
    a = np.concatenate([eye, -eye], axis=0)
    b = np.concatenate([np.asarray(box.hi), -np.asarray(box.lo)])
    return Polytope(a, b)


def template_directions(dim: int, kind: str = "box") -> np.ndarray:
    """Template direction sets used by reachability tools.

    kind: "box" (2d axis directions), "oct" (octagonal: axes + pairwise
    +-ei +-ej combinations), or "uniform:<K>" (K pseudo-random unit dirs).
    """
    eye = np.eye(dim)
    if kind == "box":
        return np.concatenate([eye, -eye], axis=0)
    if kind == "oct":
        dirs = [eye, -eye]
        for i in range(dim):
            for j in range(i + 1, dim):
                for si in (1.0, -1.0):
                    for sj in (1.0, -1.0):
                        v = np.zeros(dim)
                        v[i], v[j] = si, sj
                        dirs.append(v[None])
        return np.concatenate(dirs, axis=0)
    if kind.startswith("uniform:"):
        k = int(kind.split(":", 1)[1])
        rng = np.random.default_rng(7)
        d = rng.normal(size=(k, dim))
        return d / np.linalg.norm(d, axis=1, keepdims=True)
    raise ValueError(f"unknown template kind {kind!r}")
