"""Backend registry: named solver implementations behind one protocol.

Follows ``repro/core/backends.py``.  Every backend solves the canonical
form only (``max c.x, Ax <= b, x >= 0``); a backend is a pair of
callables

    solve_canonical(LPBatch, SolveOptions)      -> LPSolution
    solve_hyperbox(lo, hi, dirs, SolveOptions)  -> LPSolution

(the shared backends' ``solve_canonical`` takes a ``SharedLPBatch``).

(The reference's exact-state hooks, start / resume / init, arrive with
the round-scheduler slice; the state-carrying entry points exist below
this layer, in ``core/simplex.py`` and ``kernels/ops.py``.)

Built-ins:

  * ``cuda``      — the hand-written CUDA kernels (``kernels/ops.py``), the
                    counterpart of the reference's ``pallas``.  It is the
                    port's DEFAULT (the reference defaults to ``xla``) so
                    that the main path goes through the kernels.  On CPU
                    tensors it runs the kernels' plain versions, as
                    ``pallas`` runs in interpret mode off the TPU.
  * ``torch``     — the plain lockstep simplex (``core/simplex.py``), the
                    counterpart of ``xla``.
  * ``reference`` — the sequential float64 NumPy oracle (``core/oracle.py``).
  * ``cuda-shared`` / ``torch-shared`` (:data:`SHARED_BACKENDS`) — the
                    counterparts of ``pallas-shared`` / ``xla-shared``:
                    a ``SharedLPBatch`` (one ``A``) through the revised
                    kernel (``kernels/csrc/revised.cu``) or its plain
                    lockstep loop (``core/revised.py``).  Their box path
                    is that of ``cuda`` / ``torch``.

No backend falls back to another: a shape a CUDA kernel is given runs
on the kernel (the tableau and the basis inverse live in global memory,
so every shape fits), and a failed build or launch raises.  The
reference's ``pallas-shared`` -> ``xla-shared`` VMEM fallback has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import engine as _engine
from . import hyperbox as _hyperbox
from . import revised as _revised
from . import simplex as _simplex
from .lp import OPTIMAL, LPBatch, LPSolution, SharedLPBatch
from .tableau import DEFAULT_LAYOUT, LAYOUTS

#: The port's default backend: the CUDA kernels.
DEFAULT_BACKEND = "cuda"

#: Backends that consume :class:`~repro_torch.core.lp.SharedLPBatch`: one
#: ``(m, n)`` matrix read by every LP, O(m^2) revised-simplex state per LP.
#: On a shared batch ``cuda``/``torch`` promote to these; a plain
#: ``LPBatch`` on one of them is an error.
SHARED_BACKENDS = ("torch-shared", "cuda-shared")


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Solver configuration — one frozen record instead of loose knobs.

    Only the fields this port honours so far are here; the reference's
    other knobs arrive with the slices that port them.

    Parameters
    ----------
    backend : str, default "cuda"
        Registered backend name: ``"cuda"`` (the kernels; the default),
        ``"torch"`` (plain lockstep loop), ``"cuda-shared"`` /
        ``"torch-shared"`` (the revised engine on a ``SharedLPBatch``;
        ``cuda``/``torch`` promote to them there) or ``"reference"``
        (float64 oracle), or a name added via :func:`register_backend`.
    rule : str, default "lpc"
        Pivot rule ``"lpc"``, ``"rpc"`` or ``"bland"``; the oracle is
        LPC-only and ignores it.
    max_iters : int, default 0
        Iteration cap across both phases; 0 means ``50 (m + n)``.
    tolerance : float, default 0.0
        Reduced-cost/pivot tolerance; 0 means the dtype default.
    seed : int, default 0
        Seed of the RPC rule's noise.
    chunk_size : int, optional
        Split a dispatch into chunks of at most this many LPs (None = one
        chunk); bounds the tableau memory of one launch.
    layout : str, optional
        Tableau layout, ``"compact"`` (None means this) or ``"dense"``;
        results are bit-identical.
    """

    backend: str = DEFAULT_BACKEND
    rule: str = _engine.LPC
    max_iters: int = 0
    tolerance: float = 0.0
    seed: int = 0
    chunk_size: Optional[int] = None
    layout: Optional[str] = None

    def __post_init__(self):
        if self.rule not in _engine.RULES:
            raise ValueError(
                f"unknown pivot rule {self.rule!r}; expected one of {_engine.RULES}"
            )
        if self.layout is not None and self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown tableau layout {self.layout!r}; expected one of {LAYOUTS}"
            )
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size!r}")

    @property
    def effective_layout(self) -> str:
        return self.layout if self.layout is not None else DEFAULT_LAYOUT

    def replace(self, **kw) -> "SolveOptions":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SolveStats:
    """Host-side counters accumulated across a solve (opt-in: recording
    reads the iteration counts back, one sync per dispatch).

    Attributes
    ----------
    lps : int
        LP solves recorded.
    rounds : int
        Backend dispatches recorded (chunks).
    simplex_iterations : int
        Total simplex pivots across the recorded LPs.
    tableau_bytes : int
        Peak solver-state bytes of one dispatch (chunk size x bytes per
        LP: the tableau, or the revised engine's basis state).
    warm_started : int
        LPs that entered a solve with a carried basis (support sweeps).
    """

    lps: int = 0
    rounds: int = 0
    simplex_iterations: int = 0
    tableau_bytes: int = 0
    warm_started: int = 0

    def record_tableau(self, nbytes: int) -> None:
        self.tableau_bytes = max(self.tableau_bytes, int(nbytes))

    def record(self, sol: LPSolution) -> None:
        iters = sol.iterations
        if iters.numel() == 0:
            return
        self.lps += int(iters.numel())
        self.rounds += 1
        self.simplex_iterations += int(iters.sum())


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named solver implementation over the canonical problem protocol."""

    name: str
    solve_canonical: Callable[[LPBatch, SolveOptions], LPSolution]
    solve_hyperbox: Callable[..., LPSolution]


_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend, overwrite: bool = False) -> Backend:
    """Add a backend to the registry (raises on a duplicate name)."""
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {', '.join(available_backends())}"
        ) from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------


def _torch_solve(batch: LPBatch, options: SolveOptions) -> LPSolution:
    return _simplex.solve_batched(
        batch.a, batch.b, batch.c, rule=options.rule, max_iters=options.max_iters,
        seed=options.seed, tol=options.tolerance, basis0=batch.basis0,
        layout=options.effective_layout,
    )


def _torch_hyperbox(lo, hi, directions, options: SolveOptions) -> LPSolution:
    return _hyperbox.solve_batched(lo, hi, directions)


def _cuda_solve(batch: LPBatch, options: SolveOptions) -> LPSolution:
    from ..kernels import ops as kernel_ops

    return kernel_ops.simplex_solve(
        batch.a, batch.b, batch.c, rule=options.rule, max_iters=options.max_iters,
        seed=options.seed, tol=options.tolerance, basis0=batch.basis0,
        layout=options.effective_layout,
    )


def _cuda_hyperbox(lo, hi, directions, options: SolveOptions) -> LPSolution:
    from ..kernels import ops as kernel_ops

    obj = kernel_ops.hyperbox_support(lo, hi, directions)
    # The maximizing vertex is built outside the kernel, as the reference does.
    pick = torch.where(directions < 0, lo, hi)
    bsz = obj.shape[0]
    return LPSolution(
        objective=obj,
        x=pick,
        status=torch.full((bsz,), OPTIMAL, dtype=torch.int32, device=obj.device),
        iterations=torch.zeros((bsz,), dtype=torch.int32, device=obj.device),
    )


def _torch_shared_solve(batch: SharedLPBatch, options: SolveOptions) -> LPSolution:
    return _revised.solve_batched(
        batch.a, batch.b, batch.c, rule=options.rule, max_iters=options.max_iters,
        seed=options.seed, tol=options.tolerance, basis0=batch.basis0,
    )


def _cuda_shared_solve(batch: SharedLPBatch, options: SolveOptions) -> LPSolution:
    from ..kernels import ops as kernel_ops

    return kernel_ops.revised_solve(
        batch.a, batch.b, batch.c, rule=options.rule, max_iters=options.max_iters,
        seed=options.seed, tol=options.tolerance, basis0=batch.basis0,
    )


def _reference_solve(batch: LPBatch, options: SolveOptions) -> LPSolution:
    # The oracle has no warm-start path; basis0 is ignored (a hint).
    from . import oracle

    obj, xs, status, iters = oracle.solve_batch(
        batch.a.cpu().numpy(), batch.b.cpu().numpy(), batch.c.cpu().numpy(),
        max_iters=options.max_iters,
    )
    dtype, dev = batch.a.dtype, batch.a.device
    return LPSolution(
        objective=torch.as_tensor(obj, device=dev).to(dtype),
        x=torch.as_tensor(xs, device=dev).to(dtype),
        status=torch.as_tensor(status, dtype=torch.int32, device=dev),
        iterations=torch.as_tensor(iters, dtype=torch.int32, device=dev),
    )


def _reference_hyperbox(lo, hi, directions, options: SolveOptions) -> LPSolution:
    from . import oracle

    support, pick = oracle.solve_hyperbox(
        lo.cpu().numpy(), hi.cpu().numpy(), directions.cpu().numpy()
    )
    dtype, dev = directions.dtype, directions.device
    bsz = support.shape[0]
    return LPSolution(
        objective=torch.as_tensor(support, device=dev).to(dtype),
        x=torch.as_tensor(np.broadcast_to(pick, directions.shape).copy(), device=dev).to(dtype),
        status=torch.full((bsz,), OPTIMAL, dtype=torch.int32, device=dev),
        iterations=torch.zeros((bsz,), dtype=torch.int32, device=dev),
    )


register_backend(Backend("cuda", _cuda_solve, _cuda_hyperbox))
register_backend(Backend("torch", _torch_solve, _torch_hyperbox))
register_backend(Backend("reference", _reference_solve, _reference_hyperbox))
register_backend(Backend("cuda-shared", _cuda_shared_solve, _cuda_hyperbox))
register_backend(Backend("torch-shared", _torch_shared_solve, _torch_hyperbox))
