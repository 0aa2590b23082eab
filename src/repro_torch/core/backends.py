"""Backend registry: named solver implementations behind one protocol.

Follows ``repro/core/backends.py``.  Every backend solves the canonical
form only (``max c.x, Ax <= b, x >= 0``); a backend is a pair of
callables

    solve_canonical(LPBatch, SolveOptions)      -> LPSolution
    solve_hyperbox(lo, hi, dirs, SolveOptions)  -> LPSolution

(the shared backends' ``solve_canonical`` takes a ``SharedLPBatch``),
plus the reference's exact-state hooks, which the round scheduler
(``core/dispatch.py``) and the sessions (``core/session.py``) drive:

    start_canonical(batch, SolveOptions)         -> (LPSolution, state)
    resume_canonical(batch, state, SolveOptions) -> (LPSolution, state)
    init_canonical(batch, SolveOptions)          -> state

``cuda``, ``torch``, ``cuda-shared``, ``torch-shared`` and ``pdhg``
carry them (the kernels' resume entry points ``kernels/ops.py:
simplex_resume``/``revised_resume``/``pdhg_resume``, or the plain
loops); ``reference`` has none, and its compaction rounds run from
scratch.

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
  * ``pdhg``      — first-order restarted PDHG for the large shapes the
                    tableau cedes: the PDHG kernel (``kernels/csrc/pdhg.cu``)
                    on CUDA tensors, its plain loop (``core/pdhg.py``) on
                    CPU tensors.  Its box path is the hyperbox kernel's.
  * ``auto``      — not a registered backend: the dispatch layer resolves
                    it per batch through the cost-model autotuner
                    (``runtime/autotune.py``, ``SolveOptions.autotune``),
                    or with ``autotune="off"`` through :func:`route_shape`.

No backend falls back to another: a shape a CUDA kernel is given runs
on the kernel (the tableau and the basis inverse live in global memory,
so every shape fits), and a failed build or launch raises.  The
reference's ``pallas-shared`` -> ``xla-shared`` VMEM fallback has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import engine as _engine
from . import hyperbox as _hyperbox
from . import pdhg as _pdhg
from . import revised as _revised
from . import simplex as _simplex
from .lp import OPTIMAL, LPBatch, LPSolution, ResumeState, SharedLPBatch
from .tableau import DEFAULT_LAYOUT, LAYOUTS

#: Valid values of :attr:`SolveOptions.compaction`.
COMPACTION_MODES = ("off", "chunked", "every_k")

#: Valid values of :attr:`SolveOptions.resume`.
RESUME_MODES = ("scratch", "basis")

#: Valid values of :attr:`SolveOptions.autotune` (``runtime/autotune.py``).
AUTOTUNE_MODES = ("off", "predict", "trial")

#: The port's default backend: the CUDA kernels.
DEFAULT_BACKEND = "cuda"

#: Backends that consume :class:`~repro_torch.core.lp.SharedLPBatch`: one
#: ``(m, n)`` matrix read by every LP, O(m^2) revised-simplex state per LP.
#: On a shared batch ``cuda``/``torch`` promote to these; a plain
#: ``LPBatch`` on one of them is an error.
SHARED_BACKENDS = ("torch-shared", "cuda-shared")

#: Shape frontier for ``backend="auto"``: LPs with ``max(m, n)`` at or
#: above it route to the first-order ``pdhg`` backend, smaller ones to the
#: simplex kernel: the regime the paper's tableau method cedes
#: (m, n >= 500).  Override per solve with ``SolveOptions.route_frontier``.
DEFAULT_ROUTE_FRONTIER = 500


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Solver configuration — one frozen record instead of loose knobs.

    Only the fields this port honours are here.  A device mesh is an
    argument of the entry points (``solve(..., mesh=)``), as in the
    reference; ``unroll``/``dynamic_caps``/``tile_b`` have no meaning in
    the port (``ROADMAP.md``, "TPU mechanics not carried over").

    Parameters
    ----------
    backend : str, default "cuda"
        Registered backend name: ``"cuda"`` (the kernels; the default),
        ``"torch"`` (plain lockstep loop), ``"cuda-shared"`` /
        ``"torch-shared"`` (the revised engine on a ``SharedLPBatch``;
        ``cuda``/``torch`` promote to them there), ``"pdhg"`` (first-order
        PDHG) or ``"reference"`` (float64 oracle), or a name added via
        :func:`register_backend`; or ``"auto"``, which picks ``cuda``,
        ``cuda-shared`` or ``pdhg`` by shape (:func:`route_shape`,
        through the autotuner unless ``autotune="off"``).
    rule : str, default "lpc"
        Pivot rule ``"lpc"``, ``"rpc"`` or ``"bland"``; the oracle is
        LPC-only and ignores it, and ``pdhg`` rejects any other than
        ``"lpc"``.
    max_iters : int, default 0
        Iteration cap across both phases; 0 means ``50 (m + n)``.
    tolerance : float, default 0.0
        Reduced-cost/pivot tolerance; 0 means the dtype default.
    seed : int, default 0
        Seed of the RPC rule's noise.
    chunk_size : int, optional
        Split a dispatch into chunks of at most this many LPs (None = one
        chunk); bounds the tableau memory of one launch.
    first_cap : int, optional
        Legacy adaptive two-pass cap.  None disables the two-pass solve; 0
        enables it with the auto cap ``8 (m + n)``; a positive value is
        the explicit pass-1 cap.  Iteration counts continue across the
        two passes.  Ignored when ``compaction`` is on.
    compaction : str, default "off"
        Convergence compaction (:data:`COMPACTION_MODES`):

        * ``"off"``: one round; every LP of a launch runs until it stops.
        * ``"chunked"``: a round at a small cap, then the LPs still
          running, gathered into one dense sub-batch, at the full cap.
        * ``"every_k"``: rounds at a doubling cap (k, 2k, 4k, ...); after
          each, the finished LPs drop out and the survivors are gathered.

        Both return results identical to ``"off"`` under the
        deterministic rules (lpc, bland), on every backend.
    compact_every : int, default 0
        The first round's cap ``k``; 0 means ``8 (m + n)``.
    resume : str, default "scratch"
        How survivors continue (:data:`RESUME_MODES`): ``"scratch"``
        re-solves them from iteration 0 at the larger cap; ``"basis"``
        continues each from the exact state its round stopped at (the
        tableau, the revised record or the PDHG iterates), so the
        rounds' budgets sum to one full solve and the results, iteration
        counts included, are bit-identical to ``"off"`` under lpc and
        bland.  Backends without the state hooks (``reference``) run
        scratch rounds instead.
    layout : str, optional
        Tableau layout, ``"compact"`` (None means this) or ``"dense"``;
        results are bit-identical.  ``pdhg`` rejects ``"dense"``.
    pdhg_tol : float, default 0.0
        Relative KKT tolerance of ``pdhg`` (primal and dual residuals and
        the duality gap); 0 means 1e-4.
    pdhg_restart : int, default 0
        Fixed restart-to-average period of ``pdhg``; 0 means 64.
    crossover : bool, default False
        Polish ``pdhg``'s OPTIMAL rows into exact vertices: a basis guess
        read off each point warm-starts the simplex kernel
        (``core/pdhg.py:crossover``), which returns the vertex and a
        reusable ``basis``.  Requires ``backend`` ``"pdhg"`` or ``"auto"``.
    route_frontier : int, default 0
        The ``"auto"`` frontier: ``max(m, n)`` at or above it routes to
        ``pdhg``; 0 means :data:`DEFAULT_ROUTE_FRONTIER`.
    guardrails : bool, default True
        Per-round numerical health mask
        (``core/dispatch.py:apply_guardrails``): a row whose solution
        claims OPTIMAL with a non-finite objective or point, or whose
        carried state went non-finite, retires ``NUMERICAL``.  On a
        healthy batch the results are bit-identical with it on or off.
    quarantine : bool, default False
        Re-solve the ``NUMERICAL`` rows with finite inputs on the float64
        oracle under a ``max(400, 2 (m + n))`` pivot budget after the
        rounds; the oracle's verdict replaces the flag where it reaches
        one.
    retry_budget : int, default 2
        Re-dispatches of a failed round from its carried state before the
        error propagates (``core/dispatch.py:dispatch_round_safe``).  A
        retry stays on the same backend; errors in
        ``runtime/chaos.py:NON_TRANSIENT`` (bad arguments, a kernel that
        did not build, load or launch) are never retried.
    retry_backoff : float, default 0.05
        Base of the capped exponential sleep before retry k:
        ``min(retry_backoff * 2**k, RETRY_BACKOFF_CAP)`` seconds.
    speculation : bool, default False
        Run the chunks of a multi-chunk round on worker threads, each on
        its own CUDA stream, and re-dispatch a chunk that misses the
        straggler deadline (``runtime/straggler.py``); the first result
        wins.  Results are bit-identical to the serial chunk loop.
    autotune : str, default "predict"
        How ``backend="auto"`` and ``layout=None`` are filled
        (``runtime/autotune.py``):

        * ``"predict"``: rank the candidate configurations by the H100
          cost model and take the cheapest.  Pure: no disk, no build, no
          device work; reproduces the static routing table exactly.
        * ``"trial"``: also time the predicted top-k by micro-solves on
          the batch's device and persist the measured winner in the
          on-disk cache (``$REPRO_TORCH_AUTOTUNE_CACHE``), so a warm
          process resolves with zero micro-trials.
        * ``"off"``: the static routing table alone (:func:`route_shape`
          and :data:`~repro_torch.core.tableau.DEFAULT_LAYOUT`).

        Whatever the mode, explicit pins (a concrete ``backend``, a
        non-None ``layout``) win, the frontier stays a constraint, and
        the tuner only changes WHICH configuration runs, never the
        per-LP results of one.
    """

    backend: str = DEFAULT_BACKEND
    rule: str = _engine.LPC
    max_iters: int = 0
    tolerance: float = 0.0
    seed: int = 0
    chunk_size: Optional[int] = None
    layout: Optional[str] = None
    pdhg_tol: float = 0.0
    pdhg_restart: int = 0
    crossover: bool = False
    route_frontier: int = 0
    first_cap: Optional[int] = None
    compaction: str = "off"
    compact_every: int = 0
    resume: str = "scratch"
    guardrails: bool = True
    quarantine: bool = False
    retry_budget: int = 2
    retry_backoff: float = 0.05
    speculation: bool = False
    autotune: str = "predict"

    def __post_init__(self):
        if self.compaction not in COMPACTION_MODES:
            raise ValueError(
                f"unknown compaction mode {self.compaction!r}; "
                f"expected one of {COMPACTION_MODES}"
            )
        if self.resume not in RESUME_MODES:
            raise ValueError(
                f"unknown resume mode {self.resume!r}; expected one of {RESUME_MODES}"
            )
        if self.rule not in _engine.RULES:
            raise ValueError(
                f"unknown pivot rule {self.rule!r}; expected one of {_engine.RULES}"
            )
        if self.autotune not in AUTOTUNE_MODES:
            raise ValueError(
                f"unknown autotune mode {self.autotune!r}; expected one of {AUTOTUNE_MODES}"
            )
        if self.layout is not None and self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown tableau layout {self.layout!r}; expected one of {LAYOUTS}"
            )
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size!r}")
        if self.pdhg_tol < 0.0:
            raise ValueError(f"pdhg_tol must be >= 0, got {self.pdhg_tol!r}")
        if self.pdhg_restart < 0:
            raise ValueError(f"pdhg_restart must be >= 0, got {self.pdhg_restart!r}")
        if self.route_frontier < 0:
            raise ValueError(f"route_frontier must be >= 0, got {self.route_frontier!r}")
        if self.retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {self.retry_budget!r}")
        if self.retry_backoff < 0.0:
            raise ValueError(f"retry_backoff must be >= 0, got {self.retry_backoff!r}")
        if self.backend == "pdhg":
            # A first-order method pivots nothing and stores no tableau.
            if self.rule != _engine.LPC:
                raise ValueError(
                    f"rule={self.rule!r} is meaningless for backend='pdhg' (a first-order "
                    "method performs no pivots); leave rule at its default 'lpc'"
                )
            if self.layout not in (None, DEFAULT_LAYOUT):
                raise ValueError(
                    f"layout={self.layout!r} is meaningless for backend='pdhg' (a first-order "
                    f"method stores no tableau); leave layout unset or {DEFAULT_LAYOUT!r}"
                )
        if self.crossover and self.backend not in ("pdhg", "auto"):
            raise ValueError(
                "crossover=True polishes a first-order solution into an exact vertex and "
                f"requires backend='pdhg' or 'auto'; backend={self.backend!r} already "
                "returns vertices"
            )

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
        Total simplex pivots (PDHG steps on ``pdhg``) across the recorded
        LPs.
    lockstep_iterations : int
        ``max(iterations) * size`` summed per dispatch: the lockstep cost
        model, in which every LP of a launch pays its slowest LP's count.
        Compaction shrinks it toward ``simplex_iterations``.
    tableau_bytes : int
        Peak solver-state bytes of one dispatch (chunk size x bytes per
        LP: the tableau, the revised engine's basis state, or PDHG's
        problem data and iterates).  A compaction round counts its real
        survivors; the reference pads them to a power of two first.
    warm_started : int
        LPs that entered a solve with a carried basis (support sweeps).
    resumed : int
        LPs that entered a round carrying exact mid-solve state
        (``resume="basis"``, and every continuation round of the serve
        loop).
    spliced : int
        LPs the continuous serve loop admitted into a group that already
        carried survivors (``serve/engine.py``).
    quarantined : int
        ``NUMERICAL`` rows re-solved on the float64 oracle
        (``SolveOptions.quarantine``).
    compiles : int
        Kernel specialisations, one per (kernel source, dtype, variant),
        that the recorded backend calls used for the first time in this
        process (on CPU tensors a wrapper's plain version counts as the
        variant ``"plain"``): the torch meaning of the reference's
        new-executable count.  Nothing is compiled per shape or per cap
        in the port, so this stops moving after the first call of each.
    cache_hits : int
        Recorded backend calls that used only specialisations launched
        before.
    retries : int
        Rounds re-dispatched after a transient failure
        (``core/dispatch.py:dispatch_round_safe``).
    dead_lettered : int
        Serve-loop tickets retired ``NUMERICAL`` because their group's
        round exhausted ``retry_budget``.
    faults_injected : int
        Injected faults the recovery layer saw: each raised
        ``ChaosError`` it retried, and each state row poisoned
        (``runtime/chaos.py``).
    autotuned : int
        Options resolutions the cost-model autotuner performed
        (``runtime/autotune.py``): one per resolution with ``autotune``
        on, whatever knobs it filled.
    autotune_log : list of dict
        One row per autotuned resolution: the shape class, the chosen
        ``backend``/``layout`` (``tile_b`` always None: the port has no
        tile knob), ``predicted_s`` against ``measured_s``, and the
        decision's ``source`` (``"predicted"``/``"measured"``/``"cache"``).
    """

    lps: int = 0
    rounds: int = 0
    simplex_iterations: int = 0
    lockstep_iterations: int = 0
    tableau_bytes: int = 0
    warm_started: int = 0
    resumed: int = 0
    spliced: int = 0
    quarantined: int = 0
    compiles: int = 0
    cache_hits: int = 0
    retries: int = 0
    dead_lettered: int = 0
    faults_injected: int = 0
    autotuned: int = 0
    autotune_log: List[dict] = dataclasses.field(default_factory=list)

    def record_tableau(self, nbytes: int) -> None:
        self.tableau_bytes = max(self.tableau_bytes, int(nbytes))

    def record_cache(self, before: int, after: int) -> None:
        """Book one backend call's specialisation delta: growth as ``compiles``,
        none as one ``cache_hits``."""
        if after > before:
            self.compiles += after - before
        else:
            self.cache_hits += 1

    def record(self, sol: LPSolution) -> None:
        iters = sol.iterations
        if iters.numel() == 0:
            return
        self.lps += int(iters.numel())
        self.rounds += 1
        self.simplex_iterations += int(iters.sum())
        self.lockstep_iterations += int(iters.max()) * int(iters.numel())


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named solver implementation over the canonical problem protocol.

    ``start_canonical`` solves like ``solve_canonical`` and also returns
    the exact terminal state; ``resume_canonical`` continues a carried
    state for ``options.max_iters`` ADDITIONAL steps (``batch.b``/``c``,
    and ``a`` for the shared and PDHG engines, come back in);
    ``init_canonical`` is the iteration-0 state, whose resume for K steps
    is bit-identical to a cold solve at cap K.  ``cache_size`` counts the
    specialisations the backend has used (``SolveStats.compiles``), and
    ``auto_cap`` is the backend's cap for ``max_iters=0`` when it is not
    ``50 (m + n)``.
    """

    name: str
    solve_canonical: Callable[[LPBatch, SolveOptions], LPSolution]
    solve_hyperbox: Callable[..., LPSolution]
    start_canonical: Optional[Callable[..., Tuple[LPSolution, object]]] = None
    resume_canonical: Optional[Callable[..., Tuple[LPSolution, object]]] = None
    init_canonical: Optional[Callable[..., object]] = None
    cache_size: Optional[Callable[[], int]] = None
    auto_cap: Optional[Callable[[int, int], int]] = None

    @property
    def supports_resume(self) -> bool:
        """True when the backend implements the exact-state round protocol."""
        return self.start_canonical is not None and self.resume_canonical is not None

    @property
    def supports_splice(self) -> bool:
        """True when new LPs can join an in-flight resume round mid-solve.

        Needs the resume protocol and the iteration-0 init hook: what the
        continuous serve loop uses to splice arrivals into the next round
        beside the carried survivors.
        """
        return self.supports_resume and self.init_canonical is not None


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


def route_shape(m: int, n: int, options: Optional[SolveOptions] = None,
                shared: bool = False, *, dtype=torch.float32, batch: Optional[int] = None,
                device=None) -> str:
    """The shape-routing table behind ``backend="auto"``.

    A dense batch with ``max(m, n)`` below the frontier
    (``options.route_frontier``, 0 -> :data:`DEFAULT_ROUTE_FRONTIER`)
    goes to the simplex kernel (``"cuda"``), at or past it to the
    first-order ``"pdhg"``.  A shared batch always goes to
    ``"cuda-shared"``: its per-LP state is the O(m^2) basis record, and
    densifying it for ``pdhg`` would forfeit the memory the caller asked
    to save.

    With ``options.autotune`` on (the default ``"predict"``) the
    cost-model autotuner ranks the same candidates under the same
    frontier (``runtime/autotune.py:choose_backend``); in ``"predict"``
    mode it gives this table's answer, and a measured trial winner
    (``"trial"``) may pick another candidate on the same side of the
    frontier.  With ``options=None`` or ``autotune="off"`` this is the
    static table (the reference's ``autotune="off"`` leg).
    """
    if options is not None and options.autotune != "off":
        from ..runtime import autotune as _autotune

        return _autotune.choose_backend(m, n, dtype, options, batch=batch, shared=shared,
                                        device=device)
    if shared:
        return "cuda-shared"
    frontier = DEFAULT_ROUTE_FRONTIER
    if options is not None and options.route_frontier > 0:
        frontier = options.route_frontier
    return "pdhg" if max(m, n) >= frontier else "cuda"


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------


def kernel_cache_size() -> int:
    """Kernel specialisations launched so far (``kernels/build.py:SPECIALIZATIONS``)."""
    from ..kernels import build

    return len(build.SPECIALIZATIONS)


def _simplex_kw(options: SolveOptions) -> dict:
    return dict(rule=options.rule, max_iters=options.max_iters, seed=options.seed,
                tol=options.tolerance)


def _torch_solve(batch: LPBatch, options: SolveOptions, want_state: bool = False):
    return _simplex.solve_batched(batch.a, batch.b, batch.c, basis0=batch.basis0,
                                  want_state=want_state, layout=options.effective_layout,
                                  **_simplex_kw(options))


def _torch_start(batch: LPBatch, options: SolveOptions):
    return _torch_solve(batch, options, want_state=True)


def _torch_resume(batch: LPBatch, state: ResumeState, options: SolveOptions):
    return _simplex.resume_batched(batch.b, batch.c, state, **_simplex_kw(options))


def _simplex_init(batch: LPBatch, options: SolveOptions) -> ResumeState:
    # One tableau builder for both simplex backends: the kernel continues
    # the plain version's iteration-0 state.
    return _simplex.init_batched(batch.a, batch.b, batch.c, basis0=batch.basis0,
                                 layout=options.effective_layout)


def _torch_hyperbox(lo, hi, directions, options: SolveOptions) -> LPSolution:
    return _hyperbox.solve_batched(lo, hi, directions)


def _cuda_solve(batch: LPBatch, options: SolveOptions, want_state: bool = False):
    from ..kernels import ops as kernel_ops

    return kernel_ops.simplex_solve(batch.a, batch.b, batch.c, basis0=batch.basis0,
                                    want_state=want_state, layout=options.effective_layout,
                                    **_simplex_kw(options))


def _cuda_start(batch: LPBatch, options: SolveOptions):
    return _cuda_solve(batch, options, want_state=True)


def _cuda_resume(batch: LPBatch, state: ResumeState, options: SolveOptions):
    from ..kernels import ops as kernel_ops

    return kernel_ops.simplex_resume(batch.b, batch.c, state, **_simplex_kw(options))


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


def _torch_shared_solve(batch: SharedLPBatch, options: SolveOptions, want_state: bool = False):
    return _revised.solve_batched(batch.a, batch.b, batch.c, basis0=batch.basis0,
                                  want_state=want_state, **_simplex_kw(options))


def _torch_shared_start(batch: SharedLPBatch, options: SolveOptions):
    return _torch_shared_solve(batch, options, want_state=True)


def _torch_shared_resume(batch: SharedLPBatch, state, options: SolveOptions):
    # The revised engine prices against the shared A every step: it comes back.
    return _revised.resume_batched(batch.a, batch.b, batch.c, state, **_simplex_kw(options))


def _shared_init(batch: SharedLPBatch, options: SolveOptions):
    return _revised.init_batched(batch.a, batch.b, batch.c, basis0=batch.basis0)


def _cuda_shared_solve(batch: SharedLPBatch, options: SolveOptions, want_state: bool = False):
    from ..kernels import ops as kernel_ops

    return kernel_ops.revised_solve(batch.a, batch.b, batch.c, basis0=batch.basis0,
                                    want_state=want_state, **_simplex_kw(options))


def _cuda_shared_start(batch: SharedLPBatch, options: SolveOptions):
    return _cuda_shared_solve(batch, options, want_state=True)


def _cuda_shared_resume(batch: SharedLPBatch, state, options: SolveOptions):
    from ..kernels import ops as kernel_ops

    return kernel_ops.revised_resume(batch.a, batch.b, batch.c, state, **_simplex_kw(options))


def _pdhg_kw(options: SolveOptions, want_state: bool) -> dict:
    return dict(tol=options.pdhg_tol, restart=options.pdhg_restart,
                max_iters=options.max_iters, want_state=want_state)


def _pdhg_solve(batch: LPBatch, options: SolveOptions, want_state: bool = False):
    # basis0 is a simplex warm-start hint; a first-order method ignores it.
    from ..kernels import ops as kernel_ops

    return kernel_ops.pdhg_solve(batch.a, batch.b, batch.c, **_pdhg_kw(options, want_state))


def _pdhg_start(batch: LPBatch, options: SolveOptions):
    return _pdhg_solve(batch, options, want_state=True)


def _pdhg_resume(batch: LPBatch, state, options: SolveOptions):
    # The matvecs read a every step: the full batch comes back.
    from ..kernels import ops as kernel_ops

    return kernel_ops.pdhg_resume(batch.a, batch.b, batch.c, state, **_pdhg_kw(options, True))


def _pdhg_init(batch: LPBatch, options: SolveOptions):
    # The cold solve is a resume of the all-zeros state.
    return _pdhg.init_state(batch.batch, batch.m, batch.n, batch.a.dtype, batch.a.device)
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


register_backend(Backend("cuda", _cuda_solve, _cuda_hyperbox, _cuda_start, _cuda_resume,
                         _simplex_init, kernel_cache_size))
register_backend(Backend("torch", _torch_solve, _torch_hyperbox, _torch_start, _torch_resume,
                         _simplex_init))
# The float64 oracle carries no mid-solve state: resume="basis" on it runs
# scratch rounds.
register_backend(Backend("reference", _reference_solve, _reference_hyperbox))
register_backend(Backend("cuda-shared", _cuda_shared_solve, _cuda_hyperbox, _cuda_shared_start,
                         _cuda_shared_resume, _shared_init, kernel_cache_size))
register_backend(Backend("torch-shared", _torch_shared_solve, _torch_hyperbox,
                         _torch_shared_start, _torch_shared_resume, _shared_init))
# Box LPs are closed-form: the first-order backend's box leg is the
# hyperbox kernel (the reference's is its plain xla closed form).
register_backend(Backend("pdhg", _pdhg_solve, _cuda_hyperbox, _pdhg_start, _pdhg_resume,
                         _pdhg_init, kernel_cache_size, _pdhg.auto_cap_pdhg))
