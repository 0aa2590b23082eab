"""Cost-model autotuner: per-shape-class config selection with a winner cache.

Follows ``repro/runtime/autotune.py``.  The knobs the solver leaves open
(the backend under ``backend="auto"``, the tableau ``layout``) are
chosen per ``(m, n, batch-class, dtype)`` shape class, in three stages:

1. **Predict**: rank every candidate configuration by a static cost
   model of one H100: the analytic per-iteration roofline
   (``runtime/roofline.py:iteration_profile``), the kernels' shared-memory
   residency from the variant planners (``kernels/cluster.py``), and, for
   the plain ``torch`` loops, a host cost per eager operation;
   optionally refined by the operations the plain loop really runs
   (:func:`op_profile`, through ``launch/op_stats.py``).  Prediction is
   pure: no disk, no ``nvcc``, no kernel load, no device work.
2. **Trial**: optionally confirm the predicted top-k by timed micro-solves
   on the real shape and device (``autotune="trial"``), so a measured
   winner can overrule the model.
3. **Cache**: persist measured winners in an on-disk JSON file keyed by
   the device, the shared-memory budget and the shape class
   (schema-versioned, written tmp-then-rename), so a warm process
   resolves every shape class with zero micro-trials.

The tuner is the default resolution path: ``SolveOptions.autotune`` is
``"predict"``, and ``core/dispatch.py:resolve_backend``,
``core/backends.py:route_shape`` and ``SolveSession.resolve_options``
consult it.  In ``"predict"`` mode the ranking reproduces the static
routing table exactly (``route_shape`` with ``autotune="off"``, plus
``DEFAULT_LAYOUT``), on the card and on the CPU.  The tuner changes
WHICH configuration runs, never the per-LP results of one: the simplex
and revised kernels are bit-identical to their plain versions, and the
two layouts to each other.

What replaces the TPU mechanics of the reference:

* **No ``tile_b``.**  One CTA (or one cluster) an LP takes every batch,
  so the reference's tile knob, ``cached_tile_b`` and the tile
  candidates have no counterpart; each ``autotune_log`` row keeps the
  key ``tile_b``, always None, so a reader of the log finds the same
  record.
* **Feasibility.**  The reference drops ``pallas`` off a TPU or past
  VMEM.  Here every candidate runs: past the shared-memory budget each
  kernel has its second variant.  The fit enters the COST instead: in a
  cluster or resident variant the LP's state streams from device memory
  once per solve, in a global variant every iteration.  The planners are
  asked with :data:`~repro_torch.kernels.cluster.MAX_CLUSTER`, not the
  device's measured largest cluster, so prediction needs no kernel.
* **CPU tensors.**  There a kernel backend runs its plain version, so
  ``cuda`` is priced as ``torch`` (and ``cuda-shared`` as
  ``torch-shared``); the tie goes to the kernel backend, the name the
  static table gives (:func:`_tie_order`).
* **The cache** has its own variable (:data:`CACHE_ENV`) and file; the
  port never reads the JAX package's TPU winners.  Its memo and its file
  take a lock: the port dispatches from worker threads.

Decisions are observable (``SolveStats.autotuned`` and one
``SolveStats.autotune_log`` row per decision, predicted against measured
seconds), and :func:`warm` tunes explicitly (``repro_torch.autotune.warm``).

The simplex-vs-``pdhg`` frontier (``SolveOptions.route_frontier``) stays
a constraint, not a ranked knob: crossing it changes what an answer is
(a ``pdhg_tol`` point or a vertex), and a tuner never trades accuracy
for speed.  A caller who wants the simplex kernel past it sets
``route_frontier``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.bucketing import next_pow2
from ..core.tableau import DEFAULT_LAYOUT, LAYOUTS, TableauSpec
from ..kernels import cluster
from .roofline import HBM_BW, iteration_profile, peak_flops

#: Bump when the cache entry format or the cost model changes shape: a
#: file with any other schema is ignored wholesale.
SCHEMA_VERSION = 1

#: Valid values of ``SolveOptions.autotune``.
MODES = ("off", "predict", "trial")

#: Environment override for the on-disk winner cache location.
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

#: Backends the tuner enumerates candidates for; anything else (the
#: ``reference`` oracle, plug-ins) passes through untouched.
TUNABLE_BACKENDS = ("cuda", "torch", "pdhg", "cuda-shared", "torch-shared")

#: Backends that launch a kernel on CUDA tensors.
KERNEL_BACKENDS = ("cuda", "cuda-shared", "pdhg")

#: What a kernel backend runs on CPU tensors: its plain version.
PLAIN_OF = {"cuda": "torch", "cuda-shared": "torch-shared"}

#: Modeled cost of one kernel launch (seconds).
LAUNCH_OVERHEAD_S = 5e-6

#: Modeled host cost of one eager operation of a plain loop (seconds):
#: dispatch, launch and the Python around it.  An assumption; the trials
#: measure what it really is.
HOST_OP_S = 8e-6

#: Batch class assumed when the caller resolves without a batch in hand.
DEFAULT_BATCH_CLASS = 1024


def plain_ops_per_iter(backend: str, m: int) -> float:
    """Eager operations one lockstep iteration of a plain loop issues.

    Counted by ``launch/op_stats.py`` (:func:`op_profile`): 77 for the
    tableau loop (``core/simplex.py``) whatever the shape; ``115 + 8 m``
    for the revised loop (``core/revised.py``), whose ascending sums over
    the basis are one operation per row.  0 for a kernel backend.
    """
    if backend == "torch":
        return 77.0
    if backend == "torch-shared":
        return 115.0 + 8.0 * m
    return 0.0


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One resolved configuration choice for a shape class.

    Attributes
    ----------
    backend : str
        Concrete backend name.
    layout : str, optional
        Tableau layout for ``cuda``/``torch``; None where the knob is
        meaningless (``pdhg``, the shared backends, plug-ins).
    predicted_s : float, optional
        Modeled solve seconds for the batch (the ranking score).
    measured_s : float, optional
        Micro-trial seconds of the winner, when one ran.
    source : str
        ``"predicted"`` | ``"measured"`` | ``"cache"``: how the choice was
        reached, recorded into ``SolveStats.autotune_log``.
    trials : tuple
        ``(backend, layout, predicted_s, measured_s)`` of every candidate
        a trial timed (empty otherwise), the trial batch's prediction
        beside its measurement.
    """

    backend: str
    layout: Optional[str] = None
    predicted_s: Optional[float] = None
    measured_s: Optional[float] = None
    source: str = "predicted"
    trials: Tuple[Tuple[str, Optional[str], float, float], ...] = ()


def default_cache_path() -> str:
    """The winner-cache file: ``$REPRO_TORCH_AUTOTUNE_CACHE`` or ``~/.cache``."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


def _dtype_name(dtype) -> str:
    return str(_torch_dtype(dtype)).replace("torch.", "")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=_torch_dtype(dtype)).element_size()


def _on_card(device) -> bool:
    """Whether a batch on ``device`` launches kernels (None: the card, the
    entry points' default)."""
    return device is None or torch.device(device).type == "cuda"


@functools.lru_cache(maxsize=None)
def _card_name(index: Optional[int]) -> str:
    if not torch.cuda.is_available():
        return "cuda"
    return torch.cuda.get_device_name(torch.cuda.current_device() if index is None else index)


def device_name(device=None) -> str:
    """The device part of a cache key: the card's name, or ``"cpu"``."""
    if not _on_card(device):
        return torch.device(device).type
    return _card_name(None if device is None else torch.device(device).index)


def cache_key(m: int, n: int, batch: Optional[int], dtype, shared: bool = False,
              device=None) -> str:
    """Shape-class cache key.

    Power-of-two size classes (``core/bucketing.py``), so every shape in
    a bucket shares one entry; the device's name and the shared-memory
    budget (``kernels/cluster.py:SMEM_LIMIT``) are part of the key
    because they decide the kernels' variants: a winner measured on one
    card is not served to another, nor to a CPU process.
    """
    bc = next_pow2(batch) if batch else DEFAULT_BATCH_CLASS
    kind = "shared" if shared else "lp"
    return (f"{device_name(device)}|smem{cluster.SMEM_LIMIT}|{kind}"
            f"|m{next_pow2(m)}|n{next_pow2(n)}|b{bc}|{_dtype_name(dtype)}")


def expected_iterations(backend: str, m: int, n: int) -> float:
    """Expected lockstep iterations to convergence for the cost model.

    Simplex paths use the ``2 (m + n)`` expected-pivot rule; ``pdhg`` a
    quarter of its auto cap.  Only the relative cost within a family
    matters: the simplex and ``pdhg`` families are never ranked against
    each other (the frontier is a constraint).
    """
    if backend == "pdhg":
        from ..core.pdhg import auto_cap_pdhg

        return 0.25 * auto_cap_pdhg(m, n)
    return 2.0 * (m + n)


def _profile_kind(backend: str, layout: Optional[str]) -> str:
    if backend == "pdhg":
        return "pdhg"
    if backend.endswith("-shared"):
        return "shared"
    return layout or DEFAULT_LAYOUT


def resident(backend: str, layout: Optional[str], m: int, n: int, dtype,
             max_k: int = cluster.MAX_CLUSTER) -> bool:
    """Whether the kernel of ``backend`` holds an LP's state on chip at this
    shape: the cluster variant of the simplex and PDHG kernels (with
    clusters of at most ``max_k`` CTAs), the resident revised variant.

    The counterpart of the reference's ``VMEM_RESIDENT``: pure planner
    arithmetic, no device query.
    """
    dt = _torch_dtype(dtype)
    if backend == "cuda":
        q = TableauSpec(m, n, layout or DEFAULT_LAYOUT).q
        return cluster.plan_simplex(m, q, dt, max_k).variant == cluster.CLUSTER
    if backend == "pdhg":
        return cluster.plan_pdhg(m, n, dt, max_k).variant == cluster.CLUSTER
    if backend == "cuda-shared":
        return cluster.plan_revised(m, n, dt).variant == cluster.RESIDENT
    return False


def predict_cost(
    backend: str,
    layout: Optional[str],
    m: int,
    n: int,
    batch: int,
    dtype,
    features: Optional[Dict[str, float]] = None,
    device=None,
    max_k: int = cluster.MAX_CLUSTER,
) -> float:
    """Modeled wall seconds to solve one ``batch`` of this shape on ``device``.

    Per-iteration FLOPs and bytes come from the analytic roofline; a
    kernel whose variant holds the state on chip (:func:`resident`)
    streams it once per solve instead of once per iteration, and pays
    one launch.  A plain loop pays the roofline every iteration plus
    :data:`HOST_OP_S` for each eager operation it issues
    (:func:`plain_ops_per_iter`).  ``features``, an :func:`op_profile`
    record, substitutes the plain loop's counted per-iteration traffic,
    flops and operations.  On CPU tensors a kernel backend is priced as
    its plain version, which it runs there.
    """
    priced = backend if _on_card(device) else PLAIN_OF.get(backend, backend)
    kind = _profile_kind(backend, layout)
    item = _itemsize(dtype)
    bsz = max(int(batch), 1)
    # The shared A reaches device memory once an iteration for the whole
    # batch: one GEMM in the plain loop, the L2 behind the kernel's CTAs.
    prof = iteration_profile(kind, m, n, tile_b=bsz if kind == "shared" else 1,
                             dtype_bytes=item)
    flops, byts = prof["flops"], prof["bytes"]
    host_ops = plain_ops_per_iter(priced, m)
    if features is not None and priced not in KERNEL_BACKENDS:
        per = max(float(features.get("batch", bsz)), 1.0)
        flops = max(flops, features.get("dot_flops_per_iter", 0.0) / per)
        counted = features.get("traffic_bytes_per_iter", 0.0) / per
        if counted > 0.0:
            byts = counted
        host_ops = features.get("ops_per_iter", host_ops)
    iters = expected_iterations(backend, m, n)
    flop_s = flops / peak_flops(item)
    byte_s = byts / HBM_BW
    if _on_card(device) and resident(priced, layout, m, n, dtype, max_k):
        per_lp = iters * flop_s + byte_s  # state streams once per solve
    else:
        per_lp = iters * max(flop_s, byte_s)  # roofline: bound by the max
    seconds = per_lp * bsz
    if priced in KERNEL_BACKENDS:
        return seconds + LAUNCH_OVERHEAD_S
    return seconds + iters * host_ops * HOST_OP_S


def feasible(backend: str, layout: Optional[str], m: int, n: int, options,
             shared: bool = False) -> bool:
    """Whether ``(backend, layout)`` may run for this shape under ``options``.

    No shape is infeasible on the card (every kernel has a second variant
    past the shared-memory budget), so what decides is whether the pair
    is one of :func:`candidate_configs`: a tunable backend on the right
    side of the frontier, honouring the caller's pins.  A cached winner
    of the same size class but the other side of the frontier, against a
    pin, or from another build is thereby unusable.
    """
    return (backend, layout) in candidate_configs(m, n, options, shared)


def candidate_configs(m: int, n: int, options, shared: bool = False
                      ) -> List[Tuple[str, Optional[str]]]:
    """Enumerate the ``(backend, layout)`` candidates.

    Explicit pins in ``options`` (a concrete ``backend``, a non-None
    ``layout``) restrict their dimension: the tuner fills gaps, it never
    overrides the caller.  ``backend="auto"`` enumerates the simplex
    pair (``cuda``, ``torch``) below the routing frontier and ``pdhg``
    alone at or above it; on a shared batch, ``cuda-shared`` and
    ``torch-shared``.  A non-tunable pin passes through alone.
    """
    from ..core import backends as _backends

    pinned = None if options.backend == "auto" else options.backend
    if pinned is not None and pinned not in TUNABLE_BACKENDS:
        return [(pinned, options.layout)]
    if pinned is not None:
        names = [pinned]
    elif shared:
        names = ["cuda-shared", "torch-shared"]
    else:
        frontier = options.route_frontier or _backends.DEFAULT_ROUTE_FRONTIER
        names = ["pdhg"] if max(m, n) >= frontier else ["cuda", "torch"]
    out = []
    for name in names:
        if name in ("cuda", "torch"):
            layouts = [options.layout] if options.layout else list(LAYOUTS)
        else:
            layouts = [None]
        out.extend((name, layout) for layout in layouts)
    return out


def _tie_order(cfg: TunedConfig) -> tuple:
    """Order among equal predicted costs: the kernel backend first.

    Costs tie on CPU tensors, where a kernel backend runs (and is priced
    as) its plain version; the static table names the kernel backend, so
    it wins the tie.  Then the names, so ranking never depends on
    enumeration order.
    """
    return (cfg.backend not in KERNEL_BACKENDS, cfg.backend, cfg.layout or "")


def rank_candidates(
    m: int,
    n: int,
    batch: Optional[int],
    dtype,
    options,
    shared: bool = False,
    features: Optional[Dict[str, Dict[str, float]]] = None,
    device=None,
) -> List[TunedConfig]:
    """Candidates ordered by predicted cost (cheapest first).

    ``features`` maps a layout name (``"shared"`` for the revised loop)
    to an :func:`op_profile` record; the plain candidates of that layout
    are scored on the counted operations instead of the analytic
    estimate.
    """
    bsz = batch or DEFAULT_BATCH_CLASS
    scored = []
    for name, layout in candidate_configs(m, n, options, shared):
        feat = None
        if features and name in PLAIN_OF.values():
            feat = features.get("shared" if shared else layout or DEFAULT_LAYOUT)
        cost = predict_cost(name, layout, m, n, bsz, dtype, features=feat, device=device)
        scored.append(TunedConfig(name, layout, predicted_s=cost, source="predicted"))
    scored.sort(key=lambda c: (c.predicted_s, *_tie_order(c)))
    return scored


def op_profile(
    m: int,
    n: int,
    batch: int = 4,
    dtype=torch.float32,
    layout: Optional[str] = None,
    caps: Tuple[int, int] = (8, 24),
    shared: bool = False,
) -> Dict[str, float]:
    """Counted per-iteration cost of the plain loop (the tableau loop of
    ``core/simplex.py``, or with ``shared`` the revised loop of
    ``core/revised.py``).

    Runs the loop on CPU tensors at two iteration caps under
    ``launch/op_stats.py:analyze`` and differences the totals, isolating
    one iteration from the one-time setup; the counts do not depend on
    the device.  Whole-batch numbers, with ``batch`` beside them.  The
    loop runs every trip up to the larger cap only while some LP still
    runs, so a batch that finished before it raises ``ValueError``.
    """
    from ..core import lp as _lp
    from ..core import revised as _revised
    from ..core import simplex as _simplex
    from ..launch import op_stats

    rng = np.random.default_rng(1_000_003 * m + 101 * n + batch)
    np_dtype = np.dtype(_dtype_name(dtype))
    if shared:
        sb = _lp.random_shared_lp_batch(rng, batch, m, n, dtype=np_dtype, device="cpu")
        run = functools.partial(_revised.solve_batched, sb.a, sb.b, sb.c)
    else:
        lb = _lp.random_lp_batch(rng, batch, m, n, dtype=np_dtype, device="cpu")
        run = functools.partial(_simplex.solve_batched, lb.a, lb.b, lb.c,
                                layout=layout or DEFAULT_LAYOUT)
    totals, sols = [], []
    for cap in caps:
        totals.append(op_stats.analyze(lambda: sols.append(run(max_iters=cap))))
    if not bool((sols[-1].status == _lp.ITER_LIMIT).any()):
        raise ValueError(f"op_profile: every LP of {m}x{n} finished before cap {caps[1]}; "
                         "the difference would not be whole iterations")
    span = float(caps[1] - caps[0])
    keys = ("dot_flops", "traffic_bytes", "ops")
    out = {f"{k}_per_iter": (totals[1][k] - totals[0][k]) / span for k in keys}
    out.update({k: float(totals[1][k]) for k in ("dot_flops", "traffic_bytes")})
    out.update(caps=[float(caps[0]), float(caps[1])], batch=float(batch))
    return out


class TuningCache:
    """Torn-write-safe JSON winner cache.

    The file is ``{"schema": N, "entries": {key: entry}}``; a corrupt,
    truncated or schema-mismatched file reads as EMPTY (the tuner then
    predicts, and the next :meth:`store` rewrites a valid file).  Writes
    go to a temporary file then :func:`os.replace`, so a reader never
    sees half a file; concurrent writers are last-wins, which is safe
    because entries are idempotent measurements.
    """

    def __init__(self, path: str):
        self.path = path
        self._entries: Optional[Dict[str, dict]] = None
        self._lock = threading.Lock()

    def _read(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, UnicodeDecodeError):
            return {}  # corrupt / torn / unreadable: behave as empty
        if not isinstance(data, dict) or data.get("schema") != SCHEMA_VERSION:
            return {}  # a schema bump invalidates every stale entry
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    def load(self) -> Dict[str, dict]:
        """Entries, read once and memoized for the cache's lifetime."""
        with self._lock:
            if self._entries is None:
                self._entries = self._read()
            return self._entries

    def lookup(self, key: str) -> Optional[dict]:
        """The stored entry for a shape-class key, or None."""
        entry = self.load().get(key)
        if isinstance(entry, dict) and isinstance(entry.get("backend"), str):
            return entry
        return None

    def store(self, key: str, entry: dict) -> None:
        """Merge one winner into the file atomically (tmp then rename)."""
        with self._lock:
            entries = dict(self._read())  # merge with any concurrent writer
            entries[key] = entry
            self._entries = entries
            directory = os.path.dirname(self.path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"schema": SCHEMA_VERSION, "entries": entries}, f, indent=2)
            os.replace(tmp, self.path)


class Autotuner:
    """The per-process config selector: predict, optionally trial, cache.

    Parameters
    ----------
    cache_path : str, optional
        Winner-cache file (default :func:`default_cache_path`).  Only
        ``autotune="trial"`` resolutions touch it; prediction is pure.
    top_k : int, default 3
        Predicted-best candidates confirmed by micro-trials.
    trial_batch : int, default 256
        LPs per micro-trial (clamped to the real batch when smaller).
        The reference times 8; on a card of 132 SMs a launch of 8 LPs
        leaves most of it idle and times latency, not rate.
    trial_repeats : int, default 3
        Timed repetitions per candidate (the minimum wins) after one
        warm-up run, which absorbs the first build.
    feature_source : str, default "analytic"
        ``"analytic"`` scores candidates from the model alone; ``"ops"``
        also counts the plain loop's operations once per layout
        (:func:`op_profile`) and scores the plain candidates on them.
    """

    def __init__(self, cache_path: Optional[str] = None, top_k: int = 3,
                 trial_batch: int = 256, trial_repeats: int = 3,
                 feature_source: str = "analytic"):
        self.cache = TuningCache(cache_path or default_cache_path())
        self.top_k = top_k
        self.trial_batch = trial_batch
        self.trial_repeats = trial_repeats
        self.feature_source = feature_source
        #: Micro-trials executed by this tuner: zero on a warm cache.
        self.trials_run = 0
        self._memo: Dict[tuple, TunedConfig] = {}
        self._lock = threading.RLock()

    # -- resolution ---------------------------------------------------------

    def get(self, m: int, n: int, dtype, options, batch: Optional[int] = None,
            shared: bool = False, device=None) -> TunedConfig:
        """The config this shape class should run under ``options``.

        Memoized per (shape class, mode, pins) for the tuner's lifetime.
        Resolution order: the memo, then (trial mode only) the on-disk
        winner cache, then the predicted ranking, then micro-trials of
        the top-k when the mode asks for them.  A ``KernelError`` of a
        trial propagates.
        """
        mode = options.autotune
        key = cache_key(m, n, batch, dtype, shared, device)
        # A size class can straddle the frontier (499 and 500 share m512):
        # the candidates, which carry the pins and the frontier's side, key
        # the memo too.
        memo_key = (key, mode, tuple(candidate_configs(m, n, options, shared)))
        with self._lock:
            hit = self._memo.get(memo_key)
            if hit is not None:
                return hit
            choice: Optional[TunedConfig] = None
            if mode == "trial":
                entry = self.cache.lookup(key)
                if entry is not None and feasible(entry["backend"], entry.get("layout"), m, n,
                                                  options, shared):
                    choice = TunedConfig(entry["backend"], entry.get("layout"),
                                         predicted_s=entry.get("predicted_s"),
                                         measured_s=entry.get("measured_s"), source="cache")
            if choice is None:
                features = None
                if self.feature_source == "ops":
                    features = self._op_features(m, n, batch, dtype, options, shared)
                ranked = rank_candidates(m, n, batch, dtype, options, shared=shared,
                                         features=features, device=device)
                choice = ranked[0]
                if mode == "trial":
                    if len(ranked) > 1:
                        choice = self._confirm(ranked[: self.top_k], m, n, batch, dtype,
                                               shared, device, features)
                    self.cache.store(key, self._entry(choice, m, n, batch, dtype, shared))
            self._memo[memo_key] = choice
            return choice

    @staticmethod
    def _entry(choice: TunedConfig, m, n, batch, dtype, shared) -> dict:
        return {
            "backend": choice.backend,
            "layout": choice.layout,
            "predicted_s": choice.predicted_s,
            "measured_s": choice.measured_s,
            "m_class": next_pow2(m),
            "n_class": next_pow2(n),
            "batch_class": next_pow2(batch) if batch else DEFAULT_BATCH_CLASS,
            "dtype": _dtype_name(dtype),
            "shared": bool(shared),
        }

    def _op_features(self, m, n, batch, dtype, options, shared):
        layouts = ["shared"] if shared else (
            [options.layout] if options.layout else list(LAYOUTS))
        feats = {}
        for lay in layouts:
            try:
                feats[lay] = op_profile(m, n, batch=min(batch or 4, 4), dtype=dtype,
                                        layout=None if shared else lay, shared=shared)
            except ValueError as exc:
                warnings.warn(f"autotune: no operation counts for {m}x{n} ({exc}); "
                              "scoring on the analytic model", stacklevel=3)
                return None
        return feats

    # -- micro-trials -------------------------------------------------------

    def _confirm(self, top: Sequence[TunedConfig], m, n, batch, dtype, shared, device,
                 features) -> TunedConfig:
        """Time the predicted top-k on the real shape; the measured best wins."""
        bsz = max(1, min(self.trial_batch, batch or self.trial_batch))
        best, best_t, rows = None, math.inf, []
        for cand in top:
            t = self._measure(cand, m, n, bsz, dtype, shared, device)
            self.trials_run += 1
            feat = None
            if features and cand.backend in PLAIN_OF.values():
                feat = features.get("shared" if shared else cand.layout or DEFAULT_LAYOUT)
            rows.append((cand.backend, cand.layout,
                         predict_cost(cand.backend, cand.layout, m, n, bsz, dtype,
                                      features=feat, device=device), t))
            if t < best_t:
                best, best_t = cand, t
        return dataclasses.replace(best, measured_s=best_t, source="measured",
                                   trials=tuple(rows))

    def _measure(self, cand: TunedConfig, m, n, bsz, dtype, shared, device) -> float:
        from ..core import backends as _backends
        from ..core import dispatch as _dispatch
        from ..core import lp as _lp

        dev = _lp.resolve_device(device)
        rng = np.random.default_rng(1_000_003 * m + 101 * n + bsz)
        make = _lp.random_shared_lp_batch if shared else _lp.random_lp_batch
        trial = make(rng, bsz, m, n, dtype=np.dtype(_dtype_name(dtype)), device=dev)
        # The trial must not recurse into the tuner, and books no stats.
        opts = _backends.SolveOptions(backend=cand.backend, layout=cand.layout,
                                      autotune="off")

        def run():
            _dispatch.solve_canonical(trial, opts)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        run()  # warm-up: the first build and launch
        best = math.inf
        for _ in range(self.trial_repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best


# ---------------------------------------------------------------------------
# process-wide tuner + the hooks the core layers call
# ---------------------------------------------------------------------------

_TUNER: Optional[Autotuner] = None
_TUNER_LOCK = threading.Lock()


def get_tuner() -> Autotuner:
    """The process-wide tuner (created on first use)."""
    global _TUNER
    with _TUNER_LOCK:
        if _TUNER is None:
            _TUNER = Autotuner()
        return _TUNER


def reset(cache_path: Optional[str] = None, **kw) -> Autotuner:
    """Replace the process-wide tuner (test and benchmark hook).

    Drops the memo and re-reads the cache file (``cache_path`` or the
    default) on next use; keyword arguments forward to :class:`Autotuner`.
    """
    global _TUNER
    with _TUNER_LOCK:
        _TUNER = Autotuner(cache_path=cache_path, **kw)
        return _TUNER


def resolve(m: int, n: int, dtype, options, shared: bool = False,
            batch: Optional[int] = None, stats=None, device=None):
    """Tuner-backed options resolution (the dispatch layer's entry point).

    Fills exactly the knobs the caller left open (``backend="auto"``,
    ``layout=None``) from the tuned choice and records the decision into
    ``stats`` (``SolveStats.autotuned`` and one ``autotune_log`` row).
    A shape routed to ``pdhg`` resets ``rule``/``layout`` to their
    defaults; one routed to the simplex leg drops ``crossover``, which
    polishes first-order answers only (``core/dispatch.py:resolve_backend``).
    """
    from ..core import engine as _engine

    choice = get_tuner().get(m, n, dtype, options, batch=batch, shared=shared, device=device)
    kw = {}
    if options.backend == "auto":
        kw["backend"] = choice.backend
        if choice.backend == "pdhg":
            kw["rule"] = _engine.LPC
            kw["layout"] = None
        else:
            kw["crossover"] = False
    if "layout" not in kw and options.layout is None and choice.layout is not None:
        kw["layout"] = choice.layout
    if stats is not None:
        stats.autotuned += 1
        stats.autotune_log.append({
            "m": m,
            "n": n,
            "batch": batch,
            "dtype": _dtype_name(dtype),
            "shared": shared,
            "backend": choice.backend,
            "layout": choice.layout,
            "tile_b": None,
            "predicted_s": choice.predicted_s,
            "measured_s": choice.measured_s,
            "source": choice.source,
        })
    return options.replace(**kw) if kw else options


def choose_backend(m: int, n: int, dtype, options, batch: Optional[int] = None,
                   shared: bool = False, layout: Optional[str] = None, device=None) -> str:
    """Backend name for a shape: ``route_shape``'s tuner-backed leg.

    The caller's pinned backend is ignored (routing asks where a shape
    SHOULD go), so the candidate set is always the ``"auto"`` one;
    ``layout`` overrides the options' layout pin.
    """
    kw = {"backend": "auto"}
    if layout is not None:
        kw["layout"] = layout
    options = options.replace(**kw)
    return get_tuner().get(m, n, dtype, options, batch=batch, shared=shared,
                           device=device).backend


def warm(shapes: Sequence, options=None, dtype=torch.float32, ops: bool = False,
         device=None) -> List[TunedConfig]:
    """Explicit offline tuning: trial-resolve shape classes, persist winners.

    Parameters
    ----------
    shapes : sequence of (m, n) or (m, n, batch)
        Shape classes to tune; batch defaults to the tuner's assumed
        class.
    options : SolveOptions, optional
        Pins to respect (backend/layout); default is the fully open
        ``backend="auto"`` knob space.
    dtype : dtype, default float32
        Solve dtype of the tuned class.
    ops : bool, default False
        Also count the plain loop's operations per layout and rank on
        them (:func:`op_profile`): slower warm, better model.
    device : optional
        Where the trials run (default: the card).

    Returns
    -------
    list of TunedConfig
        The winner per shape, in input order.  Re-warming against a warm
        cache is free (pure cache hits, zero micro-trials).
    """
    from ..core import backends as _backends

    base = (options or _backends.SolveOptions(backend="auto")).replace(autotune="trial")
    tuner = get_tuner()
    prior = tuner.feature_source
    if ops:
        tuner.feature_source = "ops"
    out = []
    try:
        for shape in shapes:
            m, n = int(shape[0]), int(shape[1])
            batch = int(shape[2]) if len(shape) > 2 else None
            out.append(tuner.get(m, n, dtype, base, batch=batch, device=device))
    finally:
        tuner.feature_source = prior
    return out
