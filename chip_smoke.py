#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each; any failure exits non-zero before the last
line is printed:

1. environment: torch and CUDA versions, the card, its power limit, TF32
   off, ``cudaOccupancyMaxActiveClusters`` of the simplex and PDHG
   cluster variants at each cluster size the main paths use, and the
   resident revised CTAs an SM at the slice-2 shapes;
2. build: the four CUDA sources compiled from the checkout, one ``nvcc``
   each, started together, with each kernel's registers, shared memory,
   spills;
3. each kernel against its plain PyTorch version on the card: the simplex
   and revised kernels must be bit-identical in every output and in the
   terminal state, the hyperbox kernel within rtol 1e-6 (float32) /
   1e-12 (float64) of the sum of |terms|, the PDHG kernel equal in status
   and steps at a short cap with its state within the tolerances of
   ``tests/test_torch_pdhg.py``, in agreement on every LP both decide at
   the full cap, and bit-identical to itself across reruns and resume
   chains (the PDHG cases run at the start of slice 3, so that they and
   the HiGHS workers do not weigh on the earlier rows); kernel and plain
   times.  The simplex and PDHG kernels have two variants each
   (``kernels/cluster.py``): every case names the one it took and checks
   it.  The cluster variant carries the main paths' shapes (k = 1 for
   type 1 and the list buckets, 2 for type 2 and a resumed chain, 10 for
   the crossover tile; 5 for the 500x500 PDHG batch, 2 at 200x200 in
   float64); type 1, type 2 and the crossover tile also run the global
   variant on the same LPs (the same bits, timed beside), the PDHG batch
   at cap 400 also runs the streaming variant and clusters of 8 and 16
   (a sweep), and at the auto cap the streaming variant (timed beside,
   statuses held to the cluster variant's), and the batch's slowest LP
   runs alone on both variants (its time a step).  One small case per
   second variant lies past the largest cluster: 4 LPs of 700x700 simplex
   at cap 300, 4 of 1000x1000 PDHG at cap 50.  The revised kernel's
   resident variant carries the slice-2 shapes; shared types 1 and 2 also
   run the global variant (the same bits, timed beside), 64 LPs of
   300x100 lie past the resident budget and take the global variant, and
   each reach sweep is one launch, timed alone.  The hyperbox cases give
   their GB/s, the reach rows' on one box (row stride 0);
4. the main paths, each read with the launch counts set to 0 just before
   it.  Slice 1, the dense and box path at the paper's sizes through
   ``repro_torch.solve``: type 1 (100x100, 50,000 LPs), type 2 (200x100
   infeasible start, 10,000 LPs), hyperbox 4,000,000 x 5 and
   6,000,000 x 28, and one heterogeneous list.  Slice 2, the shared-A
   path: the two paper classes as ``SharedLPBatch``es through
   ``repro_torch.solve``, and the paper's reachability runs (5-dim and
   helicopter, 200 steps) through ``reach_supports`` on the revised
   kernel's warm sweep (one launch a row).  Launch counts, statuses,
   pivots, memory, and samples held against the float64 oracle or the
   hyperbox path; then, with the counts read, each slice-2 row's call
   timed five more times.
   Slice 3, the first-order path: 256 LPs of 500x500 through
   ``backend="auto"`` (one PDHG launch, no simplex launch), the same
   batch with ``crossover=True``, and a list of 100x100 and 500x500 LPs
   through ``"auto"``; a 32-LP sample held against HiGHS in float64.
   After its counts are read, the same batch on the simplex kernel
   (``backend="cuda"``), for the routing frontier.
   Slice 6, the round scheduler (``core/dispatch.py``): types 1 and 2
   on ``cuda`` with ``compaction="every_k"`` + ``resume="basis"`` and
   ``"chunked"`` + ``"scratch"``, shared type 1 on ``cuda-shared`` and
   64 LPs of the slice-3 batch on ``pdhg`` (cap 400) with ``every_k`` +
   ``basis``, each beside ``compaction="off"`` on the same LPs in the same
   call: bit-equal to it, every round one launch of the main variant,
   with the survivors of each round, the lockstep work, the wall times
   and the peak memory; type 1 with the guardrails on and off
   (bit-equal, timed), a NaN written into one carried row of a
   basis-resume state (it retires NUMERICAL, the other rows stay
   bit-equal, the quarantine resolves it on the oracle); three
   ``SolveSession`` calls at the type-1 shape (``compiles`` stops moving);
   and the two reach models' X0 supports as the dense warm sweep,
   ``sweep_problems`` against the per-step loop (the same supports and
   pivots, both timed).
   Slice 7, the serve loop (``serve/engine.py:LPEngine``): first the
   PDHG and hyperbox kernels against their plain versions at the shapes
   the loop launches them (64 LPs of the slice-3 batch padded to their
   512x512 class, at cap 400; the box requests padded to n = 32); 4,096
   requests of ``lp_request_mix([(28, 28), (100, 100)], seed=11)`` and
   64 boxlike requests of n = 28, answered first by one
   ``repro_torch.solve`` of the list; the continuous mode's throughput
   with the whole trace at t = 0 (the calibration R); then, counted, the
   continuous mode (``max_inflight=1024``, ``step_iters=64``) and the
   flush mode (``flush_every=512``) replayed open-loop on one Poisson
   trace at 0.5 R (``serve/loadgen.py``, seed 17) after a warm-up, and 64
   LPs of the slice-3 batch served on ``"auto"`` at cap 400 (four rounds
   of 100, admitted 16 a round, on the variant and ``k`` of the kernel
   case at its class): every request bit-identical to the one-shot solve, p50/p99 latency, throughput, splices, no compile
   after the warm-up.  After the counts were read: the fault cases
   (``runtime/chaos.py``: a failed round and a shard crash retried from
   the carried state, a poisoned row and a dead-lettered group in the
   serve loop, a shared-A retry; each bit-equal where it must be) and
   type 1 in chunks of 6,250 with ``speculation`` on and off (bit-equal,
   timed).  A dispatch round that raises outside the fault cases fails
   the run: no clean phase leans on recovery.  The slice-3 row
   ``pdhg_auto`` also confirms its flags sequentially, once, beside the
   confirmation on host threads (``confirmation``).

   Slice 8: after the rounds phase, with their counts read, ``a_lo``
   times ``canonicalize`` at types 1 and 2 and its row-local ``A lo``
   product (``row_sum`` in blocks of 4,096 rows) beside a batched
   ``einsum``, with the device memory each adds; then the cost-model
   autotuner (``runtime/autotune.py``), after the serve phase: ``autotune_predict`` (the predicted ranking of each
   main-path class, 5x5 to 500x500 and the shared classes, with each
   candidate's seconds, the choice held to the static table; type 1's
   first 5,000 LPs under the default options and under
   ``autotune="off"``: status, pivots and objective bit-equal, one
   autotuned decision), ``autotune_trial`` (``autotune.warm`` with a cache
   file in a temporary directory over 5x5 and 28x28 at 4,096, type 1's and
   type 2's classes and the 5,000-LP class: each candidate's measured and
   predicted seconds on its trial batch, the winner, ``trials_run``; a warm
   process on the same file runs 0 trials; a ``"trial"`` solve of the
   5,000 LPs takes the cached winner, bit-equal to ``"off"``), and, after
   the batches are freed, ``roofline``: the model's H100 constants beside
   ``nvidia-smi``'s name and power limit and a measured device-to-device
   copy of 4 GB.

   Slice 9, the LM serve path, after ``roofline``: gemma2-2b at full
   width, weights from ``models/convert.py:reference_weights`` (checked
   against the fixture's digest) copied to the card, TF32 off.
   ``lm_reference`` (float32): prefill of the fixture's 2 prompts of 40
   tokens, then 8 decode steps fed its tokens, against the JAX
   reference's logits in ``tests/data/lm_gemma2_2b_reference.npz``
   (``tools/lm_reference_fixture.py``): on its 2,048-id vocabulary
   subset at every step, max abs and relative L2 each within the larger
   of 5e-4 / 1e-3 and 4x the function's own float32 noise (the
   fixture's logits with every weight one ulp away), the logsumexp
   within the same abs bound, the argmax equal wherever its top-2
   margin exceeds 2e-3.  ``lm_window`` (float32): 2 prompts of 4,160 tokens,
   past the 4,096 window, then 32 decode steps, each within 1e-3 of the
   full forward at its position; the forward with every layer global
   equal to it below the window and different from it on.  ``lm_serve``
   (bfloat16, the config's dtype): ``Engine.generate`` with no device
   argument on 8 prompts of 4,096 tokens, 128 greedy steps: prefill ms
   and decode ms a step (CUDA events) beside their bounds, peak memory,
   every logit finite, no kernel of the port launched, and the fixture's
   prompts in bfloat16 within 1.5x the reference's own bfloat16 error of
   the fixture.

   Slice 10, MoE with the LP router and MLA, after the LM phase:
   deepseek-v2-lite-16b at full width.  ``lm_moe_reference``: the
   fixture's depth (3 layers: ``mla_dense``, then two ``mla_moe``),
   weights from ``reference_weights`` checked against the digest of
   ``tests/data/lm_deepseek_v2_lite_reference.npz``, under
   ``router="topk"`` and ``"lp"``: the float32 logits against the
   fixture with ``lm_reference``'s row gates (TF32 must fail them); under
   ``lp`` the fixture's 18 router LPs (72 x 512, one a MoE layer a call)
   through the simplex kernel with the reference's status, pivots and
   basis and x within 1e-6, and each LP the port built from its own
   affinities with the reference's basis (a differing one passes only
   where the reduced costs that decided the first differing pivot lie
   within the affinities' float32 rounding); bfloat16 within 1.5x the
   reference's bfloat16 gap.  ``lm_moe_serve``: full depth (27 layers) in
   bfloat16, ``Model.init`` on the card, ``Engine.generate`` on 8 prompts
   of 4,096 tokens and 128 greedy steps, first under ``topk``, then under
   ``lp``, on one loaded model, with the launch counts set to 0 before and
   read after: prefill and decode ms beside their bounds, peak memory,
   the dropped share and the heaviest expert's load over the mean, 0
   simplex launches under ``topk`` and 26 x 128 under ``lp``, all of the
   cluster variant, and the router LPs of the prefill and the first two
   decode steps re-run through ``simplex_plain``, bit-identical.  Then
   ``lm_router_lp``: the prefill's first router LP on the kernel against
   its plain version (``simplex_case``), its ms, pivots, bound, and its
   share of a decode step.

The launch counts of each path are also read per variant: every simplex
and PDHG launch of the main paths must take the cluster variant, every
revised launch the resident variant.  The ``kernels`` line counts the
launches of every path, and each entry's ``serve_path_launches`` those
of slice 7.

Then a ``{"kernels": [...]}`` line (the simplex, revised and PDHG
entries list their variants with their case names; the simplex entry's
``lm_router`` holds the router's case), the ``nvidia-smi``
name and power limit, and as the last line ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: Problems per shape class in the heterogeneous list.
HETERO_PER_CLASS = 64

#: H100 SXM data sheet: memory rate, and peak rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

#: The slice-3 batch: LPs of m = n = PDHG_DIM, the routing frontier.
PDHG_LPS = 256
PDHG_DIM = 500
#: LPs of that batch held against HiGHS.
HIGHS_SAMPLE = 32
#: The PDHG kernel against its plain version: the tolerances of
#: tests/test_torch_pdhg.py (x and y absolute; the other state arrays
#: relative to their largest magnitude).
PDHG_XTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
PDHG_STATE_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
PDHG_FIELDS = ("x", "y", "ax", "x_sum", "y_sum", "ax_sum", "inner", "x_grow", "y_grow")
#: The serve phase's traffic: SERVE_REQUESTS single-LP requests of the
#: request mix, and SERVE_BOXES boxlike requests of n = SERVE_BOX_N.
SERVE_REQUESTS = 4096
SERVE_BOXES = 64
SERVE_BOX_N = 28


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


class Timer:
    """Milliseconds of device work: CUDA events on the card, else the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, reps: int = 1, setup=None) -> float:
        times = []
        for _ in range(reps):
            args = setup() if setup is not None else ()
            self.sync()
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()]) if t.is_floating_point() else t


def launch_counts(counters) -> dict:
    """Each wrapper's launch count, and per variant where it has two
    (``"simplex.cluster"``, ``"simplex.global"``, ...)."""
    out = {}
    for name, mod in counters.items():
        out[name] = mod.launches
        for variant, n in getattr(mod, "variant_launches", {}).items():
            out[f"{name}.{variant}"] = n
    return out


def count_delta(counters, before) -> dict:
    return {k: v - before[k] for k, v in launch_counts(counters).items()}


#: Case names by kernel variant, for the ``{"kernels": [...]}`` line.
CASES: dict = {}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.is_floating_point() or a.numel() == 0:
        return 0.0
    same = (a == b) | (a.isnan() & b.isnan())
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max())


def cluster_occupancy(dev) -> dict:
    """``cudaOccupancyMaxActiveClusters`` of the cluster variants at each
    cluster size the main paths use (and the PDHG sweep's 8 and 16), and
    the resident revised CTAs an SM at the slice-2 shapes, with the
    kernels' own shared-memory arithmetic held against the planner's."""
    import ctypes

    from repro_torch.core.tableau import TableauSpec
    from repro_torch.kernels import build, cluster, pdhg_cuda, revised_cuda, simplex_cuda

    f32 = torch.float32
    out = dict(simplex_device_max_k=simplex_cuda.device_max_k(f32, dev),
               pdhg_device_max_k=pdhg_cuda.device_max_k(f32, dev), shapes=[])
    plans = [("simplex", row, m, TableauSpec(m, n).q, simplex_cuda.plan(TableauSpec(m, n), f32, dev))
             for row, m, n in [("type1", 100, 100), ("type2", 200, 100),
                               ("crossover_tile", PDHG_DIM, PDHG_DIM)]]
    plans += [("pdhg", f"slice3_k{k or 'least'}", PDHG_DIM, PDHG_DIM,
               pdhg_cuda.plan(PDHG_DIM, PDHG_DIM, f32, dev, k)) for k in (None, 8, 16)]
    for kernel, row, m, w, how in plans:
        lib = build.load(kernel)
        smem_fn = getattr(lib, f"{kernel}_cluster_smem")
        smem_fn.restype = ctypes.c_longlong
        smem_fn.argtypes = [ctypes.c_int] * 4
        check(how.variant == "cluster" and smem_fn(m, w, how.k, 4) == how.smem,
              f"{kernel} {row}: plan {how} against the kernel's {smem_fn(m, w, how.k, 4)} bytes")
        out["shapes"].append(dict(
            kernel=kernel, row=row, m=m, width=w, k=how.k, smem_bytes=how.smem,
            max_active_clusters=cluster.active_clusters(lib, f"{kernel}_cluster_occupancy", 4,
                                                        how.k, how.smem)))
    # The revised kernel's resident variant at the slice-2 shapes: shared
    # types 1 and 2, and the reach rows' canonical polytopes.
    lib = build.load("revised")
    smem_fn, occ_fn = lib.revised_resident_smem, lib.revised_resident_occupancy
    smem_fn.restype, smem_fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    occ_fn.restype, occ_fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_longlong]
    for row, m, n in [("shared_type1", 100, 100), ("shared_type2", 200, 100),
                      ("reach_five_dim", 10, 10), ("reach_helicopter", 56, 56)]:
        how = cluster.plan_revised(m, n, f32)
        check(how.variant == "resident" and smem_fn(m, n, 4) == how.smem,
              f"revised {row}: plan {how} against the kernel's {smem_fn(m, n, 4)} bytes")
        blocks = occ_fn(4, how.smem)
        check(blocks >= 1, f"revised {row}: occupancy query gave {blocks}")
        out["shapes"].append(dict(kernel="revised", row=row, m=m, width=n, k=1,
                                  smem_bytes=how.smem, ctas_per_sm=blocks))
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def simplex_case(timer, *, name, batch, rule="lpc", seed=0, layout="compact", chain=None,
                 basis0=None, reps=3, cap=None, k=None, want=None, beside_global=False):
    """One simplex case: the kernel against its plain version, then timed.

    ``batch`` is a canonical ``LPBatch`` on the card: the main path's own
    LPs where the case stands for a main-path launch.  ``basis0`` warm
    starts the tableau, as crossover does.  ``k`` forces the variant (as
    the wrapper's ``_k``), ``want`` is the variant the case must take, and
    ``beside_global`` also runs the global variant on the same inputs,
    held to the same bits and timed in the same call (``global_ms``).
    """
    from repro_torch.core import engine
    from repro_torch.core.simplex import phase2_costs, resolve_cap
    from repro_torch.core.tableau import TableauSpec, build_tableau
    from repro_torch.kernels import ops, simplex_cuda

    bsz, m, n = batch.a.shape
    spec = TableauSpec(m, n, layout)
    tab, basis, phase = (t.contiguous() for t in
                         build_tableau(batch.a, batch.b, batch.c, basis0, spec))
    c_ext = phase2_costs(batch.c, spec)
    feas = engine.phase1_feasibility_tol(batch.b).contiguous()
    tol = engine.default_tolerance(tab.dtype)
    if cap is None:
        cap = resolve_cap(0, m, n) if chain is None else sum(chain)

    def fresh():
        return tab.clone(), basis.clone(), phase.clone()

    kw = dict(spec=spec, rule=rule, seed=seed, tol=tol)
    how = simplex_cuda.plan(spec, tab.dtype, tab.device, k)
    k_state = fresh()
    before = dict(simplex_cuda.variant_launches)
    k_out = simplex_cuda.simplex(*k_state, c_ext, feas, cap, _k=k, **kw)
    timer.sync()
    check(simplex_cuda.variant_launches[how.variant] == before[how.variant] + 1,
          f"simplex case {name} did not launch the {how.variant} variant")
    check(want is None or how.variant == want,
          f"simplex case {name} took the {how.variant} variant, not {want}")
    p_state = fresh()
    t0 = time.perf_counter()
    p_out = simplex_cuda.simplex_plain(*p_state, c_ext, feas, cap, **kw)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = list(zip(k_out + k_state, p_out + p_state))
    if chain is not None:
        # The same LPs as a resumed chain of kernel launches, caps K1 + K2.
        part, state = ops.simplex_solve(batch.a, batch.b, batch.c, rule=rule, seed=seed,
                                        max_iters=chain[0], want_state=True, layout=layout)
        rest, state = ops.simplex_resume(batch.b, batch.c, state, rule=rule, seed=seed,
                                         max_iters=chain[1])
        pairs += [(rest.objective, k_out[0]), (rest.x, k_out[1]), (rest.status, k_out[2]),
                  (part.iterations + rest.iterations, k_out[3]), (state.tab, k_state[0]),
                  (state.basis, k_state[1]), (state.phase, k_state[2])]
    beside = {}
    if beside_global:
        g_state = fresh()
        g_out = simplex_cuda.simplex(*g_state, c_ext, feas, cap, _k=0, **kw)
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(g_out + g_state, k_out + k_state))
        check(same, f"simplex case {name}: the global variant differs from the cluster variant")
        del g_state, g_out
        beside = dict(global_bit_identical=same, global_ms=timer(
            lambda t, b_, p: simplex_cuda.simplex(t, b_, p, c_ext, feas, cap, _k=0, **kw),
            setup=fresh))
        CASES.setdefault("simplex.global", []).append(name)
    identical = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
    err = max(max_abs_diff(a, b) for a, b in pairs)
    ms = timer(lambda t, b_, p: simplex_cuda.simplex(t, b_, p, c_ext, feas, cap, _k=k, **kw),
               reps=reps, setup=fresh)
    CASES.setdefault(f"simplex.{how.variant}", []).append(name)
    iters = k_out[3].to(torch.int64)
    status = k_out[2]
    q = spec.q
    item = tab.element_size()
    # Work this run's data needs: every pivot sweeps the (m+1) x q tableau
    # (a multiply and a subtract per entry) and divides the pivot row and
    # the ratio column; each phase-I LP prices m rows once.
    pivots = int(iters.sum())
    phase1 = int((phase == 1).sum())
    flops = pivots * (2 * (m + 1) * q + q + m) + phase1 * 2 * m * q
    nbytes = (2 * tab.numel() * item + 2 * basis.numel() * 4 + 2 * phase.numel() * 4
              + c_ext.numel() * item + feas.numel() * item
              + bsz * item + bsz * n * item + 2 * bsz * 4)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tab.dtype]
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(tab.dtype), rule=rule, layout=layout,
               variant=how.variant, k=how.k, smem_bytes=how.smem, cap=cap,
               chain=chain, warm=basis0 is not None, bit_identical=identical, max_abs_err=err,
               kernel_ms=ms, **beside, plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes",
               pivots=pivots, max_pivots=int(iters.max()),
               status_counts=np.bincount(status.cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="simplex", **row)
    check(identical, f"simplex kernel differs from its plain version in case {name}")
    return row


def hyperbox_case(dev, timer, *, name, bsz, n, dtype, data_seed, reps=20, box=False,
                  data=None):
    """The hyperbox kernel against its plain version; ``box`` reads one box
    (row 0 of the data) for every direction, with row stride 0, as the
    reach rows do.  ``data`` gives ``(lo, hi, d)`` on the card instead of
    random boxes (a main path's own inputs)."""
    from repro_torch.kernels import hyperbox_cuda

    if data is None:
        lo, hi, d = chunked_hyperbox(np.random.default_rng(data_seed), bsz, n, dtype, dev)
    else:
        lo, hi, d = data
    if box:
        lo, hi = lo[0].contiguous(), hi[0].contiguous()
    k = hyperbox_cuda.hyperbox(lo, hi, d)
    p = hyperbox_cuda.hyperbox_plain(lo, hi, d)
    timer.sync()
    scale = (d * torch.where(d < 0, lo, hi)).abs().sum(dim=-1)
    rtol = 1e-6 if d.dtype == torch.float32 else 1e-12
    err = (k - p).abs()
    ok = bool((err <= rtol * scale).all())
    ms = timer(lambda: hyperbox_cuda.hyperbox(lo, hi, d), reps=reps)
    plain_ms = timer(lambda: hyperbox_cuda.hyperbox_plain(lo, hi, d), reps=max(1, reps // 4))
    item = d.element_size()
    nbytes = (d.numel() + lo.numel() + hi.numel() + bsz) * item
    flops = 2 * bsz * n
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[d.dtype]
    row = dict(case=name, batch=bsz, n=n, dtype=str(d.dtype), box=box, within_tolerance=ok,
               rtol=rtol, max_abs_err=float(err.max()),
               max_rel_err_of_abs_sum=float((err / scale).max()),
               kernel_ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes",
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    emit("kernel_vs_plain", kernel="hyperbox", **row)
    check(ok, f"hyperbox kernel outside tolerance in case {name}")
    return row


def revised_work(m, n, pivots, pricing_steps):
    """Flops the revised simplex needs: every step prices (y, w.A, the
    phase-I value), every pivot adds u, the ratio divides and the rank-1
    update of binv and xb."""
    return pricing_steps * (2 * m * m + 2 * m * n + 2 * m) + pivots * (4 * m * m + 4 * m)


def revised_case(timer, *, name, sb, rule="lpc", seed=0, chain=None, basis0=None, reps=3,
                 variant=None, want=None, beside_global=False):
    """One revised case: the kernel against its plain version, then timed.

    ``sb`` is a ``SharedLPBatch`` on the card, the main path's own LPs
    where the case stands for a main-path launch.  ``variant`` forces the
    variant (as the wrapper's ``_variant``), ``want`` is the variant the
    case must take, and ``beside_global`` also runs the global variant on
    the same inputs, held to the same bits and timed in the same call
    (``global_ms``).
    """
    from repro_torch.core import engine, revised
    from repro_torch.core.simplex import resolve_cap
    from repro_torch.kernels import cluster, ops, revised_cuda

    a, b, c = sb.a, sb.b, sb.c
    bsz, m, n = sb.batch, sb.m, sb.n
    state = revised.init_traced(a, b, basis0)
    feas = engine.phase1_feasibility_tol(b).contiguous()
    tol = engine.default_tolerance(a.dtype)
    cap = resolve_cap(0, m, n) if chain is None else sum(chain)

    def fresh():
        return [t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]

    kw = dict(rule=rule, seed=seed, tol=tol)
    how = cluster.plan_revised(m, n, a.dtype, variant)
    k_state = fresh()
    before = dict(revised_cuda.variant_launches)
    k_out = list(revised_cuda.revised(a, b, c, *k_state, feas, cap, _variant=variant, **kw))
    timer.sync()
    check(revised_cuda.variant_launches[how.variant] == before[how.variant] + 1,
          f"revised case {name} did not launch the {how.variant} variant")
    check(want is None or how.variant == want,
          f"revised case {name} took the {how.variant} variant, not {want}")
    p_state = fresh()
    t0 = time.perf_counter()
    p_out = list(revised_cuda.revised_plain(a, b, c, *p_state, feas, cap, **kw))
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = list(zip(k_out + k_state, p_out + p_state))
    if chain is not None:
        # The same LPs as a resumed chain of kernel launches, caps K1 + K2.
        part, st = ops.revised_solve(a, b, c, rule=rule, seed=seed, max_iters=chain[0],
                                     want_state=True)
        rest, st = ops.revised_resume(a, b, c, st, rule=rule, seed=seed, max_iters=chain[1])
        pairs += [(rest.objective, k_out[0]), (rest.x, k_out[1]), (rest.status, k_out[2]),
                  (part.iterations + rest.iterations, k_out[3]), (st.binv, k_state[0]),
                  (st.basis, k_state[1]), (st.xb, k_state[2]), (st.phase, k_state[3])]
    del p_state, p_out
    beside = {}
    if beside_global:
        g_state = fresh()
        g_out = list(revised_cuda.revised(a, b, c, *g_state, feas, cap, _variant="global", **kw))
        same = all(torch.equal(bits(x), bits(y)) for x, y in zip(g_out + g_state, k_out + k_state))
        check(same, f"revised case {name}: the global variant differs from the resident variant")
        del g_state, g_out
        beside = dict(global_bit_identical=same, global_ms=timer(
            lambda *st: revised_cuda.revised(a, b, c, *st, feas, cap, _variant="global", **kw),
            setup=fresh))
        CASES.setdefault("revised.global", []).append(name)
    identical = all(torch.equal(bits(x), bits(y)) for x, y in pairs)
    err = max(max_abs_diff(x, y) for x, y in pairs)
    ms = timer(lambda *st: revised_cuda.revised(a, b, c, *st, feas, cap, _variant=variant, **kw),
               reps=reps, setup=fresh)
    CASES.setdefault(f"revised.{how.variant}", []).append(name)
    iters = k_out[3].to(torch.int64)
    pivots = int(iters.sum())
    # Each LP prices once more than it pivots, and once more again when it
    # enters phase II.
    flops = revised_work(m, n, pivots, pivots + bsz + int((state.phase == 1).sum()))
    item = a.element_size()
    nbytes = ((m * n + bsz * (m + n + 2 * m * m + 2 * m + 1 + n + 1)) * item
              + bsz * (2 * m + 2 + 2) * 4)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[a.dtype]
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(a.dtype), rule=rule, chain=chain,
               warm=basis0 is not None, variant=how.variant, smem_bytes=how.smem,
               bit_identical=identical, max_abs_err=err, kernel_ms=ms, **beside,
               plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes", pivots=pivots,
               max_pivots=int(iters.max()),
               status_counts=np.bincount(k_out[2].cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="revised", **row)
    check(identical, f"revised kernel differs from its plain version in case {name}")
    return row


def sweep_case(timer, dev, *, name, model, kind, steps, reps=3):
    """The reach row's warm sweep: ``ops.revised_sweep`` (one kernel launch
    for the whole sweep) against the plain ``sweep_batched``, on the same
    inputs; timed as the kernel's launch alone (CUDA events)."""
    from repro_torch.core import engine, reach, revised, support
    from repro_torch.kernels import cluster, ops, revised_cuda

    dirs = support.template_directions(model.dim, kind)
    stack = reach.direction_stack(model, 0.02, steps, dirs).astype(np.float32)
    sb, c_stack = support.box_to_polytope(model.x0).shared_sweep_inputs(stack, device=dev)
    how = cluster.plan_revised(sb.m, sb.n, sb.a.dtype)
    before = dict(revised_cuda.variant_launches)
    k_out = ops.revised_sweep(sb.a, sb.b, c_stack)
    timer.sync()
    launched = {v: revised_cuda.variant_launches[v] - before[v] for v in before}
    check(sum(launched.values()) == 1 and launched["resident"] == 1,
          f"revised sweep {name} launched {launched}, not one resident launch")
    t0 = time.perf_counter()
    p_out = revised.sweep_batched(sb.a, sb.b, c_stack)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    identical = all(torch.equal(bits(x), bits(y)) for x, y in zip(k_out, p_out))
    err = max(max_abs_diff(x, y) for x, y in zip(k_out, p_out))
    cap, tol = revised.resolve_cap_tol(sb.a, 0, 0.0)
    feas = engine.phase1_feasibility_tol(sb.b).contiguous()
    ms = timer(lambda: revised_cuda.revised_sweep(sb.a, sb.b, c_stack, feas, cap, tol=tol),
               reps=reps)
    CASES.setdefault("revised.resident", []).append(name)
    m, n, bsz = sb.m, sb.n, sb.batch
    pivots = int(k_out[3].to(torch.int64).sum())
    flops = revised_work(m, n, pivots, pivots + steps * bsz)
    item = sb.a.element_size()
    nbytes = (m * n + bsz * m + c_stack.numel() + bsz + steps * bsz * (1 + n)) * item \
        + steps * bsz * 2 * 4
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[sb.a.dtype]
    row = dict(case=name, steps=steps, batch=bsz, m=m, n=n, dtype=str(sb.a.dtype),
               variant=how.variant, smem_bytes=how.smem, launches_per_run=sum(launched.values()),
               bit_identical=identical, max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
               bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes", pivots=pivots,
               status_counts=np.bincount(k_out[2].flatten().cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="revised_sweep", **row)
    check(row["launches_per_run"] == 1, f"revised sweep {name} took more than one launch")
    check(identical, f"revised sweep differs from its plain version in case {name}")
    return row


def pdhg_work(bsz, m, n, item, dtype, steps):
    """The PDHG bound from this run's step counts.

    Returns ``(bound_s, bound_by, compute_s, stream_s)``: the compute
    floor (4 m n flops a step, A on chip), the streaming floor (A read
    twice a step from HBM), and the bound, the larger of the compute
    floor and the bytes the function must move once (A, b, c, the state
    in and out, status and steps).
    """
    compute_s = steps * 4 * m * n / PEAK_FLOPS[dtype]
    stream_s = steps * 2 * m * n * item / HBM_BYTES_PER_S
    nbytes = item * bsz * (m * n + m + n + 2 * (2 * n + 4 * m + 2) + 5) + 4 * bsz * 4
    once_s = nbytes / HBM_BYTES_PER_S
    return max(compute_s, once_s), ("operations" if compute_s > once_s else "bytes"), \
        compute_s, stream_s


def pdhg_case(timer, *, name, batch, cap, full, reps=1, eager=False, k=None, want=None):
    """The PDHG kernel against its plain version on the same LPs and step sizes.

    ``full=False`` (a short cap): statuses and steps equal per LP and the
    state within PDHG_XTOL / PDHG_STATE_RTOL.  ``full=True`` (the auto
    cap): statuses equal on every LP both decide, at most 1% of the LPs
    decided by one side only, objectives within 1e-3 relative where both
    are OPTIMAL.  Kernel ms is the compared launch's (CUDA events; the
    library is loaded before), or the median of ``reps`` more launches.
    ``eager`` also runs the plain loop without its CUDA graph: the same
    bits, and what the graph saves.  ``k`` forces the variant (as the
    wrapper's ``_k``); ``want`` is the variant the case must take.
    Returns ``(row, status, state, steps)`` of the kernel's launch.
    """
    from repro_torch.core import pdhg
    from repro_torch.kernels import build, pdhg_cuda

    a, b, c = batch.a, batch.b, batch.c
    bsz, m, n = a.shape
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    kw = dict(tol=pdhg.DEFAULT_PDHG_TOL, restart=pdhg.DEFAULT_RESTART)

    def fresh():
        return (pdhg.init_state(bsz, m, n, a.dtype, a.device),)

    def launch(state):
        return pdhg_cuda.pdhg(a, b, c, state, tau, sigma, scales, cap, _k=k, **kw)

    if a.is_cuda:
        build.load("pdhg")
    how = pdhg_cuda.plan(m, n, a.dtype, a.device, k)
    check(want is None or how.variant == want,
          f"pdhg case {name} took the {how.variant} variant, not {want}")
    k_state = fresh()[0]
    k_out = []
    before = dict(pdhg_cuda.variant_launches)
    ms = timer(lambda: k_out.append(launch(k_state)))
    check(pdhg_cuda.variant_launches[how.variant] == before[how.variant] + 1,
          f"pdhg case {name} did not launch the {how.variant} variant")
    CASES.setdefault(f"pdhg.{how.variant}", []).append(name)
    k_status, k_iters = k_out[0]
    p_state = fresh()[0]
    t0 = time.perf_counter()
    p_status, p_iters = pdhg_cuda.pdhg_plain(a, b, c, p_state, tau, sigma, scales, cap, **kw)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    graph_check = {}
    if eager:
        e_state = fresh()[0]
        t0 = time.perf_counter()
        e_status, e_iters, e_out = pdhg.iterate_with(a, b, c, e_state, cap, tau, sigma, scales,
                                                     graph=False, **kw)
        timer.sync()
        same = torch.equal(e_status, p_status) and torch.equal(e_iters, p_iters) and all(
            torch.equal(bits(getattr(e_out, f)), bits(getattr(p_state, f))) for f in PDHG_FIELDS)
        graph_check = dict(plain_eager_ms=(time.perf_counter() - t0) * 1e3,
                           graph_bit_identical_to_eager=same)
        check(same, f"pdhg plain loop: the CUDA graph differs from the eager loop in {name}")
    if reps > 1:
        ms = timer(launch, reps=reps, setup=fresh)
    diffs = {f: max_abs_diff(getattr(k_state, f), getattr(p_state, f)) for f in PDHG_FIELDS
             if f != "inner"}
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(a.dtype), cap=cap, full_cap=full,
               variant=how.variant, k=how.k, smem_bytes=how.smem, kernel_ms=ms, plain_ms=plain_ms, **graph_check,
               max_abs_err=max(diffs["x"], diffs["y"]),
               state_max_abs_diff=diffs,
               kernel_steps=int(k_iters.to(torch.int64).sum()),
               plain_steps=int(p_iters.to(torch.int64).sum()),
               max_steps=int(k_iters.max()),
               status_counts=np.bincount(k_status.cpu().numpy(), minlength=6).tolist(),
               plain_status_counts=np.bincount(p_status.cpu().numpy(), minlength=6).tolist())
    bound_s, bound_by, compute_s, stream_s = pdhg_work(bsz, m, n, a.element_size(), a.dtype,
                                                       row["kernel_steps"])
    row.update(bound_ms=bound_s * 1e3, bound_by=bound_by, compute_floor_ms=compute_s * 1e3,
               streaming_floor_ms=stream_s * 1e3)
    if not full:
        same = torch.equal(k_status, p_status) and torch.equal(k_iters, p_iters)
        close = torch.equal(k_state.inner, p_state.inner)
        for f, d in diffs.items():
            ref = getattr(p_state, f)
            tol = PDHG_XTOL[a.dtype] if f in ("x", "y") else \
                PDHG_STATE_RTOL[a.dtype] * max(1.0, float(ref.abs().max()))
            close = close and d <= tol
        row.update(status_and_steps_equal=same, state_within_tolerance=close)
        emit("kernel_vs_plain", kernel="pdhg", **row)
        check(same, f"pdhg kernel: statuses or steps differ from the plain version in {name}")
        check(close, f"pdhg kernel: state outside tolerance of the plain version in {name}")
        return row, k_status, k_state, k_iters
    limit = 4  # ITER_LIMIT
    k_dec, p_dec = k_status != limit, p_status != limit
    both = k_dec & p_dec
    disagree = int((both & (k_status != p_status)).sum())
    one_side = int((k_dec ^ p_dec).sum())
    k_obj = pdhg.objective(c, k_state.x, k_status)
    p_obj = pdhg.objective(c, p_state.x, p_status)
    opt = (k_status == 1) & (p_status == 1)
    rel = ((k_obj - p_obj).abs() / p_obj.abs().clamp(min=1.0))[opt]
    row.update(both_decide=int(both.sum()), decided_disagree=disagree,
               decided_by_one_side_only=one_side,
               max_rel_obj_diff=float(rel.max()) if rel.numel() else 0.0,
               steps_equal_share=float((k_iters == p_iters).double().mean()))
    emit("kernel_vs_plain", kernel="pdhg", **row)
    check(disagree == 0, f"pdhg kernel: {disagree} decided statuses differ in {name}")
    check(one_side <= 0.01 * bsz, f"pdhg kernel: {one_side} LPs decided by one side in {name}")
    check(row["max_rel_obj_diff"] <= 1e-3, f"pdhg kernel: objectives off by "
          f"{row['max_rel_obj_diff']:.3g} in {name}")
    return row, k_status, k_state, k_iters


def pdhg_slowest_lp(timer, *, batch, status, steps, streaming_cap):
    """The per-step time of the batch's slowest LP, alone on the card: the
    cluster variant at the auto cap (the LP's own steps) and the streaming
    variant (forced) at ``streaming_cap`` steps, in the same call."""
    from repro_torch.core import pdhg
    from repro_torch.kernels import pdhg_cuda

    row = int(torch.argmax(steps))
    one = batch.take(slice(row, row + 1))
    a, b, c = one.a, one.b, one.c
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    kw = dict(tol=pdhg.DEFAULT_PDHG_TOL, restart=pdhg.DEFAULT_RESTART)
    out = {}
    for variant, k, cap in [("cluster", None, pdhg.auto_cap_pdhg(one.m, one.n)),
                            ("streaming", 0, streaming_cap)]:
        state = pdhg.init_state(1, one.m, one.n, a.dtype, a.device)
        got = []
        ms = timer(lambda: got.append(pdhg_cuda.pdhg(a, b, c, state, tau, sigma, scales, cap,
                                                     _k=k, **kw)))
        n_steps = int(got[0][1][0])
        out[variant] = dict(k=pdhg_cuda.plan(one.m, one.n, a.dtype, a.device, k).k, cap=cap,
                            steps=n_steps, kernel_ms=ms, us_per_step=1e3 * ms / max(1, n_steps))
    emit("pdhg_slowest_lp", row=row, batch_status=int(status[row]), batch_steps=int(steps[row]),
         **out)
    return out


def pdhg_streaming_beside(timer, *, name, batch, cluster_status):
    """The streaming variant (forced) on the batch at the auto cap, timed in
    the same call as the cluster variant, its statuses held to the cluster
    variant's as the auto-cap case holds the kernel to the plain version."""
    from repro_torch.core import pdhg
    from repro_torch.kernels import pdhg_cuda

    a, b, c = batch.a, batch.b, batch.c
    bsz, m, n = a.shape
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    state = pdhg.init_state(bsz, m, n, a.dtype, a.device)
    out = []
    ms = timer(lambda: out.append(pdhg_cuda.pdhg(
        a, b, c, state, tau, sigma, scales, pdhg.auto_cap_pdhg(m, n), _k=0,
        tol=pdhg.DEFAULT_PDHG_TOL, restart=pdhg.DEFAULT_RESTART)))
    status, steps = out[0]
    dec_s, dec_c = status != 4, cluster_status != 4
    disagree = int((dec_s & dec_c & (status != cluster_status)).sum())
    one_side = int((dec_s ^ dec_c).sum())
    CASES.setdefault("pdhg.streaming", []).append(name)
    emit("pdhg_streaming_beside", case=name, kernel_ms=ms,
         kernel_steps=int(steps.to(torch.int64).sum()), max_steps=int(steps.max()),
         decided_disagree=disagree, decided_by_one_side_only=one_side)
    check(disagree == 0 and one_side <= 0.01 * bsz,
          f"pdhg streaming variant: statuses off the cluster variant in {name}")
    return ms


def pdhg_chain_case(*, name, batch):
    """A 150 + 250 resume chain and a rerun, each bit-identical to one launch at 400."""
    from repro_torch.kernels import ops

    a, b, c = batch.a, batch.b, batch.c
    full, full_state = ops.pdhg_solve(a, b, c, max_iters=400, want_state=True)
    again, again_state = ops.pdhg_solve(a, b, c, max_iters=400, want_state=True)
    part, state = ops.pdhg_solve(a, b, c, max_iters=150, want_state=True)
    rest, rest_state = ops.pdhg_resume(a, b, c, state, max_iters=250)
    torch.cuda.synchronize()
    rerun = all(torch.equal(bits(getattr(again, f)), bits(getattr(full, f)))
                for f in ("objective", "x", "y", "status", "iterations")) and \
        all(torch.equal(bits(getattr(again_state, f)), bits(getattr(full_state, f)))
            for f in PDHG_FIELDS)
    chain = all(torch.equal(bits(getattr(rest, f)), bits(getattr(full, f)))
                for f in ("objective", "x", "y", "status")) and \
        torch.equal(part.iterations + rest.iterations, full.iterations) and \
        all(torch.equal(bits(getattr(rest_state, f)), bits(getattr(full_state, f)))
            for f in PDHG_FIELDS)
    emit("kernel_vs_itself", kernel="pdhg", case=name, batch=batch.batch, m=batch.m, n=batch.n,
         rerun_bit_identical=rerun, chain_150_250_bit_identical_to_400=chain)
    check(rerun, f"pdhg kernel: two launches differ in {name}")
    check(chain, f"pdhg kernel: the 150 + 250 chain differs from one launch at 400 in {name}")


def certificate_batch(dev):
    """4 LPs of 100x100, rows 0 and 1 unbounded by construction (tests/test_pdhg.py)."""
    from repro_torch.core.lp import LPBatch

    rng = np.random.default_rng(3)
    m = n = 100
    a = rng.standard_normal((4, m, n)).astype(np.float32)
    b = (np.abs(rng.standard_normal((4, m))) + 0.5).astype(np.float32)
    c = rng.standard_normal((4, n)).astype(np.float32)
    for i in (0, 1):
        d = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        a[i] -= np.outer(a[i] @ d + 0.1, d / (d @ d))
        c[i] = np.abs(c[i])
    return LPBatch.from_numpy(a, b, c, device=dev)


def highs_solve(lp):
    """One LP (max c.x, Ax <= b, x >= 0) by HiGHS in float64: (status code, objective)."""
    from scipy.optimize import linprog

    a, b, c = (np.asarray(v, np.float64) for v in lp)
    res = linprog(-c, A_ub=a, b_ub=b, bounds=(0, None), method="highs")
    status = {0: 1, 2: 3, 3: 2}.get(res.status, 4)
    return status, (float(-res.fun) if res.status == 0 else -float("inf"))


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------


def chunked_lp_batch(rng, bsz, m, n, feasible, dtype, dev, chunk):
    """``random_lp_batch`` made chunk by chunk (host memory stays small).

    Returns device tensors ``(a, b, c)`` and the first chunk's host arrays
    (the oracle's sample).
    """
    from repro_torch.core.lp import random_lp_batch

    a = torch.empty((bsz, m, n), dtype=dtype, device=dev)
    b = torch.empty((bsz, m), dtype=dtype, device=dev)
    c = torch.empty((bsz, n), dtype=dtype, device=dev)
    first = None
    for lo in range(0, bsz, chunk):
        hi = min(lo + chunk, bsz)
        part = random_lp_batch(rng, hi - lo, m, n, feasible, dtype=np.dtype(str(dtype)[6:]),
                               device="cpu")
        if first is None:
            first = tuple(t.numpy().copy() for t in (part.a, part.b, part.c))
        a[lo:hi].copy_(part.a)
        b[lo:hi].copy_(part.b)
        c[lo:hi].copy_(part.c)
    return a, b, c, first


def chunked_hyperbox(rng, bsz, n, dtype, dev, chunk=1_000_000):
    from repro_torch.core.lp import random_hyperbox_batch

    out = [torch.empty((bsz, n), dtype=dtype, device=dev) for _ in range(3)]
    for lo in range(0, bsz, chunk):
        hi = min(lo + chunk, bsz)
        parts = random_hyperbox_batch(rng, hi - lo, n, dtype=np.dtype(str(dtype)[6:]),
                                      device="cpu")
        for dst, src in zip(out, parts):
            dst[lo:hi].copy_(src)
    return out


def oracle_check(a, b, c, status, objective, sample):
    """Statuses and objectives of the first ``sample`` LPs against the float64 oracle."""
    from repro_torch.core import oracle

    k = min(sample, a.shape[0])
    o_obj, _, o_status, _ = oracle.solve_batch(a[:k], b[:k], c[:k])
    st = status[:k]
    obj = objective[:k].astype(np.float64)
    agree = float((st == o_status).mean())
    both = (st == 1) & (o_status == 1)
    rel = np.abs(obj[both] - o_obj[both]) / np.maximum(1.0, np.abs(o_obj[both]))
    return dict(sample=int(k), status_agreement=agree,
                max_rel_obj_err=float(rel.max()) if rel.size else 0.0)


def simplex_row(rt, dev, *, name, bsz, m, n, feasible, seed, counters):
    a, b, c, host = chunked_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible,
                                     torch.float32, dev, chunk=5000)
    problem = rt.LPProblem.make(c, a, bu=b)
    del a, b, c
    return run_row(rt, dev, name=name, problem=problem, counters=counters,
                   oracle_data=host, lps=bsz, extra=dict(m=m, n=n))


def hyperbox_row(rt, dev, *, name, bsz, n, seed, counters):
    lo, hi, d = chunked_hyperbox(np.random.default_rng(seed), bsz, n, torch.float32, dev)
    problem = rt.LPProblem.make(d, lo=lo, hi=hi)
    del lo, hi, d
    return run_row(rt, dev, name=name, problem=problem, counters=counters, oracle_data=None,
                   lps=bsz, extra=dict(n=n))


def run_row(rt, dev, *, name, problem, counters, oracle_data, lps, extra):
    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(problem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy()
    row = dict(row=name, lps=lps, **extra, dtype="float32", wall_s=wall, lps_per_s=lps / wall,
               launches=delta, status_counts=np.bincount(status, minlength=6).tolist(),
               mean_pivots=float(iters.mean()), max_pivots=int(iters.max()),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               finite_objective_share=float(np.isfinite(sol.objective.cpu().numpy()).mean()))
    check(sum(delta.values()) > 0, f"main-path row {name} launched no kernel")
    check(tuple(sol.x.shape) == (lps, problem.n), f"row {name}: x has shape {tuple(sol.x.shape)}")
    if oracle_data is not None:
        row["oracle"] = oracle_check(*oracle_data, status, sol.objective.cpu().numpy(), 256)
        check(row["oracle"]["status_agreement"] >= 0.99,
              f"row {name}: statuses agree with the oracle on only "
              f"{row['oracle']['status_agreement']:.3f} of the sample")
        check(row["oracle"]["max_rel_obj_err"] <= 1e-4,
              f"row {name}: objective off the oracle by {row['oracle']['max_rel_obj_err']:.3g}")
    else:
        # Box LPs: every LP optimal, x the maximizing vertex, and the support
        # value against float64 on a sample, relative to the sum of |terms|.
        k = min(4096, lps)
        lo, hi, d = (t[:k].double() for t in (problem.lo, problem.hi, problem.c))
        terms = d * torch.where(d < 0, lo, hi)
        rel = (sol.objective[:k].double() - terms.sum(-1)).abs() / terms.abs().sum(-1)
        row["oracle"] = dict(sample=k, max_rel_err_of_abs_sum=float(rel.max()))
        check(bool((sol.status == rt.OPTIMAL).all()), f"row {name}: a box LP is not OPTIMAL")
        check(float(rel.max()) <= 1e-5, f"row {name}: support values off float64")
        check(torch.equal(sol.x[:k].double(), torch.where(d < 0, lo, hi)),
              f"row {name}: x is not the maximizing vertex")
    emit("main_path", **row)
    return row


def shared_row(rt, dev, *, name, bsz, m, n, feasible, seed, counters, dense_row, reruns):
    """A paper class as one ``SharedLPBatch`` through ``repro_torch.solve``.

    Appends ``(name, lps, fn)`` to ``reruns``: the same call, for
    :func:`repeat_rows` to time once the launch counts have been read.
    """
    from repro_torch.core.lp import random_shared_lp_batch

    sb = random_shared_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible, device=dev)
    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(sb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy()
    k = 256
    sample = tuple(t[:k].cpu().numpy() for t in (sb.densify().a, sb.b, sb.c))
    row = dict(row=name, lps=bsz, m=m, n=n, dtype="float32", wall_s=wall, lps_per_s=bsz / wall,
               launches=delta, status_counts=np.bincount(status, minlength=6).tolist(),
               mean_pivots=float(iters.mean()), max_pivots=int(iters.max()),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               dense_row=dense_row["row"],
               dense_row_max_memory_allocated=dense_row["max_memory_allocated"],
               oracle=oracle_check(*sample, status, sol.objective.cpu().numpy(), k))
    emit("main_path", **row)
    reruns.append((name, bsz, lambda: rt.solve(sb)))
    check(delta["revised"] > 0, f"row {name} did not launch the revised kernel")
    check(tuple(sol.x.shape) == (bsz, n), f"row {name}: x has shape {tuple(sol.x.shape)}")
    check(row["oracle"]["status_agreement"] >= 0.99,
          f"row {name}: statuses agree with the oracle on only "
          f"{row['oracle']['status_agreement']:.3f} of the sample")
    check(row["oracle"]["max_rel_obj_err"] <= 1e-4,
          f"row {name}: objective off the oracle by {row['oracle']['max_rel_obj_err']:.3g}")
    return row


def reach_args(rt, model, kind):
    from repro_torch.core import support

    return dict(directions=support.template_directions(model.dim, kind),
                options=rt.SolveOptions(backend="cuda-shared"), use_hyperbox=False,
                warm_start=True)


def reach_row(rt, *, name, model, kind, steps, counters, plain_pivots, hyperbox_ref, reruns):
    """The paper's reachability run on the revised kernel's warm sweep.

    ``hyperbox_ref`` is the ``use_hyperbox=True`` run's supports, computed
    before the launch counts were set to 0.  Appends the same call to
    ``reruns``, as :func:`shared_row` does.
    """
    from repro_torch.core import reach

    kw = reach_args(rt, model, kind)
    stats = rt.SolveStats()
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup, _ = reach.reach_supports(model, 0.02, steps, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    point = bool(np.array_equal(model.u.lo, model.u.hi))
    n_lps = reach.count_lps(steps, len(kw["directions"]), point)
    rel = float((np.abs(sup - hyperbox_ref) / np.maximum(1.0, np.abs(hyperbox_ref))).max())
    row = dict(row=name, steps=steps, directions=len(kw["directions"]), template=kind,
               lps=n_lps, lps_counted_by_stats=stats.lps, wall_s=wall, lps_per_s=n_lps / wall,
               launches=delta, pivots=stats.simplex_iterations,
               plain_sweep_pivots=plain_pivots, warm_started=stats.warm_started,
               max_rel_diff_from_hyperbox=rel, finite=bool(np.isfinite(sup).all()))
    emit("main_path", **row)
    reruns.append((name, n_lps, lambda: reach.reach_supports(model, 0.02, steps, **kw)))
    check(delta["revised"] == 1 and delta["hyperbox"] > 0,
          f"row {name} did not launch the revised kernel once (the sweep) and the hyperbox "
          f"kernel: {delta}")
    check(stats.simplex_iterations == plain_pivots,
          f"row {name}: {stats.simplex_iterations} pivots, the plain sweep {plain_pivots}")
    check(row["finite"] and rel <= 1e-5, f"row {name}: supports off the hyperbox path by {rel:.3g}")
    return row


def repeat_rows(reruns, reps):
    """Wall time of each row's call, ``reps`` more times, after the counted run."""
    for name, lps, fn in reruns:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        emit("main_path_repeats", row=name, reps=reps, wall_s=walls, median_wall_s=med,
             min_wall_s=min(walls), max_wall_s=max(walls), median_lps_per_s=lps / med)


def hetero_problems(rt, seed, per_class):
    """Single-LP problems of shape classes 5, 28 and 100, and their host data."""
    from repro_torch.core.lp import random_lp_batch

    rng = np.random.default_rng(seed)
    problems, host = [], []
    for m, n in [(5, 5), (28, 28), (100, 100)]:
        part = random_lp_batch(rng, per_class, m, n, True, dtype=np.float32, device="cpu")
        for i in range(per_class):
            a, b, c = (t[i].numpy() for t in (part.a, part.b, part.c))
            host.append((a, b, c))
            problems.append(rt.LPProblem.make(c, a, bu=b))
    return problems, host


def hetero_row(rt, *, seed, counters, per_class):
    from repro_torch.core import oracle

    problems, host = hetero_problems(rt, seed, per_class)
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = rt.solve(problems)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = np.array([int(s.status[0]) for s in sols])
    obj = np.array([float(s.objective[0]) for s in sols])
    agree, errs = [], []
    for (a, b, c), st, ob in zip(host, status, obj):
        o_obj, _, o_st, _ = oracle.solve_lp(a, b, c)
        agree.append(st == o_st)
        if st == 1 and o_st == 1:
            errs.append(abs(ob - o_obj) / max(1.0, abs(o_obj)))
    row = dict(row="heterogeneous_list", problems=len(problems), shape_classes=[5, 28, 100],
               wall_s=wall, launches=delta,
               status_counts=np.bincount(status, minlength=6).tolist(),
               oracle=dict(status_agreement=float(np.mean(agree)),
                           max_rel_obj_err=float(max(errs) if errs else 0.0)))
    emit("main_path", **row)
    check(delta["simplex"] == 3, f"heterogeneous list launched {delta} (one per bucket expected)")
    check(row["oracle"]["status_agreement"] >= 0.99, "heterogeneous list: statuses off the oracle")
    check(row["oracle"]["max_rel_obj_err"] <= 1e-4, "heterogeneous list: objectives off the oracle")
    return row


def highs_compare(status, objective, highs, rtol):
    """Statuses on the rows a solver decides, and OPTIMAL objectives, against HiGHS."""
    h_status = np.array([h[0] for h in highs])
    h_obj = np.array([h[1] for h in highs])
    st = status[: len(highs)]
    obj = objective[: len(highs)].astype(np.float64)
    decided = st != 4
    both = (st == 1) & (h_status == 1)
    rel = np.abs(obj[both] - h_obj[both]) / np.maximum(1.0, np.abs(h_obj[both]))
    out = dict(sample=len(highs), decided=int(decided.sum()),
               status_agreement_on_decided=float((st[decided] == h_status[decided]).mean())
               if decided.any() else 1.0,
               highs_status_counts=np.bincount(h_status, minlength=6).tolist(),
               max_rel_obj_err=float(rel.max()) if rel.size else 0.0, rtol=rtol)
    return out


class Spans:
    """Host-clock seconds spent in named module functions during a call.

    Wraps each ``(module, name)`` for the duration of a ``with`` block;
    each wrapped call ends in ``torch.cuda.synchronize()``.  ``calls``
    counts the wrapped calls, so that a caller that reaches a function
    another way shows as a span never entered.
    """

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {name: 0.0 for _, name in targets}
        self.calls = {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _timed(self, name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return call


def pdhg_row(rt, *, name, batch, options, counters, highs, rtol, base_iters=None):
    """The slice-3 batch through ``repro_torch.solve`` on the first-order path.

    ``spans_s`` splits the wall time: the kernel launch with its step
    sizes (``ops.pdhg_solve``), the oracle's confirmation of the flagged
    rows and the crossover polish.
    """
    from repro_torch.core import pdhg
    from repro_torch.kernels import ops

    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Spans([(ops, "pdhg_solve"), (pdhg, "confirm_certificates"), (pdhg, "crossover")]) as sp, \
            ConfirmRecorder() as confirm:
        t0 = time.perf_counter()
        sol = rt.solve(batch, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy().astype(np.int64)
    bsz = batch.batch
    row = dict(row=name, lps=bsz, m=batch.m, n=batch.n, dtype=str(batch.a.dtype),
               backend=options.backend, crossover=options.crossover, wall_s=wall,
               lps_per_s=bsz / wall, launches=delta, total_iterations=int(iters.sum()),
               max_iterations=int(iters.max()),
               status_counts=np.bincount(status, minlength=6).tolist(),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               finite_objective_share=float(np.isfinite(sol.objective.cpu().numpy()).mean()),
               spans_s=sp.seconds, span_calls=sp.calls, cpu_count=os.cpu_count(),
               confirm_flagged=[c["rows"] for c in confirm.calls],
               confirm_workers=[c["workers"] for c in confirm.calls],
               highs=highs_compare(status, sol.objective.cpu().numpy(), highs, rtol))
    if base_iters is not None:
        polish = iters - base_iters
        row.update(polish_pivots=int(polish.sum()), max_polish_pivots=int(polish.max()),
                   polished_with_0_pivots=int(((polish == 0) & (status == 1)).sum()))
    emit("main_path", **row)
    check(tuple(sol.x.shape) == (bsz, batch.n), f"row {name}: x has shape {tuple(sol.x.shape)}")
    want = {"pdhg_solve": 1, "confirm_certificates": 1, "crossover": int(options.crossover)}
    check(sp.calls == want, f"row {name}: spans entered {sp.calls}, expected {want}")
    h = row["highs"]
    check(h["status_agreement_on_decided"] == 1.0, f"row {name}: statuses off HiGHS: {h}")
    check(h["max_rel_obj_err"] <= rtol, f"row {name}: objectives off HiGHS: {h}")
    return row, sol, confirm.calls


class ConfirmRecorder:
    """Records each call of ``core/pdhg.py:oracle_statuses`` (the confirmation's
    oracle solves on host threads): its inputs, workers, seconds and result."""

    def __init__(self):
        from repro_torch.core import pdhg

        self.pdhg = pdhg
        self.calls = []

    def __enter__(self):
        self.real = self.pdhg.oracle_statuses

        def recording(a, b, c, max_iters, workers=1):
            t0 = time.perf_counter()
            out = self.real(a, b, c, max_iters, workers)
            self.calls.append(dict(a=a, b=b, c=c, max_iters=max_iters, workers=workers,
                                   rows=int(a.shape[0]), seconds=time.perf_counter() - t0,
                                   status=out))
            return out

        self.pdhg.oracle_statuses = recording
        return self

    def __exit__(self, *exc):
        self.pdhg.oracle_statuses = self.real


def confirmation_case(calls, row):
    """The slice-3 row's confirmation on host threads beside the same flagged
    rows confirmed sequentially, once, in this run: the same statuses."""
    from repro_torch.core import pdhg

    check(len(calls) == 1, f"{row}: {len(calls)} confirmation calls")
    call = calls[0]
    t0 = time.perf_counter()
    seq = pdhg.oracle_statuses(call["a"], call["b"], call["c"], call["max_iters"], workers=1)
    seq_s = time.perf_counter() - t0
    same = bool(np.array_equal(seq, call["status"]))
    emit("confirmation", row=row, flagged=call["rows"], workers=call["workers"],
         cpu_count=os.cpu_count(), parallel_s=call["seconds"], sequential_s=seq_s,
         statuses=np.bincount(seq, minlength=6).tolist(), statuses_equal=same)
    check(same, f"{row}: the parallel confirmation's statuses differ from the sequential ones")


def auto_list_row(rt, dev, *, seed, counters, per_class):
    """64 LPs of 100x100 and 64 of 500x500 in one list through ``"auto"``."""
    from repro_torch.core import oracle
    from repro_torch.core.lp import random_lp_batch

    rng = np.random.default_rng(seed)
    problems, host = [], []
    for dim in (100, PDHG_DIM):
        part = random_lp_batch(rng, per_class, dim, dim, True, dtype=np.float32, device="cpu")
        for i in range(per_class):
            a, b, c = (t[i] for t in (part.a, part.b, part.c))
            host.append((a.numpy(), b.numpy(), c.numpy()))
            problems.append(rt.LPProblem.make(c, a, bu=b, device=dev))
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = rt.solve(problems, rt.SolveOptions(backend="auto"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = np.array([int(s.status[0]) for s in sols])
    obj = np.array([float(s.objective[0]) for s in sols])
    small = slice(0, per_class)
    agree, errs = [], []
    for (a, b, c), st, ob in zip(host[small], status[small], obj[small]):
        o_obj, _, o_st, _ = oracle.solve_lp(a, b, c)
        agree.append(st == o_st)
        if st == 1 and o_st == 1:
            errs.append(abs(ob - o_obj) / max(1.0, abs(o_obj)))
    large = status[per_class:]
    row = dict(row="auto_list", problems=len(problems), shape_classes=[100, PDHG_DIM],
               wall_s=wall, launches=delta, status_counts=np.bincount(status, minlength=6).tolist(),
               oracle_100=dict(status_agreement=float(np.mean(agree)),
                               max_rel_obj_err=float(max(errs) if errs else 0.0)),
               large_decided_optimal=bool(np.all(large[large != 4] == 1)),
               large_finite_where_optimal=bool(np.isfinite(obj[per_class:][large == 1]).all()))
    emit("main_path", **row)
    check(delta["simplex"] > 0 and delta["pdhg"] > 0, f"auto_list launched {delta}")
    check(row["oracle_100"]["status_agreement"] >= 0.99, "auto_list: statuses off the oracle")
    check(row["oracle_100"]["max_rel_obj_err"] <= 1e-4, "auto_list: objectives off the oracle")
    check(row["large_decided_optimal"] and row["large_finite_where_optimal"],
          "auto_list: a 500x500 LP that PDHG decides is not OPTIMAL")
    return row


def frontier_row(rt, *, batch, pdhg_row_, highs, raw_status):
    """The slice-3 batch on the simplex kernel, beside the PDHG row.

    ``raw_status`` is the PDHG kernel's status before confirmation
    (phase 3): its UNBOUNDED flags are set beside the simplex kernel's
    UNBOUNDED rows.
    """
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(batch, rt.SolveOptions(backend="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy().astype(np.int64)
    row = dict(row=f"frontier_simplex_{PDHG_DIM}x{PDHG_DIM}", lps=batch.batch, backend="cuda",
               wall_s=wall, lps_per_s=batch.batch / wall, pivots=int(iters.sum()),
               max_pivots=int(iters.max()), status_counts=np.bincount(status, minlength=6).tolist(),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               pdhg_wall_s=pdhg_row_["wall_s"], pdhg_steps=pdhg_row_["total_iterations"],
               pdhg_raw_unbounded=int((raw_status == 2).sum()),
               simplex_unbounded=int((status == 2).sum()),
               both_unbounded=int(((raw_status == 2) & (status == 2)).sum()),
               highs=highs_compare(status, sol.objective.cpu().numpy(), highs, 1e-4))
    emit("frontier", **row)
    return row


def crossover_tiles(*, batch, sol, small):
    """The crossover polish's wall time at the reference's tile (8) and the port's.

    On the whole slice-3 batch and on a batch of its first ``small``
    OPTIMAL rows, where the port's tile polishes replicas.
    """
    import dataclasses

    from repro_torch.core import pdhg

    rows = (sol.status == 1).nonzero().flatten()
    few = rows[:small]
    sub = dataclasses.replace(sol, **{f: getattr(sol, f)[few] for f in
                                      ("objective", "x", "status", "iterations", "y")})
    out = {}
    for label, (bt, st, n_opt) in {"batch": (batch, sol, rows.numel()),
                                   f"first_{small}_optimal": (batch.take(few), sub, small)}.items():
        polished = {}
        for tile in (8, pdhg.CROSSOVER_TILE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pol = pdhg.crossover(bt, st, tile=tile)
            torch.cuda.synchronize()
            polished[tile] = pol
            out[f"{label}_tile_{tile}"] = dict(
                wall_s=time.perf_counter() - t0, launches=-(-n_opt // tile), polished=n_opt,
                pivots=int((pol.iterations - st.iterations).to(torch.int64).sum()))
        lo, hi = polished[8], polished[pdhg.CROSSOVER_TILE]
        both = (lo.status == 1) & (hi.status == 1)
        rel = ((lo.objective - hi.objective).abs() / hi.objective.abs().clamp(min=1.0))[both]
        out[f"{label}_max_rel_obj_diff_8_vs_{pdhg.CROSSOVER_TILE}"] = \
            float(rel.max()) if rel.numel() else 0.0
    emit("crossover_tiles", **out)
    return out


# ---------------------------------------------------------------------------
# the rounds phase: compaction, basis resume, guardrails, sessions, sweeps
# ---------------------------------------------------------------------------


class RoundSizes:
    """Records the batch size of every dispatch round of ``core/dispatch.py``,
    and the set of the rounds' ``(m, n)``."""

    def __init__(self):
        from repro_torch.core import dispatch

        self.dispatch = dispatch
        self.real = dispatch.dispatch_round
        self.sizes = []
        self.shapes = set()

    def __enter__(self):
        def recording(batch, options, stats=None, state=None, want_state=False):
            self.sizes.append(batch.batch)
            self.shapes.add((batch.m, batch.n))
            return self.real(batch, options, stats, state=state, want_state=want_state)

        self.dispatch.dispatch_round = recording
        return self

    def __exit__(self, *exc):
        self.dispatch.dispatch_round = self.real


def timed_solve(rt, problem, options, stats=None):
    """``rt.solve`` with its wall ms and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(problem, options, stats=stats)
    torch.cuda.synchronize()
    return sol, (time.perf_counter() - t0) * 1e3, int(torch.cuda.max_memory_allocated())


def rounds_case(rt, *, name, problem, base, modes, counters, kernel, variant, fields):
    """Compaction ``"off"`` and each ``(mode, resume)`` on the same LPs, in one call.

    Every compacted result must equal ``"off"`` bit for bit in ``fields``,
    and every round must be one launch of ``kernel``'s ``variant``.
    """
    rows = {}
    off = None
    for mode, resume in [("off", "scratch")] + list(modes):
        stats = rt.SolveStats()
        before = launch_counts(counters)
        with RoundSizes() as rec:
            sol, wall_ms, peak = timed_solve(rt, problem, base.replace(compaction=mode,
                                                                       resume=resume), stats)
        delta = count_delta(counters, before)
        key = f"{mode}+{resume}" if mode != "off" else "off"
        row = dict(case=name, mode=mode, resume=resume, compact_every=base.compact_every,
                   rounds=len(rec.sizes), survivors=rec.sizes, wall_ms=wall_ms,
                   max_memory_allocated=peak, launches=delta,
                   simplex_iterations=stats.simplex_iterations,
                   lockstep_iterations=stats.lockstep_iterations, resumed=stats.resumed,
                   status_counts=np.bincount(sol.status.cpu().numpy(), minlength=6).tolist())
        check(delta[kernel] == len(rec.sizes) and delta[f"{kernel}.{variant}"] == delta[kernel],
              f"rounds {name} {key}: {delta} launches for {len(rec.sizes)} rounds "
              f"(each round one {variant} {kernel} launch expected)")
        if off is None:
            off = (sol, row)
        else:
            same = {f: torch.equal(bits(getattr(sol, f)), bits(getattr(off[0], f)))
                    for f in fields}
            row.update(bit_equal_to_off=same, lockstep_vs_off=[row["lockstep_iterations"],
                                                               off[1]["lockstep_iterations"]])
            check(all(same.values()), f"rounds {name} {key} differ from compaction='off': {same}")
            check(len(rec.sizes) > 1, f"rounds {name} {key} ran one round only")
        emit("rounds", **row)
        rows[key] = row
    return off[0], rows


def guardrail_cases(rt, *, name, problem, off, counters, poison_lps, k):
    """Type 1 with the guardrails on and off (bit-equal, timed), then a NaN
    written into one carried row of a basis-resume state on the card."""
    from repro_torch.core import dispatch

    times = {True: [], False: []}
    for flag in (True, False, True, False):
        sol, wall_ms, _ = timed_solve(rt, problem, rt.SolveOptions(guardrails=flag))
        times[flag].append(wall_ms)
        for f in ("status", "iterations", "basis", "objective", "x"):
            check(torch.equal(bits(getattr(sol, f)), bits(getattr(off, f))),
                  f"guardrails={flag} changed {f} on a healthy batch")
        del sol
    emit("guardrails", case=name, on_ms=times[True], off_ms=times[False],
         cost_ms=min(times[True]) - min(times[False]), bit_equal=True)

    sub = problem.take(slice(0, poison_lps))
    survivors = (off.iterations[:poison_lps] > k).nonzero().flatten()
    check(survivors.numel() > 0, f"no LP of {name}'s first {poison_lps} survives round 0")
    row = int(survivors[0])
    real = dispatch.dispatch_round

    def poisoning(batch, options, stats=None, state=None, want_state=False):
        sol, out = real(batch, options, stats, state=state, want_state=want_state)
        if out is not None and state is None:
            out.tab[row, 0, 0] = float("nan")  # round 0's carried tableau
        return sol, out

    opts = rt.SolveOptions(compaction="every_k", compact_every=k, resume="basis")
    dispatch.dispatch_round = poisoning
    try:
        flagged = rt.solve(sub, opts)
        qstats = rt.SolveStats()
        fixed = rt.solve(sub, opts.replace(quarantine=True), stats=qstats)
    finally:
        dispatch.dispatch_round = real
    rest = torch.arange(poison_lps, device=off.status.device) != row
    same = {f: torch.equal(bits(getattr(flagged, f)[rest]),
                           bits(getattr(off, f)[:poison_lps][rest]))
            for f in ("status", "iterations", "objective", "x")}
    ref_obj = float(off.objective[row])
    rel = abs(float(fixed.objective[row]) - ref_obj) / max(1.0, abs(ref_obj))
    out = dict(case=f"{name}_first_{poison_lps}", row=row,
               poisoned_status=int(flagged.status[row]), others_bit_equal=same, quarantined=qstats.quarantined,
               resolved_status=int(fixed.status[row]), off_status=int(off.status[row]),
               resolved_rel_obj_err=rel)
    emit("poisoned_row", **out)
    check(out["poisoned_status"] == rt.NUMERICAL, "the poisoned row did not retire NUMERICAL")
    check(all(same.values()), f"rows beside the poisoned one changed: {same}")
    check(qstats.quarantined == 1 and out["resolved_status"] == out["off_status"]
          and rel <= 1e-4, f"the quarantine did not resolve the poisoned row: {out}")


def session_case(rt, dev, *, problem, calls=3):
    """``SolveSession`` calls at one shape: ``compiles`` must stop moving after the first."""
    sess = rt.SolveSession(rt.SolveOptions(), device=dev)
    seen = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.solve(problem)
        torch.cuda.synchronize()
        seen.append(dict(compiles=sess.stats.compiles, cache_hits=sess.stats.cache_hits,
                         wall_ms=(time.perf_counter() - t0) * 1e3))
    emit("sessions", shape=[problem.m, problem.n], lps=problem.batch, calls=seen)
    check(all(c["compiles"] == seen[0]["compiles"] for c in seen),
          f"session compiles moved after the first call: {seen}")


def dense_sweep_case(rt, dev, *, name, model, kind, steps, counters):
    """The reach model's X0 supports as the dense warm sweep: ``sweep_problems``
    (one simplex launch a step, read back once) against the per-step loop."""
    from repro_torch.core import reach, support

    dirs = support.template_directions(model.dim, kind)
    stack = reach.direction_stack(model, 0.02, steps, dirs).astype(np.float32)
    poly = support.box_to_polytope(model.x0)
    opts = rt.SolveOptions()
    out = {}
    for how, fn in (("sweep_problems", poly.support_sweep), ("per_step_loop", poly.step_sweep)):
        fn(stack, opts, device=dev)  # warm-up: the first call pays the library load
        before = launch_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup = fn(stack, opts, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        delta = count_delta(counters, before)
        stats = rt.SolveStats()
        fn(stack, opts, stats=stats, device=dev)
        out[how] = dict(support=sup, wall_ms=wall_ms, launches=delta,
                        pivots=stats.simplex_iterations, warm_started=stats.warm_started)
    same = torch.equal(bits(out["sweep_problems"]["support"]),
                       bits(out["per_step_loop"]["support"]))
    row = dict(case=name, steps=steps, directions=len(dirs), supports_bit_equal=same,
               **{f"{h}_{k}": v[k] for h, v in out.items()
                  for k in ("wall_ms", "pivots", "warm_started", "launches")})
    emit("dense_sweep", **row)
    check(same, f"dense sweep {name}: sweep_problems and the per-step loop differ")
    check(row["sweep_problems_pivots"] == row["per_step_loop_pivots"],
          f"dense sweep {name}: pivots differ")
    check(out["sweep_problems"]["launches"]["simplex"] == steps,
          f"dense sweep {name}: {out['sweep_problems']['launches']} for {steps} steps")


# ---------------------------------------------------------------------------
# the serve phase (slice 7): the LP serve loop, faults, speculation
# ---------------------------------------------------------------------------


class FaultWatch:
    """Counts the dispatch rounds that raised, for the whole run.

    Every retry follows a round that raised, so a phase that is not a
    fault case must leave the count where it found it: no clean phase
    leans on recovery.
    """

    def __init__(self):
        from repro_torch.core import dispatch

        self.dispatch = dispatch
        self.real = dispatch.dispatch_round
        self.raised = 0

    def __enter__(self):
        def watched(*args, **kw):
            try:
                return self.real(*args, **kw)
            except Exception:
                self.raised += 1
                raise

        self.dispatch.dispatch_round = watched
        return self

    def __exit__(self, *exc):
        self.dispatch.dispatch_round = self.real


def check_clean(eng, where):
    """A clean serve phase: no retry, no dead letter."""
    st = eng.stats
    check(st.retries == 0 and st.dead_lettered == 0 and eng.dead_letters == [],
          f"{where}: the clean phase leaned on recovery (retries {st.retries}, "
          f"dead-lettered {st.dead_lettered})")


def serve_requests(rt):
    """The serve traffic: SERVE_REQUESTS LPs of ``lp_request_mix([(28, 28),
    (100, 100)], seed=11)`` in float32, and SERVE_BOXES boxlike requests of
    n = SERVE_BOX_N, one after every SERVE_REQUESTS / SERVE_BOXES LPs.  The
    requests arrive on the host; the engine moves each admitted wave."""
    from repro_torch.core.lp import random_hyperbox_batch
    from repro_torch.serve.loadgen import lp_request_mix

    make = lp_request_mix([(28, 28), (100, 100)], seed=11, device="cpu")
    lo, hi, d = random_hyperbox_batch(np.random.default_rng(12), SERVE_BOXES, SERVE_BOX_N,
                                      device="cpu")
    every = SERVE_REQUESTS // SERVE_BOXES
    out = []
    for k in range(SERVE_BOXES):
        out += [make(i) for i in range(k * every, (k + 1) * every)]
        out.append(rt.LPProblem.make(d[k], lo=lo[k], hi=hi[k], device="cpu"))
    return out


def same_solutions(sols, refs) -> dict:
    """Per field, whether every request's solution equals the reference's bit for bit."""
    out = {}
    for f in ("objective", "status", "iterations"):
        out[f] = torch.equal(bits(torch.cat([getattr(s, f) for s in sols])),
                             bits(torch.cat([getattr(r, f) for r in refs])))
    by_width = {}
    for s, r in zip(sols, refs):
        by_width.setdefault(s.x.shape[-1], ([], []))
        by_width[s.x.shape[-1]][0].append(s.x)
        by_width[s.x.shape[-1]][1].append(r.x)
    out["x"] = all(torch.equal(bits(torch.cat(a)), bits(torch.cat(b)))
                   for a, b in by_width.values())
    return out


def drain(eng, problems):
    """Submit ``problems`` at once and step the engine until it is empty."""
    tickets = [eng.submit(p) for p in problems]
    while eng.pending_count or eng.inflight_count:
        eng.step()
    return [eng.result(t) for t in tickets]


def serve_mode_case(rt, dev, *, mode, problems, trace, oneshot, counters, engine_kw, warm):
    """One serve mode replayed open-loop on ``trace`` after a warm-up."""
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import replay

    eng = LPEngine(rt.SolveOptions(), device=dev, **engine_kw)
    if mode == "continuous":
        drain(eng, warm)
    else:
        tickets = [eng.submit(p) for p in warm]
        eng.flush()
        for t in tickets:
            eng.result(t)
    compiles0, spliced0, resumed0 = eng.stats.compiles, eng.stats.spliced, eng.stats.resumed
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = replay(eng, trace, mode=mode)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    delta = count_delta(counters, before)
    same = same_solutions(res.solutions, oneshot)
    lat_ms = res.latencies * 1e3
    row = dict(requests=len(trace), offered_per_s=len(trace) / trace[-1].t,
               p50_ms=float(np.percentile(lat_ms, 50)), p99_ms=float(np.percentile(lat_ms, 99)),
               throughput_per_s=len(trace) / res.makespan, makespan_s=res.makespan,
               wall_ms=wall_ms, spliced=eng.stats.spliced - spliced0,
               resumed=eng.stats.resumed - resumed0, steady_compiles=eng.stats.compiles - compiles0,
               steps=eng._step_count, launches=delta, bit_equal_to_oneshot=same,
               status_counts=np.bincount(torch.cat([s.status for s in res.solutions]).cpu().numpy(),
                                         minlength=6).tolist(),
               retries=eng.stats.retries, dead_lettered=eng.stats.dead_lettered, **engine_kw)
    emit(f"serve_{mode}", **row)
    check(all(same.values()), f"serve_{mode}: requests differ from the one-shot solve: {same}")
    check(row["steady_compiles"] == 0, f"serve_{mode}: {row['steady_compiles']} compiles after "
          "the warm-up")
    check_clean(eng, f"serve_{mode}")
    return row


def serve_class(problems, dev):
    """The stacked problem of one serve-loop wave on ``dev``: each request
    padded to its shape class (``core/bucketing.py:shape_class``), as
    ``LPEngine._admit`` pads it, and stacked (one class, one dtype and one
    set of flags)."""
    from repro_torch.core.bucketing import shape_class
    from repro_torch.core.problem import stack_problems

    cm, cn = shape_class(problems[0].m, problems[0].n)
    p = stack_problems([p.pad_to(cm, cn) for p in problems])
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).to(dev)
                                     for f in dataclasses.fields(p)
                                     if isinstance(getattr(p, f.name), torch.Tensor)})


def serve_kernel_cases(rt, dev, timer, *, problems, pdhg_batch, lps=64):
    """The kernels of the serve path against their plain versions at the
    shapes the serve loop launches them: the PDHG kernel on the 512x512
    canonical class of ``lps`` of the slice-3 LPs (cap 400, as
    ``serve_pdhg`` solves them), and the hyperbox kernel on the boxlike
    requests padded to their class width.  Returns the PDHG row (its
    ``variant`` and ``k``)."""
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.problem import canonicalize

    reqs = [rt.LPProblem.from_batch(pdhg_batch.take(slice(i, i + 1))) for i in range(lps)]
    cb = canonicalize(serve_class(reqs, dev)).batch
    row, *_ = pdhg_case(timer, name=f"serve_class_{lps}x{cb.m}x{cb.n}_f32_cap400",
                        batch=LPBatch(cb.a, cb.b, cb.c), cap=400, full=False, reps=3,
                        want="cluster")
    boxes = serve_class([p for p in problems if p.boxlike], dev)
    hyperbox_case(dev, timer, name=f"serve_class_{boxes.batch}x{boxes.n}_f32_box",
                  bsz=boxes.batch, n=boxes.n, dtype=torch.float32, data_seed=None,
                  data=(boxes.lo.contiguous(), boxes.hi.contiguous(), boxes.c.contiguous()))
    return row


def serve_pdhg_case(rt, dev, *, batch, counters, plan_row, per_step=16, step_iters=100):
    """LPs of the slice-3 batch as requests on ``"auto"`` (cap 400), admitted
    ``per_step`` a round, so each resume round's batch differs in size.
    ``plan_row`` is the kernel case of the same class: the engine's rounds
    must take its variant and ``k``."""
    from repro_torch.kernels import pdhg_cuda
    from repro_torch.serve.engine import LPEngine

    opts = rt.SolveOptions(backend="auto", max_iters=400)
    problems = [rt.LPProblem.from_batch(batch.take(slice(i, i + 1))) for i in range(batch.batch)]
    oneshot = rt.SolveSession(opts, device=dev).solve(problems)
    eng = LPEngine(opts, device=dev, flush_every=1 << 30, step_iters=step_iters)
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets, done = [], {}
    with RoundSizes() as rec:
        for lo in range(0, len(problems), per_step):
            tickets += [eng.submit(p) for p in problems[lo:lo + per_step]]
            for t in eng.step():
                done[t] = eng.result(t)
        while len(done) < len(problems):
            for t in eng.step():
                done[t] = eng.result(t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    delta = count_delta(counters, before)
    sols = [done[t] for t in tickets]
    same = same_solutions(sols, oneshot)
    (cm, cn), = rec.shapes
    how = pdhg_cuda.plan(cm, cn, batch.a.dtype, batch.a.device)
    row = dict(requests=len(problems), shape=[batch.m, batch.n],
               class_shape=[cm, cn], variant=how.variant, k=how.k,
               max_iters=400, step_iters=step_iters, admitted_per_step=per_step,
               round_batches=rec.sizes,
               wall_ms=wall_ms, spliced=eng.stats.spliced, resumed=eng.stats.resumed,
               launches=delta, bit_equal_to_oneshot=same,
               status_counts=np.bincount(torch.cat([s.status for s in sols]).cpu().numpy(),
                                         minlength=6).tolist())
    emit("serve_pdhg", **row)
    check(all(same.values()), f"serve_pdhg: requests differ from the one-shot solve: {same}")
    check(delta["pdhg"] == len(rec.sizes) and delta["simplex"] == 0,
          f"serve_pdhg: {delta} launches for {len(rec.sizes)} rounds")
    check(delta["pdhg.cluster"] == delta["pdhg"] and how.variant == plan_row["variant"]
          and how.k == plan_row["k"] and [cm, cn] == [plan_row["m"], plan_row["n"]],
          f"serve_pdhg: rounds at class {row['class_shape']} took {how.variant} k={how.k} "
          f"({delta}), the kernel case {plan_row['variant']} k={plan_row['k']} at "
          f"{plan_row['m']}x{plan_row['n']}")
    check(len(set(rec.sizes)) > 1, f"serve_pdhg: every round had {rec.sizes[0]} rows")
    check_clean(eng, "serve_pdhg")
    return row


def faults_case(rt, dev, *, type1, shared1, lps=5000):
    """The recovery paths on the card: a failed round retried, a shard crash
    mid-round, a poisoned carried row in the serve loop, a group dead-lettered
    with ``retry_budget=0`` while the other completes, a shared-A retry."""
    from repro_torch.runtime import chaos
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import lp_request_mix

    fields = ("status", "iterations", "basis", "objective", "x")

    def equal(a, b, rows=slice(None), fs=fields):
        return all(torch.equal(bits(getattr(a, f)[rows]), bits(getattr(b, f)[rows])) for f in fs)

    out = {}
    sub = type1.take(slice(0, lps))
    clean = rt.solve(sub)
    for case, monkey, opts in [
            ("fail_round_0", chaos.ChaosMonkey(fail_rounds=[0], max_faults=1), rt.SolveOptions()),
            ("shard_crash_chunk_1250", chaos.ChaosMonkey(crash_rounds=[0], max_faults=1),
             rt.SolveOptions(chunk_size=1250))]:
        stats = rt.SolveStats()
        with chaos.inject(monkey):
            sol, wall_ms, _ = timed_solve(rt, sub, opts, stats)
        out[case] = dict(retries=stats.retries, faults_injected=stats.faults_injected,
                         wall_ms=wall_ms, bit_equal=equal(sol, clean))
        check(stats.retries == 1 and stats.faults_injected == 1 and out[case]["bit_equal"],
              f"faults {case}: {out[case]}")

    problems = [rt.LPProblem.from_batch(sub.take(slice(i, i + 1))) for i in range(256)]
    oneshot = rt.SolveSession(device=dev).solve(problems)
    eng = LPEngine(rt.SolveOptions(), device=dev, flush_every=1 << 30, step_iters=64)
    with chaos.inject(chaos.ChaosMonkey(poison_rows={0: [5]})) as mk:
        sols = drain(eng, problems)
    rest = [i for i in range(len(problems)) if i != 5]
    out["serve_poisoned_row"] = dict(
        rows_poisoned=mk.rows_poisoned, poisoned_status=int(sols[5].status[0]),
        others_bit_equal=all(same_solutions([sols[i] for i in rest],
                                            [oneshot[i] for i in rest]).values()),
        retries=eng.stats.retries, dead_lettered=eng.stats.dead_lettered)
    check(out["serve_poisoned_row"]["poisoned_status"] == rt.NUMERICAL and
          out["serve_poisoned_row"]["others_bit_equal"] and mk.rows_poisoned == 1,
          f"faults serve_poisoned_row: {out['serve_poisoned_row']}")

    make = lp_request_mix([(28, 28), (100, 100)], seed=13, device="cpu")
    problems = [make(i) for i in range(64)]
    oneshot = rt.SolveSession(device=dev).solve(problems)
    eng = LPEngine(rt.SolveOptions(retry_budget=0), device=dev, flush_every=1 << 30,
                   step_iters=64)
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=[0], max_faults=1)):
        tickets = [eng.submit(p) for p in problems]
        while eng.pending_count or eng.inflight_count:
            eng.step()
    sols = [eng.result(t) for t in tickets]
    dead = sorted(tickets.index(t) for t in eng.dead_letters)
    alive = [i for i in range(len(problems)) if i not in set(dead)]
    later = eng.result(eng.submit(make(64)))
    out["serve_dead_letter"] = dict(
        dead_lettered=eng.stats.dead_lettered, dead_shape=sorted({problems[i].m for i in dead}),
        dead_all_numerical=all(int(sols[i].status[0]) == rt.NUMERICAL for i in dead),
        others_bit_equal=all(same_solutions([sols[i] for i in alive],
                                            [oneshot[i] for i in alive]).values()),
        later_request_status=int(later.status[0]))
    check(len(dead) == len(problems) // 2 and out["serve_dead_letter"]["dead_all_numerical"]
          and out["serve_dead_letter"]["others_bit_equal"]
          and out["serve_dead_letter"]["later_request_status"] == rt.OPTIMAL,
          f"faults serve_dead_letter: {out['serve_dead_letter']}")

    ssub = shared1.take(slice(0, lps))
    sclean = rt.solve(ssub)
    stats = rt.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=[0], max_faults=1)):
        sol = rt.solve(ssub, stats=stats)
    out["shared_retry"] = dict(retries=stats.retries, bit_equal=equal(sol, sclean))
    check(stats.retries == 1 and out["shared_retry"]["bit_equal"],
          f"faults shared_retry: {out['shared_retry']}")
    emit("faults", lps=lps, **out)


def speculation_case(rt, *, batch, chunk):
    """``speculation=True`` against ``False`` on one batch in chunks: bit-equal,
    each timed, with the speculative re-dispatches of each run."""
    from repro_torch.runtime import straggler

    real = straggler.run_with_speculation
    reports = []

    def recording(*args, **kw):
        reports.append(real(*args, **kw))
        return reports[-1]

    runs = {False: [], True: []}
    ref = None
    straggler.run_with_speculation = recording
    try:
        for flag in (False, True, True, False):
            n = len(reports)
            sol, wall_ms, peak = timed_solve(rt, batch, rt.SolveOptions(chunk_size=chunk,
                                                                        speculation=flag))
            if ref is None:
                ref = sol
            same = all(torch.equal(bits(getattr(sol, f)), bits(getattr(ref, f)))
                       for f in ("status", "iterations", "basis", "objective", "x"))
            check(same, f"speculation={flag} differs from the serial chunk loop")
            check(len(reports) - n == int(flag), f"speculation={flag}: "
                  f"{len(reports) - n} speculative rounds")
            runs[flag].append(dict(wall_ms=wall_ms, max_memory_allocated=peak,
                                   respawned=reports[-1].respawned if flag else 0))
            del sol
    finally:
        straggler.run_with_speculation = real
    emit("speculation", lps=batch.batch, chunk_size=chunk, chunks=-(-batch.batch // chunk),
         off=runs[False], on=runs[True], bit_equal=True)



def a_lo_case(timer, dev, *, batches):
    """What the row-local ``A lo`` product of ``canonicalize`` costs at the
    paper's sizes: the whole ``canonicalize`` and the product alone, as
    shipped (``row_sum`` in blocks of ``A_LO_ROWS`` rows) and as a batched
    ``einsum``, each with the device memory it adds (CUDA events, median of
    three; the values do not change the work)."""
    from repro_torch.core import problem as tproblem
    from repro_torch.core.lp import row_sum

    def extra_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated() - base)

    rows = []
    for name, batch in batches:
        prob = tproblem.LPProblem.make(batch.c, batch.a, bu=batch.b, device=dev)
        lo = torch.rand(batch.c.shape, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=batch.a.dtype)
        blocks = tproblem.A_LO_ROWS

        def row_local():
            return torch.cat([row_sum(a * v[:, None, :]) for a, v in
                              zip(batch.a.split(blocks), lo.split(blocks))])

        def batched():
            return torch.einsum("bmn,bn->bm", batch.a, lo)

        check(torch.allclose(row_local(), batched(), rtol=1e-4, atol=1e-3),
              f"{name}: the row-local A lo product disagrees with einsum")
        rows.append(dict(
            name=name, lps=batch.batch, m=batch.m, n=batch.n, block_rows=blocks,
            canonicalize_ms=timer(lambda: tproblem.canonicalize(prob), reps=3),
            canonicalize_extra_bytes=extra_bytes(lambda: tproblem.canonicalize(prob)),
            row_sum_ms=timer(row_local, reps=3), row_sum_extra_bytes=extra_bytes(row_local),
            einsum_ms=timer(batched, reps=3), einsum_extra_bytes=extra_bytes(batched)))
        del prob, lo
    emit("a_lo", rows=rows)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the autotune phase (slice 8): predict, trial, the winner cache, the roofline
# ---------------------------------------------------------------------------

#: The main path's shape classes, ``(m, n, shared, batch)``, ranked by the
#: cost model: the slice-1 list buckets, the paper's types, the shared
#: types and the slice-3 batch.
PREDICT_CLASSES = [(5, 5, False, 4096), (28, 28, False, 4096), (100, 100, False, 50_000),
                   (200, 100, False, 10_000), (100, 100, True, 50_000),
                   (200, 100, True, 10_000), (500, 500, False, 256)]
#: The classes ``autotune.warm`` times, ``(m, n, batch)``; the last is the
#: class of the trial solve of type 1's first 5,000 LPs.
WARM_CLASSES = [(5, 5, 4096), (28, 28, 4096), (100, 100, 50_000), (200, 100, 10_000),
                (100, 100, 5_000)]
#: Bytes of the device-to-device copy the roofline line times.
COPY_BYTES = 4 << 30


def same_fields(a, b, fields=("status", "iterations", "objective")) -> dict:
    return {f: torch.equal(bits(getattr(a, f)), bits(getattr(b, f))) for f in fields}


def autotune_predict_case(rt, dev, *, part):
    """The predicted ranking of each main-path class, the choice held to the
    static table, and ``part`` solved under the default options (the tuner
    in ``"predict"`` mode) and under ``autotune="off"``: bit-equal."""
    from repro_torch.core import dispatch
    from repro_torch.runtime import autotune

    classes = []
    for m, n, shared, bsz in PREDICT_CLASSES:
        opts = rt.SolveOptions(backend="auto")
        ranked = autotune.rank_candidates(m, n, bsz, torch.float32, opts, shared=shared,
                                          device=dev)
        kw = dict(dtype=torch.float32, batch=bsz, device=dev)
        tuned = dispatch.resolve_backend(opts, shared, (m, n), **kw)
        static = dispatch.resolve_backend(opts.replace(autotune="off"), shared, (m, n), **kw)
        check((tuned.backend, tuned.effective_layout) == (static.backend,
                                                          static.effective_layout),
              f"autotune predict chose {tuned.backend}/{tuned.layout} at {m}x{n} "
              f"(shared={shared}); the static table says {static.backend}")
        choice = [tuned.backend, tuned.layout]
        classes.append(dict(m=m, n=n, shared=shared, batch=bsz, choice=choice,
                            ranking=[dict(backend=c.backend, layout=c.layout,
                                          predicted_s=c.predicted_s) for c in ranked]))
    stats = rt.SolveStats()
    tuned, tuned_ms, _ = timed_solve(rt, part, rt.SolveOptions(), stats=stats)
    off, off_ms, _ = timed_solve(rt, part, rt.SolveOptions(autotune="off"))
    same = same_fields(tuned, off)
    check(all(same.values()) and stats.autotuned == 1,
          f"the default (predict) solve differs from autotune='off': {same}, "
          f"autotuned={stats.autotuned}")
    emit("autotune_predict", classes=classes, lps=part.batch, bit_equal_to_off=same,
         autotuned=stats.autotuned, autotune_log=stats.autotune_log, wall_ms=tuned_ms,
         off_wall_ms=off_ms)
    return off


def autotune_trial_case(rt, dev, *, part, off):
    """``autotune.warm`` over :data:`WARM_CLASSES` with a cache file in a
    temporary directory (measured and predicted seconds a candidate), a warm
    process on the same file (0 trials), then a ``"trial"`` solve of
    ``part``: the cached winner, bit-equal to ``off``."""
    import tempfile

    from repro_torch.runtime import autotune

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        tuner = autotune.reset(cache_path=path)
        t0 = time.perf_counter()
        winners = autotune.warm(WARM_CLASSES, dtype=torch.float32, device=dev)
        warm_s = time.perf_counter() - t0
        check(tuner.trials_run > 0, "autotune.warm ran no trial on a cold cache")
        classes = [dict(m=m, n=n, batch=bsz, trial_batch=min(tuner.trial_batch, bsz),
                        winner=[w.backend, w.layout], source=w.source,
                        predicted_s=w.predicted_s, measured_s=w.measured_s,
                        candidates=[dict(backend=b, layout=lay, predicted_s=p, measured_s=t)
                                    for b, lay, p, t in w.trials])
                   for (m, n, bsz), w in zip(WARM_CLASSES, winners)]
        fresh = autotune.reset(cache_path=path)
        t0 = time.perf_counter()
        again = autotune.warm(WARM_CLASSES, dtype=torch.float32, device=dev)
        rewarm_s = time.perf_counter() - t0
        check(fresh.trials_run == 0 and all(a.source == "cache" for a in again) and
              [(a.backend, a.layout) for a in again] == [(w.backend, w.layout) for w in winners],
              f"a warm process re-tuned: {fresh.trials_run} trials")
        stats = rt.SolveStats()
        sol, wall_ms, _ = timed_solve(rt, part, rt.SolveOptions(backend="auto",
                                                                autotune="trial"), stats=stats)
        same = same_fields(sol, off)
        row = stats.autotune_log[0]
        check(fresh.trials_run == 0 and row["source"] == "cache",
              f"the trial solve did not take the cached winner: {row}")
        check(all(same.values()), f"the trial solve differs from autotune='off': {same}")
    autotune.reset()
    emit("autotune_trial", classes=classes, trials_run=tuner.trials_run, warm_s=warm_s,
         rewarm_trials_run=fresh.trials_run, rewarm_s=rewarm_s, trial_solve=dict(
             lps=part.batch, winner=[row["backend"], row["layout"]], source=row["source"],
             wall_ms=wall_ms, bit_equal_to_off=same))


def roofline_case(timer, dev):
    """The cost model's constants beside the card's name and power limit and a
    measured device-to-device copy of :data:`COPY_BYTES` (CUDA events; a
    measurement only, nothing is gated on it)."""
    from repro_torch.runtime import autotune, roofline

    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms = timer(lambda: dst.copy_(src), reps=5)
    moved = 2 * COPY_BYTES  # each byte read once and written once
    emit("roofline", nvidia_smi=smi_line(), hbm_bw=roofline.HBM_BW,
         peak_flops_fp32=roofline.PEAK_FLOPS, peak_flops_fp64=roofline.PEAK_FLOPS_FP64,
         machine_balance=roofline.MACHINE_BALANCE, launch_overhead_s=autotune.LAUNCH_OVERHEAD_S,
         host_op_s=autotune.HOST_OP_S, copy_bytes=COPY_BYTES, copy_ms=ms,
         copy_bytes_per_s=moved / (ms * 1e-3), copy_share_of_hbm_bw=moved / (ms * 1e-3)
         / roofline.HBM_BW)
    del src, dst
    torch.cuda.empty_cache()



# -- slice 9: the LM serve path (gemma2-2b at full width) ---------------------

#: The LM phase's config, and the committed reference fixture
#: (``tools/lm_reference_fixture.py``).
LM_ARCH = "gemma2-2b"
LM_FIXTURE = ROOT / "tests" / "data" / "lm_gemma2_2b_reference.npz"
#: ``lm_reference`` gates (float32 against the fixture), for every row
#: (prompt, step) on the stored vocabulary subset: max abs and relative L2
#: against the reference's float32 logits, each the larger of its floor
#: here and ``LM_NOISE_FACTOR`` times that row's float32 noise (the
#: reference's logits with every weight one ulp away); against the
#: reference's all-float64 logits, the larger of the floor and
#: ``LM_F64_FACTOR`` times the reference's own float32 error there; the
#: argmax wherever the fixture's top-2 margin exceeds ``LM_MARGIN``.  The
#: same run with TF32 products must fail the first gate.
LM_ABS_TOL = 5e-4
LM_REL_TOL = 1e-3
LM_NOISE_FACTOR = 4.0
LM_F64_FACTOR = 2.0
LM_MARGIN = 2e-3
#: ``lm_window``: prompts past the 4,096 window, decode steps, and the gate
#: of decode against the full forward.
LM_WINDOW_PROMPT = 4160
LM_WINDOW_STEPS = 32
LM_WINDOW_TOL = 1e-3
#: ``lm_serve`` (bfloat16): prompts, their length, greedy steps; the bf16
#: logits' relative L2 against the fixture may be at most this multiple of
#: the reference's own bf16-against-float32 error.
LM_SERVE_BATCH = 8
LM_SERVE_PROMPT = 4096
LM_SERVE_STEPS = 128
LM_BF16_FACTOR = 1.5
#: H100 SXM data sheet: bfloat16 dense tensor-core peak.
PEAK_FLOPS_BF16 = 989e12


def lm_fixture_logits(model, fixture) -> torch.Tensor:
    """The port's logits (B, steps + 1, V) on the fixture's tokens: prefill
    of the prompts, then one decode step a reference token."""
    tokens = torch.as_tensor(np.asarray(fixture["tokens"]), device=model.device)
    p, steps = int(fixture["prompt_len"]), int(fixture["steps"])
    cache = model.init_cache(tokens.shape[0], p + steps)
    logits, _ = model.prefill({"tokens": tokens[:, :p]}, cache)
    rows = [logits[:, -1]]
    for i in range(steps):
        logits, _ = model.decode_step({"tokens": tokens[:, p + i:p + i + 1]}, cache, p + i)
        rows.append(logits[:, -1])
    return torch.stack(rows, dim=1)


def lm_tolerances(fixture) -> dict:
    """``lm_reference``'s per-row gates for this fixture: (max abs, relative
    L2) against the reference's float32 logits and against its float64 ones."""
    return {
        "abs": np.maximum(LM_ABS_TOL, LM_NOISE_FACTOR * fixture["f32_noise_max_abs"]),
        "rel": np.maximum(LM_REL_TOL, LM_NOISE_FACTOR * fixture["f32_noise_rel_l2"]),
        "abs_f64": np.maximum(LM_ABS_TOL, LM_F64_FACTOR * fixture["f64_max_abs"]),
        "rel_f64": np.maximum(LM_REL_TOL, LM_F64_FACTOR * fixture["f64_rel_l2"]),
    }


def lm_f64_error(logits, fixture, tol) -> dict:
    """Logits (..., V) against the reference's all-float64 logits: the worst
    row's errors and the largest error over its row's tolerance."""
    got = logits.detach().double().cpu().numpy()[..., np.asarray(fixture["vocab_ids"])]
    want = np.asarray(fixture["logits_f64"], np.float64)
    abs_rows = np.abs(got - want).max(axis=-1)
    rel_rows = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    ratio = float(np.maximum(abs_rows / tol["abs_f64"], rel_rows / tol["rel_f64"]).max())
    return {"f64_max_abs_err": float(abs_rows.max()), "f64_rel_l2": float(rel_rows.max()),
            "f64_worst_ratio": ratio}


def lm_reference_case(model, fixture, phase="lm_reference") -> dict:
    """``lm_reference``: the float32 port against the reference's fixture;
    on the card, the same run with TF32 products as a control that the
    gate must reject.  ``phase`` names the line."""
    from repro_torch.models.convert import compare_to_summary

    tol = lm_tolerances(fixture)
    logits = lm_fixture_logits(model, fixture)
    res = compare_to_summary(logits, fixture, abs_tol=tol["abs"], rel_tol=tol["rel"],
                             margin=LM_MARGIN)
    res.update(lm_f64_error(logits, fixture, tol))
    res["ok"] = res["ok"] and res["f64_worst_ratio"] <= 1.0
    control = None
    if model.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = lm_fixture_logits(model, fixture)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        control = compare_to_summary(tf32, fixture, abs_tol=tol["abs"], rel_tol=tol["rel"],
                                     margin=LM_MARGIN)
        control.update(lm_f64_error(tf32, fixture, tol))
    emit(phase, arch=model.cfg.name, dtype=str(model.final_norm.dtype),
         tokens=list(np.asarray(fixture["tokens"]).shape), steps=int(fixture["steps"]),
         subset=int(np.asarray(fixture["vocab_ids"]).size),
         abs_tol=tol["abs"].tolist(), rel_tol=tol["rel"].tolist(),
         abs_tol_f64=tol["abs_f64"].tolist(), rel_tol_f64=tol["rel_f64"].tolist(),
         margin=LM_MARGIN, f32_noise_rel_l2=np.asarray(fixture["f32_noise_rel_l2"]).tolist(),
         reference_f32_vs_f64_rel_l2=np.asarray(fixture["f64_rel_l2"]).tolist(),
         tf32_control=control, **res)
    check(res["ok"], f"{phase}: the port differs from the reference's fixture: {res}")
    check(control is None or not control["ok"],
          f"{phase}: the gate passes the TF32 control too: {control}")
    return res


def lm_window_case(model, *, seed, prompt=LM_WINDOW_PROMPT, steps=LM_WINDOW_STEPS,
                   batch=2) -> dict:
    """``lm_window``: prefill past the sliding window, then decode steps fed
    the same tokens; each step's logits against the full forward's at that
    position, and the forward with every layer global against it (equal
    below the window, different from it on)."""
    from repro_torch.configs import Shape, make_inputs

    cfg = model.cfg
    dev = model.device
    tokens = make_inputs(cfg, Shape("lm_window", prompt + steps, batch, "prefill"), seed,
                         device=dev)["tokens"]
    t0 = time.perf_counter()
    cache = model.init_cache(batch, prompt + steps)
    logits, _ = model.prefill({"tokens": tokens[:, :prompt]}, cache)
    rows = [logits[:, 0]]
    for t in range(prompt, prompt + steps - 1):
        logits, _ = model.decode_step({"tokens": tokens[:, t:t + 1]}, cache, t)
        rows.append(logits[:, 0])
    decoded = torch.stack(rows, dim=1)
    idx = torch.arange(prompt - 1, prompt + steps - 1, device=dev)
    with torch.inference_mode():
        full = model.logits(model.forward({"tokens": tokens})[:, idx])
        windows = [layer.window for layer in model.layers]
        for layer in model.layers:
            layer.window = None
        try:
            glob = model.logits(model.forward({"tokens": tokens})[:, idx])
        finally:
            for layer, w in zip(model.layers, windows):
                layer.window = w
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    err = float((decoded - full).abs().max())
    past = idx >= cfg.sliding_window
    global_diff_past = float((glob[:, past] - full[:, past]).abs().max()) if past.any() else 0.0
    global_diff_before = (float((glob[:, ~past] - full[:, ~past]).abs().max())
                          if (~past).any() else 0.0)
    res = dict(decode_vs_forward_max_abs=err, tol=LM_WINDOW_TOL,
               global_vs_local_past_window_max_abs=global_diff_past,
               global_vs_local_before_window_max_abs=global_diff_before)
    emit("lm_window", arch=cfg.name, window=cfg.sliding_window, prompt=prompt, steps=steps,
         batch=batch, positions=[int(idx[0]), int(idx[-1])], wall_s=wall, **res)
    check(err <= LM_WINDOW_TOL, f"lm_window: decode differs from the full forward by {err}")
    check(global_diff_past > 10 * LM_WINDOW_TOL,
          f"lm_window: the local windows change nothing past the window: {res}")
    return res


def lm_param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def lm_keys(windows, q) -> int:
    """Keys the query at position ``q`` attends, summed over the layers."""
    return sum(min(q + 1, w) if w else q + 1 for w in windows)


def lm_prefill_flops(model, batch, s) -> float:
    """Matrix-product and attention FLOPs a prefill needs: the layers'
    projections for every token, causal (and windowed) scores and PV, and
    the unembedding of the last position."""
    cfg, windows = model.cfg, model.windows()
    d = cfg.d_model
    linear = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d + 3 * d * cfg.d_ff
    keys = sum(lm_keys(windows, q) for q in range(s))
    return (2.0 * batch * s * linear * cfg.num_layers
            + 4.0 * batch * cfg.num_heads * cfg.head_dim * keys
            + 2.0 * batch * d * cfg.padded_vocab)


def lm_decode_kv_bytes(model, batch, index, item) -> int:
    """K and V bytes a decode step at ``index`` reads (the slots it attends)."""
    cfg = model.cfg
    return 2 * batch * cfg.num_kv_heads * cfg.head_dim * lm_keys(model.windows(), index) * item


def timed_generate(engine, model, tokens, steps):
    """``engine.generate`` greedy, with a CUDA event recorded as the prefill
    and each decode step return and the peak memory counter reset first.
    Returns (tokens, wall s, prefill ms, decode ms a step, each call's
    last logits)."""
    events, rows = [], []

    def mark():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def timed(call):
        """``call`` with a CUDA event recorded as it returns; its logits kept."""
        def wrapped(*args):
            logits, cache = call(*args)
            mark()
            rows.append(logits[:, -1])
            return logits, cache
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.prefill, model.decode_step = timed(model.prefill), timed(model.decode_step)
    t0 = time.perf_counter()
    try:
        mark()
        out = engine.generate({"tokens": tokens}, steps=steps)
        torch.cuda.synchronize()
    finally:
        del model.prefill, model.decode_step  # the methods again
    wall = time.perf_counter() - t0
    prefill_ms = events[0].elapsed_time(events[1])
    step_ms = np.array([a.elapsed_time(b) for a, b in zip(events[1:], events[2:])])
    return out, wall, prefill_ms, step_ms, rows


def lm_serve_case(model, fixture, ref_rel, *, seed, counters, batch=LM_SERVE_BATCH,
                  prompt=LM_SERVE_PROMPT, steps=LM_SERVE_STEPS) -> dict:
    """``lm_serve``: ``Engine.generate`` with no ``device`` argument (the
    card) on bfloat16 weights, greedy; prefill and decode times beside their
    bounds, peak memory, the port's kernel launches (none on this path), and
    the fixture's prompts in bfloat16 against the fixture."""
    from repro_torch.configs import Shape, make_inputs
    from repro_torch.models.convert import rel_l2
    from repro_torch.serve.engine import Engine

    cfg = model.cfg
    dev = model.device
    engine = Engine(model, max_len=prompt + steps)
    tokens = make_inputs(cfg, Shape("lm_serve", prompt, batch, "prefill"), seed + 2,
                         device=dev)["tokens"]
    engine.generate({"tokens": tokens[:, :128]}, steps=4)  # warm-up: handles, allocator
    before = launch_counts(counters)
    out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model, tokens, steps)
    launched = count_delta(counters, before)
    peak = torch.cuda.max_memory_allocated()
    all_finite = bool(torch.isfinite(torch.stack(rows)).all())  # after the last event
    weights = lm_param_bytes(model)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    kv = [lm_decode_kv_bytes(model, batch, prompt + i, item) for i in range(steps - 1)]
    decode_bound = (weights + float(np.median(kv))) / HBM_BYTES_PER_S * 1e3
    prefill_flops = lm_prefill_flops(model, batch, prompt)
    prefill_bound = prefill_flops / PEAK_FLOPS_BF16 * 1e3
    logits16 = lm_fixture_logits(model, fixture).float().cpu().numpy()
    ids = np.asarray(fixture["vocab_ids"])
    got, ref = logits16[..., ids].astype(np.float64), np.asarray(fixture["logits"], np.float64)
    rel_all = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    res = dict(
        prefill_ms=prefill_ms, prefill_tokens_per_s=batch * prompt / (prefill_ms * 1e-3),
        prefill_bound_ms=prefill_bound, prefill_flops=prefill_flops,
        decode_ms_median=float(np.median(step_ms)), decode_ms_p90=float(np.percentile(step_ms, 90)),
        decode_tokens_per_s=batch / (float(np.median(step_ms)) * 1e-3),
        decode_bound_ms=decode_bound, weight_bytes=weights, kv_bytes_median=float(np.median(kv)),
        wall_s=wall, peak_memory_bytes=peak, port_kernel_launches=launched,
        all_logits_finite=all_finite, tokens_in_vocab=bool(((out >= 0) & (out < cfg.vocab_size)).all()),
        bf16_rel_l2=rel_all, bf16_rel_l2_rows_max=float(rel_l2(got, ref).max()),
        reference_bf16_rel_l2=ref_rel, bf16_limit=LM_BF16_FACTOR * ref_rel,
    )
    emit("lm_serve", arch=cfg.name, dtype=cfg.dtype, batch=batch, prompt=prompt, steps=steps,
         nvidia_smi=smi_line(), **res)
    check(all_finite and res["tokens_in_vocab"], f"lm_serve: non-finite logits or bad tokens: {res}")
    check(not any(launched.values()), f"lm_serve: the LM path launched a kernel of the port: {launched}")
    check(rel_all <= LM_BF16_FACTOR * ref_rel,
          f"lm_serve: bf16 logits {rel_all} from the fixture, past {LM_BF16_FACTOR} x {ref_rel}")
    return res


def lm_phase(rt_configs, dev, *, seed, counters) -> dict:
    """Slice 9: gemma2-2b at full width, float32 (``lm_reference``,
    ``lm_window``) then bfloat16 (``lm_serve``), weights from
    ``reference_weights`` copied to the card."""
    from repro_torch.models import Model
    from repro_torch.models.convert import (load_reference_params, reference_weights,
                                            weights_digest)

    check(LM_FIXTURE.exists(), f"the LM fixture {LM_FIXTURE} is missing")
    fixture = dict(np.load(LM_FIXTURE))
    cfg = rt_configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    tree = reference_weights(cfg, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          "the weights drawn here differ from the fixture's (another NumPy stream?)")
    before = launch_counts(counters)
    t0 = time.perf_counter()
    model = load_reference_params(Model(dataclasses.replace(cfg, dtype="float32"), device=dev), tree)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emit("lm_setup", arch=cfg.name, params=sum(p.numel() for p in model.parameters()),
         param_count=cfg.param_count(), weights_s=gen_s, load_s=load_s,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    ref = lm_reference_case(model, fixture)
    win = lm_window_case(model, seed=seed)
    del model
    torch.cuda.empty_cache()
    model = load_reference_params(Model(cfg, device=dev), tree)
    del tree
    serve = lm_serve_case(model, fixture, float(fixture["bf16_rel_l2_all"]), seed=seed,
                          counters=counters)
    launched = count_delta(counters, before)
    check(not any(launched.values()), f"the LM phase launched a kernel of the port: {launched}")
    emit("main_path_summary", path="slice9_lm", launches=launched)
    del model
    torch.cuda.empty_cache()
    return dict(reference=ref, window=win, serve=serve)


# -- slice 10: MoE with the LP router and MLA (deepseek-v2-lite-16b) ----------

#: The MoE phases' config, and its committed reference fixture
#: (``tools/lm_reference_fixture.py --arch deepseek-v2-lite-16b --layers 3
#: --router topk,lp``): full width, cut to the fixture's depth for
#: ``lm_moe_reference``; full depth for ``lm_moe_serve``.
LM_MOE_ARCH = "deepseek-v2-lite-16b"
LM_MOE_FIXTURE = ROOT / "tests" / "data" / "lm_deepseek_v2_lite_reference.npz"
LM_MOE_ROUTERS = ("topk", "lp")
#: The fixture's router LPs through the kernel: status, iterations and basis
#: exact, x within this.
LM_MOE_X_TOL = 1e-6
#: A port LP whose basis differs from the reference's passes only if the
#: reduced costs that decided the first differing pivot lie within the
#: float32 rounding of the affinities: this multiple of n * 2**-23 (relative),
#: n the tokens a group's affinity averages (the worst-case relative
#: rounding of a float32 sum of n terms).
LM_MOE_GAP_FACTOR = 4.0
#: ``lm_moe_serve``: the calls (the prefill, then decode steps) whose
#: router LPs are captured and re-run through the plain version.
LM_MOE_CAPTURE_CALLS = 3


class SimplexSpy:
    """``simplex_cuda.simplex`` wrapped for the length of a ``with``: it
    counts the calls, and for the first ``limit`` (all if None) keeps
    clones of the call's inputs and of its outputs (the terminal basis
    too, which the kernel writes in place) for replay on the plain
    version.  The clones are queued on the stream behind the launch;
    nothing waits for them."""

    def __init__(self, simplex_cuda, limit=None):
        self.mod = simplex_cuda
        self.limit = limit
        self.calls = 0
        self.records = []

    def __enter__(self):
        self.orig = self.mod.simplex
        self.mod.simplex = self._call
        return self

    def __exit__(self, *exc):
        self.mod.simplex = self.orig

    def _call(self, tab, basis, phase, c_ext, feas, cap, **kw):
        self.calls += 1
        keep = self.limit is None or len(self.records) < self.limit
        inputs = [t.clone() for t in (tab, basis, phase, c_ext, feas)] if keep else None
        out = self.orig(tab, basis, phase, c_ext, feas, cap, **kw)
        if keep:
            self.records.append(dict(inputs=inputs, cap=cap, kw=kw, basis=basis.clone(),
                                     out=[t.clone() for t in out]))
        return out


def replay_plain(rec) -> bool:
    """A captured launch's inputs through ``simplex_plain``: the same
    objective, x, status, iterations and terminal basis, bit for bit."""
    from repro_torch.kernels import simplex_cuda

    tab, basis, phase, c_ext, feas = (t.clone() for t in rec["inputs"])
    out = simplex_cuda.simplex_plain(tab, basis, phase, c_ext, feas, rec["cap"], **rec["kw"])
    return all(torch.equal(bits(a), bits(b))
               for a, b in zip(list(out) + [basis], rec["out"] + [rec["basis"]]))


def with_router(model, router: str):
    """The loaded model with ``cfg.router`` set to ``router`` in every module."""
    cfg = dataclasses.replace(model.cfg, router=router)
    for mod in model.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = cfg
    return model


def moe_layer_count(model) -> int:
    return sum(kind.endswith("_moe") for kind in model.kinds())


def router_lp_divergence(a, b, c_port, c_ref, cap) -> dict:
    """Where the port's LP (``c_port``) and the reference's (``c_ref``) part:
    both run a pivot at a time on the plain version (CPU, float32) until
    their bases differ; the relative gap between the reduced costs of the
    two entering columns, on the port's tableau before that pivot."""
    from repro_torch.core import simplex
    from repro_torch.core.tableau import build_tableau

    a, b = a.cpu()[None], b.cpu()[None]
    c_port, c_ref = c_port.cpu()[None], c_ref.cpu()[None]
    m = a.shape[1]
    tab, basis, _ = build_tableau(a, b, c_port)
    for step in range(1, cap + 1):
        sp, st = simplex.solve_batched(a, b, c_port, max_iters=step, want_state=True)
        sr = simplex.solve_batched(a, b, c_ref, max_iters=step)
        if not torch.equal(sp.basis, sr.basis):
            obj = tab[0, m]
            new_p = sorted(set(sp.basis[0].tolist()) - set(basis[0].tolist()))
            new_r = sorted(set(sr.basis[0].tolist()) - set(basis[0].tolist()))
            rp, rr = float(obj[new_p[0]]), float(obj[new_r[0]])
            return dict(pivot=step, port_column=new_p[0], reference_column=new_r[0],
                        port_reduced_cost=rp, reference_reduced_cost=rr,
                        gap=abs(rp - rr) / max(abs(rp), abs(rr), 1e-30))
        if int(sp.status[0]) != 0 and int(sr.status[0]) != 0:
            break
        tab, basis = st.tab, st.basis
    return dict(pivot=None, gap=None)


def router_lp_checks(view, records, dev, groups: int) -> dict:
    """``lm_moe_reference``'s LP gates: the fixture's own router LPs through
    the kernel (status, iterations and basis exact, x within
    ``LM_MOE_X_TOL``), and each LP the port built from its own affinities
    (``records``, in the fixture's call order) against the reference's
    basis; a differing basis passes only within the affinities' rounding
    (``LM_MOE_GAP_FACTOR``; ``groups`` is the router's G)."""
    from repro_torch.kernels import ops

    a, b, c = (torch.as_tensor(np.asarray(view[f"router_{k}"]), device=dev) for k in "abc")
    nlp, m, n = a.shape
    cap = 8 * (m + n)
    sol = ops.simplex_solve(a, b, c, max_iters=cap)
    ref = {k: np.asarray(view[f"router_{k}"]) for k in ("status", "iterations", "basis", "x")}
    fixture_on_kernel = dict(
        lps=nlp, m=m, n=n,
        status_equal=bool(np.array_equal(sol.status.cpu().numpy(), ref["status"])),
        iterations_equal=bool(np.array_equal(sol.iterations.cpu().numpy(), ref["iterations"])),
        basis_equal=bool(np.array_equal(sol.basis.cpu().numpy(), ref["basis"])),
        x_max_abs_err=float(np.abs(sol.x.cpu().numpy() - ref["x"]).max()),
        iterations=sorted(set(ref["iterations"].tolist())))
    check(len(records) >= nlp, f"the port solved {len(records)} router LPs, the fixture has {nlp}")
    calls, layers = np.asarray(view["router_call"]), np.asarray(view["router_layer"])
    batch, prompt = np.asarray(view["tokens"]).shape[0], int(view["prompt_len"])
    lines, c_gap_max = [], 0.0
    for i, rec in enumerate(records[:nlp]):
        c_port = rec["inputs"][3][0, 1:1 + n].float()
        basis = rec["basis"][0].cpu().numpy()
        c_ref = c[i]
        c_gap = float((c_port - c_ref).abs().max() / c_ref.abs().max().clamp_min(1e-30))
        a_port = rec["inputs"][0][0, :m, 1:1 + n]
        c_gap_max = max(c_gap_max, c_gap)
        if np.array_equal(basis, ref["basis"][i]) and torch.equal(a_port, a[i]):
            continue
        div = router_lp_divergence(a[i], b[i], c_port, c_ref, cap)
        tokens = batch * prompt if calls[i] == 0 else batch
        rounding = LM_MOE_GAP_FACTOR * math.ceil(tokens / groups) * 2.0 ** -23
        ok = div["gap"] is not None and div["gap"] <= rounding
        lines.append(dict(lp=i, call=int(calls[i]), layer=int(layers[i]),
                          a_equal=bool(torch.equal(a_port, a[i])),
                          affinity_rel_gap=c_gap, rounding=rounding, within_rounding=ok,
                          **div))
    res = dict(fixture_on_kernel=fixture_on_kernel, port_lps=nlp,
               port_basis_equal=nlp - len(lines), affinity_rel_gap_max=c_gap_max,
               divergences=lines)
    res["ok"] = (fixture_on_kernel["status_equal"] and fixture_on_kernel["iterations_equal"]
                 and fixture_on_kernel["basis_equal"]
                 and fixture_on_kernel["x_max_abs_err"] <= LM_MOE_X_TOL
                 and all(d["within_rounding"] for d in lines))
    return res


def lm_moe_reference_case(model, model16, fixture, router, *, counters) -> dict:
    """``lm_moe_reference`` for one router: the float32 model against the
    fixture (``lm_reference_case``'s gates, TF32 control included), the
    router LPs under ``lp``, and the bfloat16 model within
    ``LM_BF16_FACTOR`` times the reference's own bfloat16 gap."""
    from repro_torch.kernels import simplex_cuda
    from repro_torch.models.convert import fixture_view

    view = fixture_view(fixture, router)
    with_router(model, router)
    with_router(model16, router)
    before = launch_counts(counters)
    with SimplexSpy(simplex_cuda) as spy:
        res = lm_reference_case(model, view, phase=f"lm_moe_reference_{router}")
    launched = count_delta(counters, before)
    runs = 2 if model.device.type == "cuda" else 1  # the TF32 control runs too
    calls = int(view["steps"]) + 1
    expect = runs * calls * moe_layer_count(model) if router == "lp" else 0
    check(spy.calls == expect, f"lm_moe_reference {router}: {spy.calls} router LPs, not {expect}")
    check(model.device.type != "cuda" or launched["simplex"] == expect,
          f"lm_moe_reference {router}: {launched['simplex']} simplex launches, not {expect}")
    out = dict(router=router, logits=res, router_lps_solved=spy.calls,
               simplex_launches=launched["simplex"])
    if router == "lp":
        out["router_lp"] = router_lp_checks(view, spy.records, model.device,
                                            model.cfg.router_groups)
    logits16 = lm_fixture_logits(model16, view).float().cpu().numpy()[..., view["vocab_ids"]]
    ref = np.asarray(view["logits"], np.float64)
    rel = float(np.linalg.norm(logits16 - ref) / np.linalg.norm(ref))
    out.update(bf16_rel_l2=rel, reference_bf16_rel_l2=float(view["bf16_rel_l2_all"]),
               bf16_limit=LM_BF16_FACTOR * float(view["bf16_rel_l2_all"]))
    emit("lm_moe_reference", **{k: v for k, v in out.items() if k != "logits"},
         logits_worst_ratio=res["worst_ratio"])
    if router == "lp":
        check(out["router_lp"]["ok"], f"lm_moe_reference: router LPs: {out['router_lp']}")
    check(rel <= out["bf16_limit"],
          f"lm_moe_reference {router}: bf16 logits {rel} from the fixture, past {out['bf16_limit']}")
    return out


class RoutingStats:
    """``models.moe.dispatch`` wrapped for the length of a ``with``: keeps
    each call's expert choices and kept mask (references; the counting
    waits until the run is over)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.orig = moe, moe.dispatch

        def spy(experts, cap, num_experts):
            out = self.orig(experts, cap, num_experts)
            self.calls.append((experts, out[2], num_experts))
            return out

        moe.dispatch = spy
        return self

    def __exit__(self, *exc):
        self.mod.dispatch = self.orig

    def summary(self, prefill_tokens: int) -> dict:
        """Dropped share and the heaviest expert's load over the mean (of
        each MoE layer, its loads summed over the part's calls), for the
        prefill and for the decode steps."""
        prefill = [c for c in self.calls if c[0].shape[0] == prefill_tokens]
        decode = [c for c in self.calls if c[0].shape[0] != prefill_tokens]
        n_layers = max(1, len(prefill))  # the prefill calls each MoE layer once
        out = {}
        for name, calls in (("prefill", prefill), ("decode", decode)):
            if not calls:
                continue
            loads = [sum(torch.bincount(c[0].reshape(-1), minlength=c[2]).double()
                         for c in calls[i::n_layers]) for i in range(min(n_layers, len(calls)))]
            ratios = [float(load.max() / load.mean()) for load in loads]
            assigned = sum(c[1].numel() for c in calls)
            dropped = int(sum((~c[1]).sum() for c in calls))
            out[name] = dict(calls=len(calls), assignments=assigned, dropped=dropped,
                             dropped_share=dropped / assigned,
                             max_over_mean_max=max(ratios),
                             max_over_mean_mean=float(np.mean(ratios)))
        return out

    def kept(self, tokens: int) -> int:
        """Kept assignments of the calls over ``tokens`` tokens."""
        return int(sum(c[1].sum() for c in self.calls if c[0].shape[0] == tokens))


def lm_moe_prefill_flops(model, batch, s, kept) -> float:
    """Matrix-product FLOPs a prefill needs: every layer's MLA projections
    and causal attention, the dense FFN, the router, the ``kept`` expert
    assignments (this run's count) and the shared experts, and the
    unembedding of the last position."""
    cfg = model.cfg
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    qk, v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    tokens = batch * s
    keys = batch * s * (s + 1) // 2
    attn = (2 * tokens * (d * h * qk + d * (r + cfg.qk_rope_dim) + r * h * (cfg.qk_nope_dim + v)
                          + h * v * d)
            + 2 * keys * h * (qk + v))
    kinds = model.kinds()
    dense = sum(k == "mla_dense" for k in kinds) * 6 * tokens * d * (cfg.d_ff_dense or cfg.d_ff)
    n_moe = sum(k == "mla_moe" for k in kinds)
    moe = (n_moe * tokens * (2 * d * cfg.num_experts + 6 * d * cfg.d_ff * cfg.num_shared_experts)
           + kept * 6 * d * cfg.d_ff)
    return float(len(kinds) * attn + dense + moe + 2 * batch * d * cfg.padded_vocab)


def lm_moe_serve_case(model, router, *, seed, counters, batch=LM_SERVE_BATCH,
                      prompt=LM_SERVE_PROMPT, steps=LM_SERVE_STEPS) -> dict:
    """``lm_moe_serve`` for one router: ``Engine.generate`` with no device
    argument on the loaded model, greedy; prefill and decode times beside
    their bounds, peak memory, the routing's dropped share and expert load,
    the simplex launches (0 under ``topk``, one a MoE layer a call under
    ``lp``, all of the cluster variant), and the first calls' router LPs
    re-run through the plain version."""
    from repro_torch.configs import Shape, make_inputs
    from repro_torch.kernels import simplex_cuda
    from repro_torch.serve.engine import Engine

    with_router(model, router)
    cfg = model.cfg
    n_moe = moe_layer_count(model)
    engine = Engine(model, max_len=prompt + steps)
    tokens = make_inputs(cfg, Shape("lm_moe_serve", prompt, batch, "prefill"), seed + 3,
                         device=model.device)["tokens"]
    engine.generate({"tokens": tokens[:, :128]}, steps=4)  # warm-up: handles, allocator, build
    engine.cache = None
    before = launch_counts(counters)
    with SimplexSpy(simplex_cuda, limit=LM_MOE_CAPTURE_CALLS * n_moe) as spy, \
            RoutingStats() as routing:
        out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model, tokens, steps)
    launched = count_delta(counters, before)
    peak = torch.cuda.max_memory_allocated()
    all_finite = bool(torch.isfinite(torch.stack(rows)).all())
    expect = steps * n_moe if router == "lp" else 0
    replayed = [replay_plain(rec) for rec in spy.records]
    stats = routing.summary(batch * prompt)
    kept = routing.kept(batch * prompt)
    del routing
    weights = lm_param_bytes(model)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    cache_bytes = [len(model.kinds()) * batch * (prompt + i + 1)
                   * (cfg.kv_lora_rank + cfg.qk_rope_dim) * item for i in range(steps - 1)]
    decode_bound = (weights + float(np.median(cache_bytes))) / HBM_BYTES_PER_S * 1e3
    flops = lm_moe_prefill_flops(model, batch, prompt, kept)
    res = dict(
        router=router, prefill_ms=prefill_ms,
        prefill_tokens_per_s=batch * prompt / (prefill_ms * 1e-3),
        prefill_bound_ms=flops / PEAK_FLOPS_BF16 * 1e3, prefill_flops=flops,
        decode_ms_median=float(np.median(step_ms)), decode_ms_p90=float(np.percentile(step_ms, 90)),
        decode_tokens_per_s=batch / (float(np.median(step_ms)) * 1e-3),
        decode_bound_ms=decode_bound, weight_bytes=weights,
        cache_bytes_median=float(np.median(cache_bytes)), wall_s=wall, peak_memory_bytes=peak,
        routing=stats, router_lps=spy.calls, port_kernel_launches=launched,
        captured_lps=len(spy.records), captured_bit_identical=sum(replayed),
        all_logits_finite=all_finite,
        tokens_in_vocab=bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit("lm_moe_serve", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers, batch=batch,
         prompt=prompt, steps=steps, nvidia_smi=smi_line(), **res)
    check(all_finite and res["tokens_in_vocab"],
          f"lm_moe_serve {router}: non-finite logits or bad tokens")
    check(spy.calls == expect and launched["simplex"] == expect
          and launched["simplex.cluster"] == expect,
          f"lm_moe_serve {router}: {spy.calls} router LPs, launches {launched}, not {expect}")
    check(not any(v for k, v in launched.items() if not k.startswith("simplex")),
          f"lm_moe_serve {router}: another kernel of the port launched: {launched}")
    check(len(spy.records) == (LM_MOE_CAPTURE_CALLS * n_moe if router == "lp" else 0)
          and all(replayed),
          f"lm_moe_serve {router}: {sum(replayed)} of {len(replayed)} captured router LPs "
          "bit-identical to simplex_plain")
    if router == "lp":
        res["_records"] = spy.records
    return res


def lm_moe_phase(rt_configs, dev, *, seed, counters, reset) -> dict:
    """Slice 10: deepseek-v2-lite-16b at full width.  ``lm_moe_reference``
    (the fixture's depth, float32 and bfloat16, weights from
    ``reference_weights``) for each router, then ``lm_moe_serve`` (full
    depth, bfloat16, ``Model.init`` on the card) for each router on one
    loaded model, with the launch counts set to 0 before and read after;
    then the router's LP on the simplex kernel against its plain version
    (``simplex_case``) at its prefill shape."""
    from repro_torch.core.lp import LPBatch
    from repro_torch.models import Model
    from repro_torch.models.convert import (load_reference_params, reference_weights,
                                            weights_digest)

    check(LM_MOE_FIXTURE.exists(), f"the MoE fixture {LM_MOE_FIXTURE} is missing")
    fixture = dict(np.load(LM_MOE_FIXTURE))
    cfg = rt_configs.get_config(LM_MOE_ARCH)
    cut = dataclasses.replace(cfg, num_layers=int(fixture["layers"]))
    t0 = time.perf_counter()
    tree = reference_weights(cut, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          "the MoE weights drawn here differ from the fixture's")
    t0 = time.perf_counter()
    model = load_reference_params(Model(dataclasses.replace(cut, dtype="float32"), device=dev),
                                  tree)
    model16 = load_reference_params(Model(cut, device=dev), tree)
    del tree
    load_s = time.perf_counter() - t0
    emit("lm_moe_setup", arch=cfg.name, layers=cut.num_layers, kinds=model.kinds(),
         params=sum(p.numel() for p in model.parameters()), param_count=cut.param_count(),
         full_param_count=cfg.param_count(), weights_s=gen_s, load_s=load_s)
    reference = {r: lm_moe_reference_case(model, model16, fixture, r, counters=counters)
                 for r in LM_MOE_ROUTERS}
    del model, model16
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    emit("lm_moe_serve_setup", arch=cfg.name, layers=cfg.num_layers,
         params=sum(p.numel() for p in model.parameters()),
         param_bytes=lm_param_bytes(model), init_s=time.perf_counter() - t0)
    reset()
    serve = {r: lm_moe_serve_case(model, r, seed=seed, counters=counters)
             for r in LM_MOE_ROUTERS}
    launched = launch_counts(counters)
    emit("main_path_summary", path="slice10_lm_moe", launches=launched)
    n_moe = moe_layer_count(model)
    del model
    torch.cuda.empty_cache()

    # The router's LP on the kernel against its plain version: the
    # prefill's first MoE layer, as captured.
    rec = serve["lp"].pop("_records")[0]
    tab, basis = rec["inputs"][0], rec["inputs"][1]
    spec = rec["kw"]["spec"]
    a = tab[:, :spec.m, 1:1 + spec.n].clone()
    b = tab[:, :spec.m, 0].clone()
    c = rec["inputs"][3][:, 1:1 + spec.n].clone()
    timer = Timer(dev)
    kernel = simplex_case(timer, name=f"lm_router_{spec.m}x{spec.n}_f32_lpc",
                          batch=LPBatch(a, b, c), cap=rec["cap"], reps=20, want="cluster")
    lp_ms = kernel["kernel_ms"]
    router = dict(case=kernel["case"], m=spec.m, n=spec.n, kernel_ms=lp_ms,
                  plain_ms=kernel["plain_ms"], bound_ms=kernel["bound_ms"],
                  bound_by=kernel["bound_by"], max_abs_err=kernel["max_abs_err"],
                  pivots=kernel["pivots"], variant=kernel["variant"], k=kernel["k"],
                  launches=launched["simplex"],
                  lp_kernel_share_of_decode_step=n_moe * lp_ms / serve["lp"]["decode_ms_median"],
                  lp_decode_step_over_topk=serve["lp"]["decode_ms_median"]
                  / serve["topk"]["decode_ms_median"])
    emit("lm_router_lp", nvidia_smi=smi_line(), **router)
    return dict(reference=reference, serve=serve, router=router, launches=launched)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of every generated input")
    args = parser.parse_args(argv)

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU")
    # HiGHS, the slice-3 reference, runs in worker processes beside the card.
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn"))
    try:
        return run(args, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(args, pool) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.core.bucketing import bucket_problems
        from repro_torch.core.lp import LPBatch
        from repro_torch.core.problem import canonicalize
        from repro_torch.core.lp import random_shared_lp_batch
        from repro_torch.core import pdhg
        from repro_torch.core.pdhg import auto_cap_pdhg
        from repro_torch.core.reach import five_dim_model, helicopter_model, reach_supports
        from repro_torch.kernels import (build, hyperbox_cuda, ops, pdhg_cuda, revised_cuda,
                                         simplex_cuda)
        from repro_torch import configs as rt_configs
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: FAILED: the port is not beside this script: {exc}")
    dev = torch.device("cuda")
    timer = Timer(dev)
    # Every dispatch round that raises is counted from here on: only the
    # fault cases may raise (no clean phase leans on a retry).
    watch = FaultWatch().__enter__()

    # -- 1. environment (after the build, which the cluster occupancy needs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    t0 = time.perf_counter()
    builds = build.compile_all()
    build_s = time.perf_counter() - t0
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         cluster_occupancy=cluster_occupancy(dev))

    # -- 2. build
    emit("build", wall_s=build_s,
         sources=[dict(source=b["name"], built=b["built"], nvcc_s=b["seconds"],
                       kernels=build.ptxas_report(b["log"])) for b in builds])

    # -- 3. kernels against their plain versions
    # Every simplex launch of the main path (phase 4) is held against the
    # plain version here on the same LPs: the two paper classes at their
    # full batches, and the three buckets of the heterogeneous list.
    def paper_batch(bsz, m, n, feasible, seed, dtype=torch.float32):
        a, b, c, _ = chunked_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible,
                                      dtype, dev, chunk=5000)
        return LPBatch(a, b, c)

    # Type 1 and type 2 also run the global variant on the same LPs: the
    # same bits, and its time in this call.
    # Both stay on the card for the rounds phase (slice 6).
    type1 = paper_batch(50_000, 100, 100, True, args.seed)
    s_main = simplex_case(timer, name="type1_50000x100x100_f32_lpc", want="cluster",
                          batch=type1, beside_global=True)
    type2 = paper_batch(10_000, 200, 100, False, args.seed + 1)
    s_type2 = simplex_case(timer, name="type2_10000x200x100_f32_lpc", want="cluster",
                           batch=type2, beside_global=True)
    # The tableau's rank-1 update rounds once in float32 (core/engine.py:
    # rank1_update); both variants stay bit-identical to the plain version.
    emit("a1_rank1_update", type1_kernel_ms=s_main["kernel_ms"],
         type1_global_ms=s_main["global_ms"], type2_kernel_ms=s_type2["kernel_ms"],
         type2_global_ms=s_type2["global_ms"],
         bit_identical=s_main["bit_identical"] and s_type2["bit_identical"])
    torch.cuda.empty_cache()
    for bucket in bucket_problems(hetero_problems(rt, args.seed + 4, HETERO_PER_CLASS)[0]):
        m, n = bucket.key[:2]
        simplex_case(timer, name=f"list_bucket_{m}x{n}_f32_lpc", want="cluster",
                     batch=canonicalize(bucket.problem).batch)
    # A resumed chain under a cluster of 2 (type 2's shape), and the global
    # variant past the largest cluster (a 701 x 1401 tableau), small and short.
    simplex_case(timer, name="chain_1000x200x100_f32_lpc", chain=(60, 14_940), want="cluster",
                 batch=paper_batch(1000, 200, 100, False, args.seed + 13))
    s_global = simplex_case(timer, name="global_4x700x700_f32_lpc_cap300", cap=300,
                            want="global", batch=paper_batch(4, 700, 700, True, args.seed + 14))
    simplex_case(timer, name="256x28x28_f64_bland", rule="bland",
                 batch=paper_batch(256, 28, 28, True, args.seed + 10, torch.float64))
    simplex_case(timer, name="256x28x28_f32_rpc_seed7", rule="rpc", seed=7,
                 batch=paper_batch(256, 28, 28, True, args.seed + 11))
    simplex_case(timer, name="dense_chain_256x40x20_f32_lpc", layout="dense", chain=(25, 175),
                 batch=paper_batch(256, 40, 20, False, args.seed + 12))
    h_main = hyperbox_case(dev, timer, name="4000000x5_f32", bsz=4_000_000, n=5,
                           dtype=torch.float32, data_seed=args.seed + 2)
    hyperbox_case(dev, timer, name="6000000x28_f32", bsz=6_000_000, n=28,
                  dtype=torch.float32, data_seed=args.seed + 3)
    hyperbox_case(dev, timer, name="1000000x28_f64", bsz=1_000_000, n=28,
                  dtype=torch.float64, data_seed=args.seed + 20)
    torch.cuda.empty_cache()
    # Every revised launch of the slice-2 path is held against the plain
    # version here on the same inputs: the two shared rows at full batch
    # and the two reach sweeps.
    def shared_batch(bsz, m, n, feasible, seed, dtype=np.float32):
        return random_shared_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible,
                                      dtype=dtype, device=dev)

    # Shared types 1 and 2 also run the global variant on the same LPs: the
    # same bits, and its time in this call.
    shared1 = shared_batch(50_000, 100, 100, True, args.seed + 30)
    r_main = revised_case(timer, name="shared_type1_50000x100x100_f32_lpc", want="resident",
                          sb=shared1, beside_global=True)
    torch.cuda.empty_cache()
    revised_case(timer, name="shared_type2_10000x200x100_f32_lpc", want="resident",
                 sb=shared_batch(10_000, 200, 100, False, args.seed + 31), beside_global=True)
    torch.cuda.empty_cache()
    # The global variant past the resident budget (binv 360 KB an LP).
    r_global = revised_case(timer, name="shared_global_64x300x100_f32_lpc", want="global",
                            sb=shared_batch(64, 300, 100, True, args.seed + 38))
    revised_case(timer, name="shared_256x28x28_f64_bland", rule="bland",
                 sb=shared_batch(256, 28, 28, True, args.seed + 32, np.float64))
    revised_case(timer, name="shared_256x28x28_f32_rpc_seed7", rule="rpc", seed=7,
                 sb=shared_batch(256, 28, 28, True, args.seed + 33))
    revised_case(timer, name="shared_chain_256x40x20_f32_lpc", chain=(25, 175),
                 sb=shared_batch(256, 40, 20, False, args.seed + 34))
    revised_case(timer, name="shared_chain_256x40x20_f32_lpc_global", chain=(25, 175),
                 variant="global", want="global",
                 sb=shared_batch(256, 40, 20, False, args.seed + 34))
    warm = shared_batch(256, 30, 30, True, args.seed + 35)
    basis0 = ops.revised_solve(warm.a, warm.b, warm.c).basis.clone()
    basis0[:4, 1] = basis0[:4, 0]  # four singular bases: those rows start cold
    revised_case(timer, name="shared_warm_256x30x30_f32_lpc_4_singular", sb=warm,
                 basis0=basis0)
    reach_steps = 200
    # The reach rows' input-set supports: 200 steps x 50 (5-dim, oct) and
    # x 56 (helicopter, box) directions against one box (row stride 0).
    hyperbox_case(dev, timer, name="reach_10000x5_f32_box", bsz=10_000, n=5,
                  dtype=torch.float32, data_seed=args.seed + 36, box=True)
    hyperbox_case(dev, timer, name="reach_11200x28_f32_box", bsz=11_200, n=28,
                  dtype=torch.float32, data_seed=args.seed + 37, box=True)
    sweeps = {
        "five_dim": sweep_case(timer, dev, name="reach_sweep_five_dim_oct", kind="oct",
                               model=five_dim_model(), steps=reach_steps),
        "helicopter": sweep_case(timer, dev, name="reach_sweep_helicopter_box", kind="box",
                                 model=helicopter_model(), steps=reach_steps),
    }
    # The reach rows' reference, the hyperbox path for X0, computed here so
    # that its launches stay out of the main path's counts.
    hyperbox_refs = {
        name: reach_supports(model, 0.02, reach_steps,
                             directions=reach_args(rt, model, kind)["directions"])[0]
        for name, model, kind in [("five_dim", five_dim_model(), "oct"),
                                  ("helicopter", helicopter_model(), "box")]
    }
    del warm, basis0
    torch.cuda.empty_cache()

    # -- 4. the main paths; the launch counts are set to 0 just before each
    # path and read just after it
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}

    def reset_counts():
        for mod in counters.values():
            mod.launches = 0
            for variant in getattr(mod, "variant_launches", {}):
                mod.variant_launches[variant] = 0

    reset_counts()
    rows = [
        simplex_row(rt, dev, name="type1_feasible_100x100", bsz=50_000, m=100, n=100,
                    feasible=True, seed=args.seed, counters=counters),
        simplex_row(rt, dev, name="type2_infeasible_start_200x100", bsz=10_000, m=200, n=100,
                    feasible=False, seed=args.seed + 1, counters=counters),
        hyperbox_row(rt, dev, name="hyperbox_4000000x5", bsz=4_000_000, n=5,
                     seed=args.seed + 2, counters=counters),
        hyperbox_row(rt, dev, name="hyperbox_6000000x28", bsz=6_000_000, n=28,
                     seed=args.seed + 3, counters=counters),
        hetero_row(rt, seed=args.seed + 4, counters=counters, per_class=HETERO_PER_CLASS),
    ]
    slice1 = launch_counts(counters)
    check(slice1["simplex"] > 0 and slice1["hyperbox"] > 0,
          f"a kernel of the slice-1 path was never launched: {slice1}")
    check(slice1["simplex.cluster"] == slice1["simplex"],
          f"a slice-1 simplex launch did not take the cluster variant: {slice1}")
    emit("main_path_summary", path="slice1_dense_and_box", launches=slice1, rows=len(rows))
    torch.cuda.empty_cache()

    reruns = []
    reset_counts()
    rows2 = [
        shared_row(rt, dev, name="shared_type1_100x100", bsz=50_000, m=100, n=100,
                   feasible=True, seed=args.seed + 30, counters=counters, dense_row=rows[0],
                   reruns=reruns),
        shared_row(rt, dev, name="shared_type2_200x100", bsz=10_000, m=200, n=100,
                   feasible=False, seed=args.seed + 31, counters=counters, dense_row=rows[1],
                   reruns=reruns),
        reach_row(rt, name="reach_five_dim", model=five_dim_model(), kind="oct",
                  steps=reach_steps, counters=counters,
                  plain_pivots=sweeps["five_dim"]["pivots"],
                  hyperbox_ref=hyperbox_refs["five_dim"], reruns=reruns),
        reach_row(rt, name="reach_helicopter", model=helicopter_model(), kind="box",
                  steps=reach_steps, counters=counters,
                  plain_pivots=sweeps["helicopter"]["pivots"],
                  hyperbox_ref=hyperbox_refs["helicopter"], reruns=reruns),
    ]
    slice2 = launch_counts(counters)
    check(slice2 == {k: sum(r["launches"][k] for r in rows2) for k in slice2},
          f"slice-2 launches {slice2} are not the sum of its rows'")
    check(slice2["revised"] > 0 and slice2["hyperbox"] > 0,
          f"a kernel of the slice-2 path was never launched: {slice2}")
    check(slice2["revised.resident"] == slice2["revised"],
          f"a slice-2 revised launch did not take the resident variant: {slice2}")
    emit("main_path_summary", path="slice2_shared_and_reach", launches=slice2, rows=len(rows2))
    # Wall times of the slice-2 rows beyond the counted run (one reading
    # of a sub-second row is not a rate), after the counts were read.
    repeat_rows(reruns, reps=5)
    del reruns
    torch.cuda.empty_cache()

    # Slice 3, the first-order path.  First the PDHG kernel against its
    # plain version, here rather than in phase 3 so that neither its
    # buffers nor HiGHS's worker processes (the reference, one LP each,
    # running meanwhile) weigh on the earlier paths' rows.  The main case
    # is the slice-3 batch itself (256 LPs of 500x500, A 256 MB), at a
    # short cap and at the auto cap.
    a, b, c, highs_lps = chunked_lp_batch(np.random.default_rng(args.seed + 40), PDHG_LPS,
                                          PDHG_DIM, PDHG_DIM, True, torch.float32, dev,
                                          chunk=HIGHS_SAMPLE)
    pdhg_batch = LPBatch(a, b, c)
    del a, b, c
    highs_futures = [pool.submit(highs_solve, lp) for lp in zip(*highs_lps)]
    tag = f"{PDHG_LPS}x{PDHG_DIM}x{PDHG_DIM}_f32"
    p400, *_ = pdhg_case(timer, name=f"{tag}_cap400", batch=pdhg_batch, cap=400, full=False,
                           reps=3, eager=True, want="cluster")
    # The same cap on the streaming variant (forced) and, as a finding, at
    # clusters of 8 and 16 beside the least k.
    p_stream, *_ = pdhg_case(timer, name=f"{tag}_cap400_streaming", batch=pdhg_batch, cap=400,
                               full=False, reps=3, k=0, want="streaming")
    k_sweep = {p400["k"]: p400["kernel_ms"]}
    for k in (8, 16):
        row, *_ = pdhg_case(timer, name=f"{tag}_cap400_k{k}", batch=pdhg_batch, cap=400,
                              full=False, reps=3, k=k, want="cluster")
        k_sweep[k] = row["kernel_ms"]
    emit("pdhg_k_sweep", case=f"{tag}_cap400", kernel_ms_by_k=k_sweep,
         streaming_ms=p_stream["kernel_ms"])
    pdhg_chain_case(name=tag, batch=pdhg_batch)
    p_main, p_main_status, _, p_main_iters = pdhg_case(
        timer, name=f"{tag}_auto_cap", batch=pdhg_batch, cap=auto_cap_pdhg(PDHG_DIM, PDHG_DIM),
        full=True, want="cluster")
    stream_auto_ms = pdhg_streaming_beside(timer, name=f"{tag}_auto_cap_streaming",
                                           batch=pdhg_batch, cluster_status=p_main_status)
    pdhg_slowest_lp(timer, batch=pdhg_batch, status=p_main_status, steps=p_main_iters,
                    streaming_cap=4000)
    pdhg_case(timer, name="64x200x200_f64_cap2000", cap=2000, full=False, reps=3,
              want="cluster", batch=paper_batch(64, 200, 200, True, args.seed + 41, torch.float64))
    cert = certificate_batch(dev)
    _, cert_status, *_ = pdhg_case(timer, name="certificates_4x100x100_f32", batch=cert,
                               cap=20_000, full=True, want="cluster")
    # The streaming variant past the largest cluster (A 4 MB an LP), small
    # and short.
    p_big, *_ = pdhg_case(timer, name="streaming_4x1000x1000_f32_cap50", cap=50, full=False,
                            want="streaming",
                            batch=paper_batch(4, 1000, 1000, True, args.seed + 43))
    confirmed = rt.solve(cert, rt.SolveOptions(backend="pdhg", max_iters=20_000)).status
    emit("certificates", case="4x100x100_rows_0_1_unbounded",
         kernel_status=cert_status.tolist(), confirmed_status=confirmed.tolist())
    check(cert_status[:2].tolist() == [2, 2] and confirmed[:2].tolist() == [2, 2],
          "pdhg kernel: the constructed rays are not certified UNBOUNDED")
    del cert
    torch.cuda.empty_cache()

    highs = [f.result() for f in highs_futures]
    reset_counts()
    auto_row, auto_sol, auto_confirm = pdhg_row(rt, name=f"pdhg_auto_{PDHG_DIM}x{PDHG_DIM}",
                                                batch=pdhg_batch,
                                  options=rt.SolveOptions(backend="auto"), counters=counters,
                                  highs=highs, rtol=5e-3)
    check(auto_row["launches"]["pdhg"] == 1 and auto_row["launches"]["simplex"] == 0,
          f"pdhg_auto launched {auto_row['launches']} (one pdhg launch, no simplex expected)")
    cross_row, *_ = pdhg_row(rt, name=f"pdhg_crossover_{PDHG_DIM}x{PDHG_DIM}", batch=pdhg_batch,
                            options=rt.SolveOptions(backend="auto", crossover=True),
                            counters=counters, highs=highs, rtol=1e-4,
                            base_iters=auto_sol.iterations.cpu().numpy().astype(np.int64))
    check(cross_row["launches"]["pdhg"] > 0 and cross_row["launches"]["simplex"] > 0,
          f"pdhg_crossover launched {cross_row['launches']}")
    torch.cuda.empty_cache()
    rows3 = [auto_row, cross_row, auto_list_row(rt, dev, seed=args.seed + 42, counters=counters,
                                                 per_class=HETERO_PER_CLASS)]
    slice3 = launch_counts(counters)
    check(slice3 == {k: sum(r["launches"][k] for r in rows3) for k in slice3},
          f"slice-3 launches {slice3} are not the sum of its rows'")
    check(slice3["pdhg"] > 0 and slice3["simplex"] > 0,
          f"a kernel of the slice-3 path was never launched: {slice3}")
    check(slice3["pdhg.cluster"] == slice3["pdhg"] and
          slice3["simplex.cluster"] == slice3["simplex"],
          f"a slice-3 launch did not take the cluster variant: {slice3}")
    emit("main_path_summary", path="slice3_first_order", launches=slice3, rows=len(rows3))
    # The confirmation of pdhg_auto's flags ran on host threads; the same
    # flags confirmed sequentially, once, beside it.
    confirmation_case(auto_confirm, auto_row["row"])
    del auto_confirm
    # The routing frontier: the same batch on the simplex kernel, after the
    # counts were read.
    frontier_row(rt, batch=pdhg_batch, pdhg_row_=auto_row, highs=highs,
                 raw_status=p_main_status.cpu().numpy())
    # Every crossover launch of the slice-3 path polishes one tile of
    # CROSSOVER_TILE LPs of 500x500 from a warm basis: the first tile of
    # pdhg_crossover, warm from the same PDHG point, against the plain
    # version; then the polish's time by tile size.
    opt = (auto_sol.status == 1).nonzero().flatten()[:pdhg.CROSSOVER_TILE]
    check(opt.numel() == pdhg.CROSSOVER_TILE, f"only {opt.numel()} OPTIMAL rows to polish")
    tile = pdhg_batch.take(opt)
    s_tile = simplex_case(
        timer, name=f"crossover_tile_{opt.numel()}x{PDHG_DIM}x{PDHG_DIM}_f32_warm", batch=tile,
        basis0=pdhg.crossover_basis(tile.a, tile.b, auto_sol.x[opt]), reps=1, want="cluster",
        beside_global=True)
    del tile
    crossover_tiles(batch=pdhg_batch, sol=auto_sol, small=8)
    del auto_sol
    torch.cuda.empty_cache()

    # Slice 6, the round scheduler: compaction "off" and the compacted
    # solves on the same LPs in one call, each bit-equal to "off" and each
    # round one kernel launch; then the guardrails, sessions and the dense
    # warm sweep.
    reset_counts()
    k_rounds = 128
    simplex_fields = ("status", "iterations", "basis", "objective", "x")
    type1_off, _ = rounds_case(
        rt, name="type1_50000x100x100_f32_lpc", problem=type1,
        base=rt.SolveOptions(compact_every=k_rounds), counters=counters, kernel="simplex",
        variant="cluster", fields=simplex_fields,
        modes=[("every_k", "basis"), ("chunked", "scratch")])
    rounds_case(rt, name="type2_10000x200x100_f32_lpc", problem=type2,
                base=rt.SolveOptions(compact_every=k_rounds), counters=counters,
                kernel="simplex", variant="cluster", fields=simplex_fields,
                modes=[("every_k", "basis"), ("chunked", "scratch")])
    rounds_case(rt, name="shared_type1_50000x100x100_f32_lpc", problem=shared1,
                base=rt.SolveOptions(backend="cuda-shared", compact_every=k_rounds),
                counters=counters, kernel="revised", variant="resident", fields=simplex_fields,
                modes=[("every_k", "basis")])
    rounds_case(rt, name=f"pdhg_64x{PDHG_DIM}x{PDHG_DIM}_f32_cap400",
                problem=pdhg_batch.take(slice(0, 64)),
                base=rt.SolveOptions(backend="pdhg", max_iters=400, compact_every=50),
                counters=counters, kernel="pdhg", variant="cluster",
                fields=("status", "iterations", "x", "y"), modes=[("every_k", "basis")])
    guardrail_cases(rt, name="type1_50000x100x100_f32_lpc", problem=type1, off=type1_off,
                    counters=counters, poison_lps=5000, k=k_rounds)
    session_case(rt, dev, problem=type1)
    for name, model, kind in [("five_dim", five_dim_model(), "oct"),
                              ("helicopter", helicopter_model(), "box")]:
        dense_sweep_case(rt, dev, name=f"reach_{name}", model=model, kind=kind,
                         steps=reach_steps, counters=counters)
    slice6 = launch_counts(counters)
    check(slice6["simplex"] > 0 and slice6["revised"] > 0 and slice6["pdhg"] > 0,
          f"a kernel of the rounds phase was never launched: {slice6}")
    check(slice6["simplex.cluster"] == slice6["simplex"] and
          slice6["revised.resident"] == slice6["revised"] and
          slice6["pdhg.cluster"] == slice6["pdhg"],
          f"a rounds-phase launch did not take the main variant: {slice6}")
    emit("main_path_summary", path="slice6_rounds_sessions_sweeps", launches=slice6)
    # The row-local A lo product of canonicalize (slice 8) at types 1 and 2,
    # after the counts were read.
    a_lo_case(timer, dev, batches=[("type1", type1), ("type2", type2)])
    del type2, type1_off
    torch.cuda.empty_cache()

    # Slice 7, the serve loop: the traffic's one-shot answers, a warm-up, the
    # calibration (the whole trace at t = 0), then both modes replayed
    # open-loop at half the calibrated rate and the PDHG requests; then,
    # after the counts were read, the fault cases and speculation.
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import Arrival, poisson_trace, replay

    serve_problems = serve_requests(rt)
    serve_plan = serve_kernel_cases(rt, dev, timer, problems=serve_problems,
                                    pdhg_batch=pdhg_batch)
    oneshot = rt.SolveSession(device=dev).solve(serve_problems)
    warm = serve_problems[:256]
    cont_kw = dict(flush_every=1 << 30, max_inflight=1024, step_iters=64)
    cal = LPEngine(rt.SolveOptions(), device=dev, **cont_kw)
    drain(cal, warm)
    torch.cuda.synchronize()
    res = replay(cal, [Arrival(0.0, p) for p in serve_problems], mode="continuous")
    rate = len(serve_problems) / res.makespan
    same = same_solutions(res.solutions, oneshot)
    emit("serve_calibration", requests=len(serve_problems), throughput_per_s=rate,
         makespan_s=res.makespan, p50_ms=float(np.percentile(res.latencies, 50) * 1e3),
         p99_ms=float(np.percentile(res.latencies, 99) * 1e3), spliced=cal.stats.spliced,
         bit_equal_to_oneshot=same, offered_per_s=0.5 * rate, **cont_kw)
    check(all(same.values()), f"serve calibration differs from the one-shot solve: {same}")
    check_clean(cal, "serve_calibration")
    del cal, res
    trace = poisson_trace(0.5 * rate, len(serve_problems), lambda i: serve_problems[i], seed=17)
    reset_counts()
    serve_mode_case(rt, dev, mode="continuous", problems=serve_problems, trace=trace,
                    oneshot=oneshot, counters=counters, engine_kw=cont_kw, warm=warm)
    serve_mode_case(rt, dev, mode="flush", problems=serve_problems, trace=trace,
                    oneshot=oneshot, counters=counters, engine_kw=dict(flush_every=512),
                    warm=warm)
    serve_pdhg_case(rt, dev, batch=pdhg_batch.take(slice(0, 64)), counters=counters,
                    plan_row=serve_plan)
    slice7 = launch_counts(counters)
    check(slice7["simplex"] > 0 and slice7["hyperbox"] > 0 and slice7["pdhg"] > 0,
          f"a kernel of the serve path was never launched: {slice7}")
    check(slice7["simplex.cluster"] == slice7["simplex"] and
          slice7["pdhg.cluster"] == slice7["pdhg"],
          f"a serve-path launch did not take the cluster variant: {slice7}")
    emit("main_path_summary", path="slice7_serve", launches=slice7)
    del serve_problems, oneshot, warm, trace
    raised = watch.raised
    faults_case(rt, dev, type1=type1, shared1=shared1)
    fault_raised = watch.raised - raised
    speculation_case(rt, batch=type1, chunk=6250)

    # Slice 8, the autotuner: the predicted ranking of every main-path class
    # (equal to the static table) and type 1's first 5,000 LPs under the
    # default options against autotune="off"; then warm trials into a cache
    # file, a warm process on it (no trial), a "trial" solve that takes the
    # cached winner; then the roofline line.  Counted from the first solve to
    # the last trial.
    reset_counts()
    part = type1.take(torch.arange(5000, device=dev))
    off = autotune_predict_case(rt, dev, part=part)
    autotune_trial_case(rt, dev, part=part, off=off)
    slice8 = launch_counts(counters)
    check(slice8["simplex"] > 0 and slice8["simplex.cluster"] == slice8["simplex"],
          f"the autotune phase did not launch the simplex kernel's cluster variant: {slice8}")
    emit("main_path_summary", path="slice8_autotune", launches=slice8)
    del part, off
    watch.__exit__()
    check(watch.raised == fault_raised,
          f"{watch.raised - fault_raised} dispatch rounds raised outside the fault cases")
    del type1, shared1, pdhg_batch
    torch.cuda.empty_cache()
    roofline_case(timer, dev)

    # Slice 9, the LM serve path: gemma2-2b at full width (no kernel of the
    # port on it; the counts must not move).
    reset_counts()
    lm_phase(rt_configs, dev, seed=args.seed, counters=counters)

    # Slice 10, MoE with the LP router and MLA: deepseek-v2-lite-16b at full
    # width; its main path (``lm_moe_serve``) launches the simplex kernel
    # once a MoE layer a call under router="lp".
    reset_counts()
    moe = lm_moe_phase(rt_configs, dev, seed=args.seed, counters=counters, reset=reset_counts)
    slice10 = moe["launches"]
    check(slice10["simplex"] > 0, f"the MoE path never launched the simplex kernel: {slice10}")

    launches = {k: slice1[k] + slice2[k] + slice3[k] + slice6[k] + slice7[k] + slice8[k]
                + slice10[k] for k in slice1}

    def entry(name, source, replaces, row, n, **extra):
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}", launches=n,
                    max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None,
                    serve_path_launches=slice7[f"{name}.{extra['variant']}" if "variant" in extra
                                               else name], **extra)

    # The global variant's row: type 1's LPs, timed beside the cluster
    # variant in the same case (the same bits, so the same error and bound).
    s_glob = dict(s_main, kernel_ms=s_main["global_ms"])
    r_glob = dict(r_main, kernel_ms=r_main["global_ms"])
    revised_variants = [
        entry("revised", "revised.cu", "revised_pallas.py:56", r_main,
              launches["revised.resident"], variant="resident", cases=CASES["revised.resident"]),
        entry("revised", "revised.cu", "revised_pallas.py:56", r_glob,
              launches["revised.global"], variant="global", cases=CASES["revised.global"],
              past_the_resident_budget_ms=r_global["kernel_ms"]),
    ]
    simplex_variants = [
        entry("simplex", "simplex.cu", "simplex_pallas.py:53", s_main,
              launches["simplex.cluster"], variant="cluster", cases=CASES["simplex.cluster"]),
        entry("simplex", "simplex.cu", "simplex_pallas.py:53", s_glob,
              launches["simplex.global"], variant="global", cases=CASES["simplex.global"]),
    ]
    pdhg_variants = [
        entry("pdhg", "pdhg.cu", "pdhg_pallas.py:62", p_main, launches["pdhg.cluster"],
              variant="cluster", cases=CASES["pdhg.cluster"]),
        entry("pdhg", "pdhg.cu", "pdhg_pallas.py:62", p_stream, launches["pdhg.streaming"],
              variant="streaming", cases=CASES["pdhg.streaming"],
              auto_cap_ms=stream_auto_ms),
    ]
    print(json.dumps({"kernels": [
        entry("simplex", "simplex.cu", "simplex_pallas.py:53", s_main, launches["simplex"],
              variants=simplex_variants, lm_router=moe["router"]),
        entry("hyperbox", "hyperbox.cu", "hyperbox_pallas.py:20", h_main, launches["hyperbox"],
              gb_per_s=h_main["gb_per_s"]),
        entry("revised", "revised.cu", "revised_pallas.py:56", r_main, launches["revised"],
              variants=revised_variants),
        entry("pdhg", "pdhg.cu", "pdhg_pallas.py:62", p_main, launches["pdhg"],
              variants=pdhg_variants),
    ]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
