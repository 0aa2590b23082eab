#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each; any failure exits non-zero before the last
line is printed:

1. environment: torch and CUDA versions, the card, its power limit, TF32 off;
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
   times;
4. the main paths, each read with the launch counts set to 0 just before
   it.  Slice 1, the dense and box path at the paper's sizes through
   ``repro_torch.solve``: type 1 (100x100, 50,000 LPs), type 2 (200x100
   infeasible start, 10,000 LPs), hyperbox 4,000,000 x 5 and
   6,000,000 x 28, and one heterogeneous list.  Slice 2, the shared-A
   path: the two paper classes as ``SharedLPBatch``es through
   ``repro_torch.solve``, and the paper's reachability runs (5-dim and
   helicopter, 200 steps) through ``reach_supports`` on the revised
   kernel's warm sweep.  Launch counts, statuses, pivots, memory, and
   samples held against the float64 oracle or the hyperbox path; then,
   with the counts read, each slice-2 row's call timed five more times.
   Slice 3, the first-order path: 256 LPs of 500x500 through
   ``backend="auto"`` (one PDHG launch, no simplex launch), the same
   batch with ``crossover=True``, and a list of 100x100 and 500x500 LPs
   through ``"auto"``; a 32-LP sample held against HiGHS in float64.
   After its counts are read, the same batch on the simplex kernel
   (``backend="cuda"``), for the routing frontier.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
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


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.is_floating_point() or a.numel() == 0:
        return 0.0
    same = (a == b) | (a.isnan() & b.isnan())
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def simplex_case(timer, *, name, batch, rule="lpc", seed=0, layout="compact", chain=None,
                 basis0=None, reps=3):
    """One simplex case: the kernel against its plain version, then timed.

    ``batch`` is a canonical ``LPBatch`` on the card: the main path's own
    LPs where the case stands for a main-path launch.  ``basis0`` warm
    starts the tableau, as crossover does.
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
    cap = resolve_cap(0, m, n) if chain is None else sum(chain)

    def fresh():
        return tab.clone(), basis.clone(), phase.clone()

    kw = dict(spec=spec, rule=rule, seed=seed, tol=tol)
    k_state = fresh()
    k_out = simplex_cuda.simplex(*k_state, c_ext, feas, cap, **kw)
    timer.sync()
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
    identical = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
    err = max(max_abs_diff(a, b) for a, b in pairs)
    ms = timer(lambda t, b_, p: simplex_cuda.simplex(t, b_, p, c_ext, feas, cap, **kw),
               reps=reps, setup=fresh)
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
               chain=chain, warm=basis0 is not None, bit_identical=identical, max_abs_err=err, kernel_ms=ms,
               plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes",
               pivots=pivots, max_pivots=int(iters.max()),
               status_counts=np.bincount(status.cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="simplex", **row)
    check(identical, f"simplex kernel differs from its plain version in case {name}")
    return row


def hyperbox_case(dev, timer, *, name, bsz, n, dtype, data_seed, reps=20):
    from repro_torch.kernels import hyperbox_cuda

    lo, hi, d = chunked_hyperbox(np.random.default_rng(data_seed), bsz, n, dtype, dev)
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
    nbytes = (3 * bsz * n + bsz) * item
    flops = 2 * bsz * n
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[d.dtype]
    row = dict(case=name, batch=bsz, n=n, dtype=str(d.dtype), within_tolerance=ok, rtol=rtol,
               max_abs_err=float(err.max()), max_rel_err_of_abs_sum=float((err / scale).max()),
               kernel_ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes")
    emit("kernel_vs_plain", kernel="hyperbox", **row)
    check(ok, f"hyperbox kernel outside tolerance in case {name}")
    return row


def revised_work(m, n, pivots, pricing_steps):
    """Flops the revised simplex needs: every step prices (y, w.A, the
    phase-I value), every pivot adds u, the ratio divides and the rank-1
    update of binv and xb."""
    return pricing_steps * (2 * m * m + 2 * m * n + 2 * m) + pivots * (4 * m * m + 4 * m)


def revised_case(timer, *, name, sb, rule="lpc", seed=0, chain=None, basis0=None, reps=3):
    """One revised case: the kernel against its plain version, then timed.

    ``sb`` is a ``SharedLPBatch`` on the card, the main path's own LPs
    where the case stands for a main-path launch.
    """
    from repro_torch.core import engine, revised
    from repro_torch.core.simplex import resolve_cap
    from repro_torch.kernels import ops, revised_cuda

    a, b, c = sb.a, sb.b, sb.c
    bsz, m, n = sb.batch, sb.m, sb.n
    state = revised.init_traced(a, b, basis0)
    feas = engine.phase1_feasibility_tol(b).contiguous()
    tol = engine.default_tolerance(a.dtype)
    cap = resolve_cap(0, m, n) if chain is None else sum(chain)

    def fresh():
        return [t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]

    kw = dict(rule=rule, seed=seed, tol=tol)
    k_state = fresh()
    k_out = list(revised_cuda.revised(a, b, c, *k_state, feas, cap, **kw))
    timer.sync()
    p_state = fresh()
    t0 = time.perf_counter()
    p_out = list(revised_cuda.revised_plain(a, b, c, *p_state, feas, cap, **kw))
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    k_obj = revised.objective(k_state[1], k_state[2], c, k_out[1])
    p_obj = revised.objective(p_state[1], p_state[2], c, p_out[1])
    pairs = list(zip([k_obj] + k_out + k_state, [p_obj] + p_out + p_state))
    if chain is not None:
        # The same LPs as a resumed chain of kernel launches, caps K1 + K2.
        part, st = ops.revised_solve(a, b, c, rule=rule, seed=seed, max_iters=chain[0],
                                     want_state=True)
        rest, st = ops.revised_resume(a, b, c, st, rule=rule, seed=seed, max_iters=chain[1])
        pairs += [(rest.objective, k_obj), (rest.x, k_out[0]), (rest.status, k_out[1]),
                  (part.iterations + rest.iterations, k_out[2]), (st.binv, k_state[0]),
                  (st.basis, k_state[1]), (st.xb, k_state[2]), (st.phase, k_state[3])]
    identical = all(torch.equal(bits(x), bits(y)) for x, y in pairs)
    err = max(max_abs_diff(x, y) for x, y in pairs)
    del p_state, p_out
    ms = timer(lambda *st: revised_cuda.revised(a, b, c, *st, feas, cap, **kw), reps=reps,
               setup=fresh)
    iters = k_out[2].to(torch.int64)
    pivots = int(iters.sum())
    # Each LP prices once more than it pivots, and once more again when it
    # enters phase II.
    flops = revised_work(m, n, pivots, pivots + bsz + int((state.phase == 1).sum()))
    item = a.element_size()
    nbytes = ((m * n + bsz * (m + n + 2 * m * m + 2 * m + 1 + n)) * item
              + bsz * (2 * m + 2 + 2) * 4)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[a.dtype]
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(a.dtype), rule=rule, chain=chain,
               warm=basis0 is not None, bit_identical=identical, max_abs_err=err,
               kernel_ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes", pivots=pivots,
               max_pivots=int(iters.max()),
               status_counts=np.bincount(k_out[1].cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="revised", **row)
    check(identical, f"revised kernel differs from its plain version in case {name}")
    return row


def sweep_case(timer, dev, *, name, model, kind, steps, reps=3):
    """The reach row's warm sweep: ``revised_sweep`` (one kernel launch per
    step) against the plain ``sweep_batched``, on the same inputs."""
    from repro_torch.core import reach, revised, support
    from repro_torch.kernels import ops

    dirs = support.template_directions(model.dim, kind)
    stack = reach.direction_stack(model, 0.02, steps, dirs).astype(np.float32)
    sb, c_stack = support.box_to_polytope(model.x0).shared_sweep_inputs(stack, device=dev)
    k_out = ops.revised_sweep(sb.a, sb.b, c_stack)
    timer.sync()
    t0 = time.perf_counter()
    p_out = revised.sweep_batched(sb.a, sb.b, c_stack)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    identical = all(torch.equal(bits(x), bits(y)) for x, y in zip(k_out, p_out))
    err = max(max_abs_diff(x, y) for x, y in zip(k_out, p_out))
    ms = timer(lambda: ops.revised_sweep(sb.a, sb.b, c_stack), reps=reps)
    m, n, bsz = sb.m, sb.n, sb.batch
    pivots = int(k_out[3].to(torch.int64).sum())
    flops = revised_work(m, n, pivots, pivots + steps * bsz)
    item = sb.a.element_size()
    nbytes = (m * n + bsz * m + c_stack.numel() + steps * bsz * (1 + n)) * item \
        + steps * bsz * 2 * 4
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[sb.a.dtype]
    row = dict(case=name, steps=steps, batch=bsz, m=m, n=n, dtype=str(sb.a.dtype),
               launches_per_run=steps, bit_identical=identical, max_abs_err=err, kernel_ms=ms,
               plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes", pivots=pivots,
               status_counts=np.bincount(k_out[2].flatten().cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="revised_sweep", **row)
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


def pdhg_case(timer, *, name, batch, cap, full, reps=1, eager=False):
    """The PDHG kernel against its plain version on the same LPs and step sizes.

    ``full=False`` (a short cap): statuses and steps equal per LP and the
    state within PDHG_XTOL / PDHG_STATE_RTOL.  ``full=True`` (the auto
    cap): statuses equal on every LP both decide, at most 1% of the LPs
    decided by one side only, objectives within 1e-3 relative where both
    are OPTIMAL.  Kernel ms is the compared launch's (CUDA events; the
    library is loaded before), or the median of ``reps`` more launches.
    ``eager`` also runs the plain loop without its CUDA graph: the same
    bits, and what the graph saves.  Returns ``(row, status, state)`` of
    the kernel's launch.
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
        return pdhg_cuda.pdhg(a, b, c, state, tau, sigma, scales, cap, **kw)

    if a.is_cuda:
        build.load("pdhg")
    k_state = fresh()[0]
    k_out = []
    ms = timer(lambda: k_out.append(launch(k_state)))
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
               kernel_ms=ms, plain_ms=plain_ms, **graph_check,
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
        return row, k_status, k_state
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
    return row, k_status, k_state


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
    before = {k: mod.launches for k, mod in counters.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(problem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: mod.launches - before[k] for k, mod in counters.items()}
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
    before = {k: mod.launches for k, mod in counters.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(sb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: mod.launches - before[k] for k, mod in counters.items()}
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
    before = {k: mod.launches for k, mod in counters.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup, _ = reach.reach_supports(model, 0.02, steps, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: mod.launches - before[k] for k, mod in counters.items()}
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
    check(delta["revised"] > 0 and delta["hyperbox"] > 0,
          f"row {name} did not launch both the revised and the hyperbox kernel: {delta}")
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
    before = {k: mod.launches for k, mod in counters.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = rt.solve(problems)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: mod.launches - before[k] for k, mod in counters.items()}
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

    before = {k: mod.launches for k, mod in counters.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Spans([(ops, "pdhg_solve"), (pdhg, "confirm_certificates"), (pdhg, "crossover")]) as sp:
        t0 = time.perf_counter()
        sol = rt.solve(batch, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    delta = {k: mod.launches - before[k] for k, mod in counters.items()}
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
               spans_s=sp.seconds, span_calls=sp.calls,
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
    return row, sol


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
    before = {k: mod.launches for k, mod in counters.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = rt.solve(problems, rt.SolveOptions(backend="auto"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: mod.launches - before[k] for k, mod in counters.items()}
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
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: FAILED: the port is not beside this script: {exc}")
    dev = torch.device("cuda")
    timer = Timer(dev)

    # -- 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # -- 2. build
    t0 = time.perf_counter()
    builds = build.compile_all()
    emit("build", wall_s=time.perf_counter() - t0,
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

    s_main = simplex_case(timer, name="type1_50000x100x100_f32_lpc",
                          batch=paper_batch(50_000, 100, 100, True, args.seed))
    simplex_case(timer, name="type2_10000x200x100_f32_lpc",
                 batch=paper_batch(10_000, 200, 100, False, args.seed + 1))
    torch.cuda.empty_cache()
    for bucket in bucket_problems(hetero_problems(rt, args.seed + 4, HETERO_PER_CLASS)[0]):
        m, n = bucket.key[:2]
        simplex_case(timer, name=f"list_bucket_{m}x{n}_f32_lpc",
                     batch=canonicalize(bucket.problem).batch)
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

    r_main = revised_case(timer, name="shared_type1_50000x100x100_f32_lpc",
                          sb=shared_batch(50_000, 100, 100, True, args.seed + 30))
    torch.cuda.empty_cache()
    revised_case(timer, name="shared_type2_10000x200x100_f32_lpc",
                 sb=shared_batch(10_000, 200, 100, False, args.seed + 31))
    torch.cuda.empty_cache()
    revised_case(timer, name="shared_256x28x28_f64_bland", rule="bland",
                 sb=shared_batch(256, 28, 28, True, args.seed + 32, np.float64))
    revised_case(timer, name="shared_256x28x28_f32_rpc_seed7", rule="rpc", seed=7,
                 sb=shared_batch(256, 28, 28, True, args.seed + 33))
    revised_case(timer, name="shared_chain_256x40x20_f32_lpc", chain=(25, 175),
                 sb=shared_batch(256, 40, 20, False, args.seed + 34))
    warm = shared_batch(256, 30, 30, True, args.seed + 35)
    basis0 = ops.revised_solve(warm.a, warm.b, warm.c).basis.clone()
    basis0[:4, 1] = basis0[:4, 0]  # four singular bases: those rows start cold
    revised_case(timer, name="shared_warm_256x30x30_f32_lpc_4_singular", sb=warm,
                 basis0=basis0)
    reach_steps = 200
    # The reach rows' input-set supports: 200 steps x 50 (5-dim, oct) and
    # x 56 (helicopter, box) directions.
    hyperbox_case(dev, timer, name="reach_10000x5_f32", bsz=10_000, n=5, dtype=torch.float32,
                  data_seed=args.seed + 36)
    hyperbox_case(dev, timer, name="reach_11200x28_f32", bsz=11_200, n=28,
                  dtype=torch.float32, data_seed=args.seed + 37)
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
    slice1 = {k: mod.launches for k, mod in counters.items()}
    check(slice1["simplex"] > 0 and slice1["hyperbox"] > 0,
          f"a kernel of the slice-1 path was never launched: {slice1}")
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
    slice2 = {k: mod.launches for k, mod in counters.items()}
    check(slice2 == {k: sum(r["launches"][k] for r in rows2) for k in counters},
          f"slice-2 launches {slice2} are not the sum of its rows'")
    check(slice2["revised"] > 0 and slice2["hyperbox"] > 0,
          f"a kernel of the slice-2 path was never launched: {slice2}")
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
    pdhg_case(timer, name=f"{PDHG_LPS}x{PDHG_DIM}x{PDHG_DIM}_f32_cap400", batch=pdhg_batch,
              cap=400, full=False, reps=3, eager=True)
    pdhg_chain_case(name=f"{PDHG_LPS}x{PDHG_DIM}x{PDHG_DIM}_f32", batch=pdhg_batch)
    p_main, p_main_status, _ = pdhg_case(
        timer, name=f"{PDHG_LPS}x{PDHG_DIM}x{PDHG_DIM}_f32_auto_cap", batch=pdhg_batch,
        cap=auto_cap_pdhg(PDHG_DIM, PDHG_DIM), full=True)
    pdhg_case(timer, name="64x200x200_f64_cap2000", cap=2000, full=False, reps=3,
              batch=paper_batch(64, 200, 200, True, args.seed + 41, torch.float64))
    cert = certificate_batch(dev)
    _, cert_status, _ = pdhg_case(timer, name="certificates_4x100x100_f32", batch=cert,
                               cap=20_000, full=True)
    confirmed = rt.solve(cert, rt.SolveOptions(backend="pdhg", max_iters=20_000)).status
    emit("certificates", case="4x100x100_rows_0_1_unbounded",
         kernel_status=cert_status.tolist(), confirmed_status=confirmed.tolist())
    check(cert_status[:2].tolist() == [2, 2] and confirmed[:2].tolist() == [2, 2],
          "pdhg kernel: the constructed rays are not certified UNBOUNDED")
    del cert
    torch.cuda.empty_cache()

    highs = [f.result() for f in highs_futures]
    reset_counts()
    auto_row, auto_sol = pdhg_row(rt, name=f"pdhg_auto_{PDHG_DIM}x{PDHG_DIM}", batch=pdhg_batch,
                                  options=rt.SolveOptions(backend="auto"), counters=counters,
                                  highs=highs, rtol=5e-3)
    check(auto_row["launches"]["pdhg"] == 1 and auto_row["launches"]["simplex"] == 0,
          f"pdhg_auto launched {auto_row['launches']} (one pdhg launch, no simplex expected)")
    cross_row, _ = pdhg_row(rt, name=f"pdhg_crossover_{PDHG_DIM}x{PDHG_DIM}", batch=pdhg_batch,
                            options=rt.SolveOptions(backend="auto", crossover=True),
                            counters=counters, highs=highs, rtol=1e-4,
                            base_iters=auto_sol.iterations.cpu().numpy().astype(np.int64))
    check(cross_row["launches"]["pdhg"] > 0 and cross_row["launches"]["simplex"] > 0,
          f"pdhg_crossover launched {cross_row['launches']}")
    torch.cuda.empty_cache()
    rows3 = [auto_row, cross_row, auto_list_row(rt, dev, seed=args.seed + 42, counters=counters,
                                                 per_class=HETERO_PER_CLASS)]
    slice3 = {k: mod.launches for k, mod in counters.items()}
    check(slice3 == {k: sum(r["launches"][k] for r in rows3) for k in counters},
          f"slice-3 launches {slice3} are not the sum of its rows'")
    check(slice3["pdhg"] > 0 and slice3["simplex"] > 0,
          f"a kernel of the slice-3 path was never launched: {slice3}")
    emit("main_path_summary", path="slice3_first_order", launches=slice3, rows=len(rows3))
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
    simplex_case(timer, name=f"crossover_tile_{opt.numel()}x{PDHG_DIM}x{PDHG_DIM}_f32_warm",
                 batch=tile, basis0=pdhg.crossover_basis(tile.a, tile.b, auto_sol.x[opt]),
                 reps=1)
    del tile
    crossover_tiles(batch=pdhg_batch, sol=auto_sol, small=8)
    del auto_sol
    launches = {k: slice1[k] + slice2[k] + slice3[k] for k in counters}

    print(json.dumps({"kernels": [
        dict(name="simplex", route="cuda", source="src/repro_torch/kernels/csrc/simplex.cu",
             replaces="src/repro/kernels/simplex_pallas.py:53", launches=launches["simplex"],
             max_abs_err=s_main["max_abs_err"], ms=s_main["kernel_ms"],
             plain_ms=s_main["plain_ms"], bound_ms=s_main["bound_ms"],
             bound_by=s_main["bound_by"], library_ms=None),
        dict(name="hyperbox", route="cuda", source="src/repro_torch/kernels/csrc/hyperbox.cu",
             replaces="src/repro/kernels/hyperbox_pallas.py:20", launches=launches["hyperbox"],
             max_abs_err=h_main["max_abs_err"], ms=h_main["kernel_ms"],
             plain_ms=h_main["plain_ms"], bound_ms=h_main["bound_ms"],
             bound_by=h_main["bound_by"], library_ms=None),
        dict(name="revised", route="cuda", source="src/repro_torch/kernels/csrc/revised.cu",
             replaces="src/repro/kernels/revised_pallas.py:56", launches=launches["revised"],
             max_abs_err=r_main["max_abs_err"], ms=r_main["kernel_ms"],
             plain_ms=r_main["plain_ms"], bound_ms=r_main["bound_ms"],
             bound_by=r_main["bound_by"], library_ms=None),
        dict(name="pdhg", route="cuda", source="src/repro_torch/kernels/csrc/pdhg.cu",
             replaces="src/repro/kernels/pdhg_pallas.py:62", launches=launches["pdhg"],
             max_abs_err=p_main["max_abs_err"], ms=p_main["kernel_ms"],
             plain_ms=p_main["plain_ms"], bound_ms=p_main["bound_ms"],
             bound_by=p_main["bound_by"], library_ms=None),
    ]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
