#!/usr/bin/env python3
"""What the row-local reductions cost: one tree's times on the paths they touch.

    python3 tools/row_local_cost.py [--src DIR] [--label NAME] [--reps N]

Needs one CUDA device.  Imports ``repro_torch`` from ``DIR/src`` (default:
this checkout), so two trees can be timed in one process each, in one call
to the card: run it once with the parent's tree, twice with the change's
and once more with the parent's.  On the same LPs each time (numpy seeds):

* ``step_sizes`` on 64 LPs of 500x500 float32 (the batch of the slice-6
  PDHG rounds), and on 3 and 16 of them (serve-loop group sizes);
* ``uncanonicalize`` on those 64 LPs and on 10,000 LPs of 100x100;
* ``repro_torch.solve`` of the 64 LPs on ``backend="pdhg"`` at cap 400,
  compaction ``"off"`` and ``"every_k"`` + ``"basis"`` every 50 steps (the
  slice-6 PDHG rounds of ``chip_smoke.py``);
* the dense warm sweep of the five-dimensional reach model (octagon
  directions, 200 steps): ``Polytope.support_sweep`` and the per-step loop
  ``Polytope.step_sweep`` (``chip_smoke.py:dense_sweep_case``).

Each is run once to warm up, then ``--reps`` times; the line holds the
median and every sample in milliseconds (host clock around a synchronised
call).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _timed(fn, reps, torch):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return dict(median_ms=float(np.median(out)), samples_ms=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT), help="root of the tree to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("row_local_cost: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch as rt
    from repro_torch.core import pdhg, reach, support
    from repro_torch.core.lp import LPSolution, random_lp_batch
    from repro_torch.core.problem import LPProblem, canonicalize, uncanonicalize

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    reps = args.reps
    out = dict(case="row_local_cost", label=args.label, src=str(Path(rt.__file__).parent),
               device=torch.cuda.get_device_name(0), reps=reps)

    b64 = random_lp_batch(np.random.default_rng(40), 64, 500, 500, True, device=dev)
    for k in (64, 16, 3):
        a, b, c = b64.a[:k].contiguous(), b64.b[:k].contiguous(), b64.c[:k].contiguous()
        out[f"step_sizes_{k}x500x500"] = _timed(lambda: pdhg.step_sizes(a, b, c), reps, torch)

    type1 = random_lp_batch(np.random.default_rng(0), 10_000, 100, 100, True, device=dev)
    for name, lps in (("64x500x500", b64), ("10000x100x100", type1)):
        canon = canonicalize(LPProblem.from_batch(lps))
        bsz, n = canon.batch.a.shape[0], canon.batch.a.shape[2]
        gen = torch.Generator(device="cpu").manual_seed(1)
        sol = LPSolution(objective=torch.zeros(bsz, device=dev),
                         x=torch.rand(bsz, n, generator=gen).to(dev),
                         status=torch.ones(bsz, dtype=torch.int32, device=dev),
                         iterations=torch.zeros(bsz, dtype=torch.int32, device=dev))
        out[f"uncanonicalize_{name}"] = _timed(lambda: uncanonicalize(canon, sol), reps, torch)
    del type1

    base = rt.SolveOptions(backend="pdhg", max_iters=400, compact_every=50)
    for mode, resume in (("off", "scratch"), ("every_k", "basis")):
        opts = base.replace(compaction=mode, resume=resume)
        out[f"pdhg_rounds_64x500x500_cap400_{mode}"] = _timed(
            lambda: rt.solve(b64, opts), reps, torch)

    model = reach.five_dim_model()
    dirs = support.template_directions(model.dim, "oct")
    stack = reach.direction_stack(model, 0.02, 200, dirs).astype(np.float32)
    poly = support.box_to_polytope(model.x0)
    opts = rt.SolveOptions()
    for name, fn in (("sweep_problems", poly.support_sweep), ("per_step_loop", poly.step_sweep)):
        out[f"dense_sweep_five_dim_{name}"] = _timed(
            lambda: fn(stack, opts, device=dev), reps, torch)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
