#!/usr/bin/env python3
"""What a split type-1 solve costs a rank: one tree's times on gloo ranks that share the card.

    python3 tools/mesh_split_cost.py [--src DIR] [--label NAME] [--ranks 4] [--reps 3]

Needs one CUDA device (``--device cpu --lps 256`` rehearses it).
Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
trees can be timed in one call to the card: run it
once with the parent's tree, twice with the change's and once more with
the parent's.  Spawns ``--ranks`` gloo ranks on a (data=ranks, model=1)
mesh; each is given type 1 (50,000 LPs of 100x100, float32, feasible
start, numpy seed 0) on the host, as ``chip_smoke.py``'s mesh phase gives
it, solves it ``--reps`` times through ``repro_torch.solve(..., mesh=)``
after a small warm-up, and times, on the host clock around a synchronised
call, each solve and ``canonicalize`` of the whole batch alone (the host
work every rank repeats).  Prints one JSON line: per rank the median and
every sample in seconds.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _rank(rank: int, world: int, src: str, store: str, out: str, reps: int, lps: int,
          device: str) -> None:
    sys.path.insert(0, os.path.join(src, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch as rt
    from repro_torch.core.lp import random_lp_batch
    from repro_torch.core.problem import canonicalize
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(2)
    mesh_lib.init_distributed("gloo", device=device, timeout_s=600.0, rank=rank,
                              world_size=world, store=dist.FileStore(store, world))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    parts = [random_lp_batch(rng, min(5000, lps - lo), 100, 100, True, dtype=np.float32,
                             device="cpu") for lo in range(0, lps, 5000)]
    a, b, c = (torch.cat([getattr(p, f) for p in parts]) for f in ("a", "b", "c"))
    problem = rt.LPProblem.make(c, a, bu=b, device="cpu")
    mesh = DeviceMesh(device, torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"))
    small = rt.LPProblem.make(c[:64].clone(), a[:64].clone(), bu=b[:64].clone(), device="cpu")
    rt.solve(small, mesh=mesh)
    solve_s, canon_s = [], []
    for _ in range(reps):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        rt.solve(problem, mesh=mesh)
        sync()
        solve_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        canonicalize(problem)
        canon_s.append(time.perf_counter() - t0)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(dict(solve_s=solve_s, canonicalize_s=canon_s), fh)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default=None)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--lps", type=int, default=50_000, help="fewer for a rehearsal")
    ap.add_argument("--device", default="cuda", help='"cpu" for a rehearsal')
    args = ap.parse_args()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, args.ranks, args.src,
                                                 os.path.join(tmp, "store"), tmp, args.reps,
                                                 args.lps, args.device))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + args.timeout
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r in range(args.ranks):
            path = os.path.join(tmp, f"rank{r}.json")
            if not os.path.exists(path):
                print(f"rank {r} wrote no result (exit code {procs[r].exitcode})",
                      file=sys.stderr)
                return 1
            with open(path) as fh:
                got = json.load(fh)
            ranks.append({k: dict(median=float(np.median(v)), samples=v) for k, v in got.items()})
    print(json.dumps(dict(tool="mesh_split_cost", label=args.label or args.src,
                          ranks=ranks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
