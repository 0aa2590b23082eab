#!/usr/bin/env python3
"""Time the PDHG certificate confirmation sequentially, on threads and on processes.

    python3 tools/confirmation_workers.py [--seed 0]

Needs one CUDA device.  Builds ``chip_smoke.py``'s slice-3 batch (256 LPs
of 500x500, float32, the same seed), runs the PDHG kernel at the auto cap
and takes the rows it flags UNBOUNDED or INFEASIBLE: the work of
``core/pdhg.py:confirm_certificates``.  Then the float64 oracle confirms
those rows under the confirmation's budget three ways, in one process:
sequentially (``oracle.solve_batch``), on ``os.cpu_count()`` host threads
(``pdhg.oracle_statuses``, what the port runs) and on as many spawned
processes (the pool's start-up included, as a call would pay it).  The
three must give the same statuses.  Prints one JSON line with the
seconds of each.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _oracle_status(args):
    from repro_torch.core import oracle

    a, b, c, cap = args
    return oracle.solve_lp(a, b, c, cap)[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("confirmation_workers: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import HIGHS_SAMPLE, PDHG_DIM, PDHG_LPS, chunked_lp_batch
    from repro_torch.core import oracle, pdhg
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, c, _ = chunked_lp_batch(np.random.default_rng(args.seed + 40), PDHG_LPS, PDHG_DIM,
                                  PDHG_DIM, True, torch.float32, dev, chunk=HIGHS_SAMPLE)
    status = ops.pdhg_solve(a, b, c).status.cpu().numpy()
    flagged = np.nonzero((status == 2) | (status == 3))[0]
    rows = torch.as_tensor(flagged, device=dev)
    a64, b64, c64 = (t[rows].cpu().double().numpy() for t in (a, b, c))
    cap = max(400, 2 * (PDHG_DIM + PDHG_DIM))
    workers = os.cpu_count() or 1

    t0 = time.perf_counter()
    seq = oracle.solve_batch(a64, b64, c64, max_iters=cap)[2]
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    thr = pdhg.oracle_statuses(a64, b64, c64, cap, workers)
    thr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        proc = np.asarray(list(pool.map(_oracle_status, [(a64[i], b64[i], c64[i], cap)
                                                         for i in range(len(flagged))])))
    proc_s = time.perf_counter() - t0
    same = bool(np.array_equal(seq, thr) and np.array_equal(seq, proc))
    print(json.dumps(dict(case="confirmation_workers", flagged=int(flagged.size),
                          statuses=seq.tolist(), cpu_count=workers, sequential_s=seq_s,
                          threads_s=thr_s, processes_s=proc_s, statuses_equal=same)),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
