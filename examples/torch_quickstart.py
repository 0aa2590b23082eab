"""Quickstart for the PyTorch/CUDA port's ``repro_torch.solve`` front door.

The twin of ``examples/quickstart.py``: a general-form problem, a batch of
canonical LPs, a heterogeneous list, the closed-form hyperbox path, the
backends of the registry, shared-structure batches, and compaction rounds
in a ``SolveSession``.  Runs on the card by default; pass ``--device cpu``
to run the kernels' plain PyTorch versions on the CPU.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch import LPProblem, SolveOptions
from repro_torch.core import lp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="'cpu', or the card (default)")
    args = ap.parse_args()
    dev = args.device
    rng = np.random.default_rng(0)

    # 1) General form: minimize c.x s.t. bl <= Ax <= bu, lo <= x <= hi.
    p = LPProblem.make(
        c=[2.0, 1.0, -1.0],
        a=[[1.0, 1.0, 1.0], [1.0, -1.0, 0.0]],
        bl=[3.0, -np.inf],
        bu=[3.0, 2.0],           # the first row is an equality: x1+x2+x3 == 3
        lo=[0.0, 0.0, -np.inf],  # x3 is free
        hi=[2.0, np.inf, 1.0],
        maximize=False,
        device=dev,
    )
    sol = repro_torch.solve(p)
    print(f"general form: objective={float(sol.objective[0]):.3f}, "
          f"x={sol.x[0].cpu().numpy().round(3)}, "
          f"status={lp.STATUS_NAMES[int(sol.status[0])]}")

    # 2) A batch of canonical LPs (the paper's form) goes straight in.
    batch = lp.random_lp_batch(rng, batch=1000, m=28, n=28, feasible_start=True, device=dev)
    sol = repro_torch.solve(batch, SolveOptions(rule="lpc"))
    st = sol.status.cpu().numpy()
    print(f"solved {batch.batch} LPs of size {batch.m}x{batch.n}: "
          f"optimal={int((st == lp.OPTIMAL).sum())}, "
          f"mean iterations={float(sol.iterations.float().mean()):.1f}")

    # 3) A heterogeneous list: shape-class buckets, results in input order.
    problems = []
    for dim in (5, 12, 28, 5, 12, 5):
        b = lp.random_lp_batch(rng, 1, dim, dim, True, device=dev)
        problems.append(LPProblem.make(b.c, b.a, bu=b.b, device=dev))
    sols = repro_torch.solve(problems)
    print(f"heterogeneous list: {len(problems)} LPs -> objectives "
          f"{[round(float(s.objective[0]), 3) for s in sols]}")

    # 4) Hyperbox LPs (paper Sec. 6): closed form.
    lo, hi, dirs = lp.random_hyperbox_batch(rng, 100_000, 5, device=dev)
    box = repro_torch.solve_hyperbox(lo, hi, dirs, device=dev)
    print(f"hyperbox batch: {box.objective.shape[0]} LPs, "
          f"support[:4]={box.objective[:4].cpu().numpy().round(3)}")

    # 5) The backend registry: the same protocol, other engines ("torch" =
    #    the plain lockstep loop, "pdhg" = first-order restarted PDHG with
    #    crossover, "reference" = the sequential float64 oracle).
    small = batch.take(slice(0, 64))
    base = repro_torch.solve(small)
    for name in ("torch", "pdhg", "reference"):
        pdhg = name == "pdhg"  # capped: the plain PDHG loop is slow on the CPU
        other = repro_torch.solve(small, SolveOptions(backend=name, crossover=pdhg,
                                                      max_iters=2000 if pdhg else 0))
        ok = (other.status == lp.OPTIMAL) & (base.status == lp.OPTIMAL)
        agree = torch.allclose(other.objective[ok].double(), base.objective[ok].double(),
                               rtol=1e-4)
        print(f"backend {name!r} agrees with cuda: {agree} "
              f"({int(ok.sum())}/{small.batch} rows optimal on both)")

    # 6) Shared structure: ONE constraint matrix, many c/b (the revised engine).
    shared = lp.random_shared_lp_batch(rng, 64, 12, 6, True, device=dev)
    ssol = repro_torch.solve(shared)
    dense = repro_torch.solve(shared.densify())
    ok = (ssol.status == lp.OPTIMAL) & (dense.status == lp.OPTIMAL)
    print(f"shared batch agrees with the densified one: "
          f"{torch.allclose(ssol.objective[ok], dense.objective[ok], rtol=1e-4)}")

    # 7) Compaction rounds in a session: finished LPs drop out between
    #    rounds and the survivors continue from their exact state, with
    #    the same results as one round.
    sess = repro_torch.SolveSession(SolveOptions(compaction="every_k", resume="basis",
                                                 compact_every=16), device=dev)
    rounds = sess.solve(batch)
    one = repro_torch.solve(batch)
    print(f"compaction: {sess.stats.rounds} rounds, lockstep iterations "
          f"{sess.stats.lockstep_iterations} (one round: "
          f"{int(one.iterations.max()) * batch.batch}), identical to one round: "
          f"{torch.equal(rounds.objective, one.objective)}")


if __name__ == "__main__":
    main()
