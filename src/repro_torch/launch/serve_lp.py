"""Batched-LP serving: megabatch dispatch with straggler mitigation.

Follows ``repro/launch/serve_lp.py``.  LP requests stream in (support
samples from a fleet of reachability workers, say), are bucketed by
shape, megabatched and dispatched in work units; a unit that misses the
straggler deadline is dispatched again and the first result wins
(``runtime/straggler.py``).

Homogeneous mode solves one shape through ``repro_torch.solve(LPBatch)``;
``--mixed-dims`` serves a stream of single-LP problems of several shapes
through the bucketing front end (one ``repro_torch.solve(list)`` a unit).
Everything runs on ``--device`` (default: the card).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve_lp --n-lps 20000 --dim 28 \\
      --units 8 --workers 4
  PYTHONPATH=src python -m repro_torch.launch.serve_lp --device cpu --n-lps 600 \\
      --mixed-dims 5,12,28 --units 4 --workers 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import api
from ..core import lp as lp_mod
from ..core.backends import SolveOptions
from ..core.problem import LPProblem
from ..runtime.straggler import run_with_speculation


def _hetero_requests(rng, n_lps, dims, device):
    """A heterogeneous request stream: one single-LP problem a request."""
    problems = []
    for _ in range(n_lps):
        d = int(rng.choice(dims))
        b = lp_mod.random_lp_batch(rng, 1, d, d, True, device=device)
        problems.append(LPProblem.make(b.c, b.a, bu=b.b, device=device))
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-lps", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=28)
    ap.add_argument("--mixed-dims", default=None,
                    help="comma-separated dims; enables heterogeneous bucketed serving")
    ap.add_argument("--units", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rule", default="lpc", choices=["lpc", "rpc", "bland"])
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch", "reference", "auto"])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--inject-straggler", action="store_true")
    args = ap.parse_args(argv)

    device = lp_mod.resolve_device(args.device)
    rng = np.random.default_rng(0)
    options = SolveOptions(rule=args.rule, backend=args.backend)
    slow_unit = {0} if args.inject_straggler else set()

    if args.mixed_dims:
        dims = [int(d) for d in args.mixed_dims.split(",")]
        problems = _hetero_requests(rng, args.n_lps, dims, device)
        per = -(-len(problems) // args.units)  # ceil: the slices cover every problem
        units = [problems[i * per:(i + 1) * per] for i in range(args.units)]
        units = [u for u in units if u]
        # Warm every shape class (one problem a dim), so unit times are the
        # steady state's.
        warm = [lp_mod.random_lp_batch(rng, 1, d, d, True, device=device) for d in dims]
        api.solve([LPProblem.make(b.c, b.a, bu=b.b, device=device) for b in warm], options)

        def solve_unit(payload, worker):
            if payload is units[0] and 0 in slow_unit and worker == 0:
                time.sleep(1.0)  # injected straggler: the first attempt is slow
            sols = api.solve(payload, options)
            return np.asarray([float(s.objective[0]) for s in sols])
    else:
        batch = lp_mod.random_lp_batch(rng, args.n_lps, args.dim, args.dim, True, device=device)
        api.solve(batch.take(slice(0, 8)), options).objective.cpu()  # warm-up
        per = args.n_lps // args.units
        units = [batch.take(slice(i * per, (i + 1) * per)) for i in range(args.units)]

        def solve_unit(payload, worker):
            if payload is units[0] and 0 in slow_unit and worker == 0:
                time.sleep(1.0)  # injected straggler: the first attempt is slow
            return api.solve(payload, options).objective.cpu().numpy()

    t0 = time.perf_counter()
    report = run_with_speculation(units, solve_unit, n_workers=args.workers, alpha=3.0)
    wall = time.perf_counter() - t0
    n_opt = sum(int(np.isfinite(r.value).sum()) for r in report.results)
    shape_note = f"mixed dims {args.mixed_dims}" if args.mixed_dims else f"dim {args.dim}"
    print(f"solved {args.n_lps} LPs {shape_note} on {device} in {wall:.3f}s "
          f"({args.n_lps / wall:.0f} LP/s), optimal={n_opt}, "
          f"speculative re-dispatches={report.respawned}")


if __name__ == "__main__":
    main()
