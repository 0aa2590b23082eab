"""Reachability analysis (paper Sec. 7) on the PyTorch/CUDA port.

The twin of ``examples/reachability.py``: the reachable-set flowpipe of
the 5-dim system and the 28-dim helicopter stand-in by support-function
sampling, every sample an LP.  The input set's supports run as the dense
warm sweep (``core/session.py:sweep_problems``: one simplex launch a
step, each warm from the last step's basis).  Runs on the card by
default; pass ``--device cpu`` for the plain PyTorch versions.

  PYTHONPATH=src python examples/torch_reachability.py [--steps 200] [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch import SolveOptions
from repro_torch.core import reach
from repro_torch.core.support import template_directions


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--delta", type=float, default=0.02)
    ap.add_argument("--device", default=None, help="'cpu', or the card (default)")
    args = ap.parse_args()

    for name, sys_ in (
        ("five-dim model", reach.five_dim_model()),
        ("helicopter controller (28-dim)", reach.helicopter_model()),
    ):
        dirs = template_directions(sys_.dim, "oct" if sys_.dim <= 8 else "box")
        n_lps = reach.count_lps(args.steps, len(dirs), point_input=True)
        t0 = time.perf_counter()
        sup, _ = reach.reach_supports(sys_, args.delta, args.steps, directions=dirs,
                                      options=SolveOptions(), use_hyperbox=False,
                                      warm_start=True, device=args.device)
        dt = time.perf_counter() - t0
        k = sys_.dim
        upper = sup[:, :k].max(axis=0)
        lower = -sup[:, k : 2 * k].max(axis=0)
        print(f"{name}: {args.steps} steps x {len(dirs)} directions "
              f"= {n_lps} LPs in {dt:.3f}s ({n_lps / dt:.0f} LP/s)")
        print(f"  reach envelope dim0: [{lower[0]:+.4f}, {upper[0]:+.4f}]")
        print(f"  volume proxy (box): {float(np.prod(np.maximum(upper - lower, 1e-9))):.3e}")


if __name__ == "__main__":
    main()
