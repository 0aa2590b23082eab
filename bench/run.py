"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; ``breakdown`` with ``--trace 1``); the numbers the check
compared, each beside its limit, are the last lines of standard error
and the result's last key.  Without a CUDA card, with fewer cards than
the cell asks for, or with a module of JAX or of the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    try:
        cell = harness.load_cell(args.workload)
    except (harness.SetupError, OSError, KeyError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             t_process=T_PROCESS)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {', '.join(loaded)}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
