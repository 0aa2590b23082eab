#!/usr/bin/env python3
"""What the mamba mixer's head split plans for a rank over the model axis.

    python3 tools/ssm_mesh_split.py [--src DIR] [--label NAME]

The meta-device planner (``launch/dryrun.py:lower_cell``) on
``decode_32k`` at full width, rank 0 of ``{"data": 1, "model": 1}`` and
of ``{"data": 1, "model": 4}``, for mamba2-130m and zamba2-7b: one JSON
line a record with its dot FLOPs and wire bytes by kind.  Imports
``repro_torch`` from ``DIR/src`` (default: this checkout), so a parent
tree unpacked beside it can be planned the same way.  No card is
needed.  A rank's measured bytes on the card are ``chip_smoke.py``'s
slice-14 SSM rows (``tools/mixer_spy.py:lm_mesh_mixer_step``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-130m", "zamba2-7b")


def plan(args) -> None:
    sys.path.insert(0, os.path.join(args.src, "src"))
    from repro_torch.launch import dryrun

    for arch in ARCHS:
        for model in (1, 4):
            rec, _ = dryrun.lower_cell(arch, "decode_32k", mesh_override={"data": 1,
                                                                          "model": model})
            print(json.dumps({"label": args.label, "src": args.src, "arch": arch,
                              "shape": "decode_32k", "mesh": rec["mesh"], "rank": rec["rank"],
                              "dot_flops": rec["flops_per_device"],
                              "collective_bytes": rec["collective_bytes_per_device"]}),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT), help="the tree whose repro_torch is planned")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    args.src = os.path.abspath(args.src)
    plan(args)


if __name__ == "__main__":
    main()
