#!/usr/bin/env python3
"""What the LM's model-axis layouts plan for a rank over a mesh.

    python3 tools/lm_mesh_plan.py [--src DIR] [--label NAME]

The meta-device planner (``launch/dryrun.py:lower_cell``) at full width
on the cells of ``CELLS``: the head-split mamba mixer's (mamba2-130m and
zamba2-7b ``decode_32k``, rank 0 of ``(1, 1)`` and ``(1, 4)``) and the
sequence-parallel residual stream's (gemma2-2b ``train_4k``, rank 0 of
``(1, 1)`` and ``(16, 16)``).  One JSON line a cell with its dot FLOPs,
its wire bytes by kind, and the bytes remat keeps at the checkpointed
layer inputs (``tools/mixer_spy.py:SavedLayerInputs``: what
``torch.autograd.graph.saved_tensors_hooks`` sees of each layer's input;
0 where the cell runs no backward).  Imports ``repro_torch`` from
``DIR/src`` (default: this checkout), so a parent tree unpacked beside
it can be planned the same way.  No card is needed.  A rank's measured
bytes on the card are ``chip_smoke.py``'s slice-14 SSM rows
(``tools/mixer_spy.py:lm_mesh_mixer_step``) and slice-15
``lm_train_mesh`` rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = tuple((arch, "decode_32k", {"data": 1, "model": m})
              for arch in ("mamba2-130m", "zamba2-7b") for m in (1, 4)) + tuple(
    ("gemma2-2b", "train_4k", {"data": n, "model": n}) for n in (1, 16))


def plan(args) -> None:
    sys.path.insert(0, os.path.join(args.src, "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import mixer_spy
    from repro_torch.launch import dryrun

    for arch, shape, mesh in CELLS:
        with mixer_spy.SavedLayerInputs() as saved:
            rec, _ = dryrun.lower_cell(arch, shape, mesh_override=mesh)
        print(json.dumps({"label": args.label, "src": args.src, "arch": arch,
                          "shape": shape, "mesh": rec["mesh"], "rank": rec["rank"],
                          "dot_flops": rec["flops_per_device"],
                          "collective_bytes": rec["collective_bytes_per_device"],
                          "saved_layer_input_bytes": saved.bytes,
                          "checkpointed_layers": saved.layers}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT), help="the tree whose repro_torch is planned")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    args.src = os.path.abspath(args.src)
    plan(args)


if __name__ == "__main__":
    main()
