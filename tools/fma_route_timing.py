#!/usr/bin/env python3
"""Time the simplex kernel's float32 rank-1 update: the kept route against ``__fmaf_rn``.

    python3 tools/fma_route_timing.py [--seed 0] [--reps 3]

The kept kernel computes ``a - b * c`` in float64 and rounds once to
float32 (``kernels/csrc/common.cuh:Arith<float>::fms``), bit for bit as
the plain version (``core/engine.py:rank1_update``).  This script builds a
second library from a copy of the sources in which that line is
``__fmaf_rn(-b, c, a)`` (one true FMA), in a temporary directory that is
deleted afterwards, and times both libraries in one process on the
paper's type 1 (50,000 LPs of 100x100) and type 2 (10,000 LPs of 200x100,
infeasible start) batches of ``chip_smoke.py``, float32, lpc, default
variant (kernel ms by CUDA events, the order kept, fma, fma, kept).  It
also counts the LPs on which the FMA build ends with another status,
pivot count or basis than the kept one.  Prints one JSON line per type,
then the ``nvidia-smi`` name and power limit.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KEPT = ("return __double2float_rn(__dsub_rn((double)a, __dmul_rn((double)b, (double)c)));")
FMA = "return __fmaf_rn(-b, c, a);"


def build_fma_library(tmp: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build

    csrc = tmp / "csrc"
    shutil.copytree(build.CSRC, csrc)
    common = csrc / "common.cuh"
    text = common.read_text()
    if text.count(KEPT) != 1:
        raise SystemExit("fma_route_timing: the kept float rank-1 update was not found")
    common.write_text(text.replace(KEPT, FMA))
    out = tmp / "simplex_fma.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(csrc / "simplex.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"fma_route_timing: nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fma_route_timing: needs a CUDA device")
    import chip_smoke
    from repro_torch.core import engine
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.simplex import phase2_costs, resolve_cap
    from repro_torch.core.tableau import TableauSpec, build_tableau
    from repro_torch.kernels import build, simplex_cuda

    dev = torch.device("cuda")
    kept = build.load("simplex")
    build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.build_dir()) as tmp:
        fma = build_fma_library(Path(tmp))
        libs = {"kept": kept, "fma": fma}
        types = [("type1_50000x100x100_f32_lpc", 50_000, 100, 100, True, args.seed),
                 ("type2_10000x200x100_f32_lpc", 10_000, 200, 100, False, args.seed + 1)]
        for name, bsz, m, n, feasible, seed in types:
            a, b, c, _ = chip_smoke.chunked_lp_batch(np.random.default_rng(seed), bsz, m, n,
                                                      feasible, torch.float32, dev, chunk=5000)
            batch = LPBatch(a, b, c)
            spec = TableauSpec(m, n)
            tab, basis, phase = (t.contiguous() for t in
                                 build_tableau(batch.a, batch.b, batch.c, None, spec))
            c_ext = phase2_costs(batch.c, spec)
            feas = engine.phase1_feasibility_tol(batch.b).contiguous()
            kw = dict(spec=spec, rule="lpc", seed=0, tol=engine.default_tolerance(tab.dtype))
            cap = resolve_cap(0, m, n)
            times = {"kept": [], "fma": []}
            outs = {}
            for which in ("kept", "fma", "fma", "kept"):
                build._LIBS["simplex"] = libs[which]
                for _ in range(args.reps):
                    t, bs, ph = tab.clone(), basis.clone(), phase.clone()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = simplex_cuda.simplex(t, bs, ph, c_ext, feas, cap, **kw)
                    end.record()
                    torch.cuda.synchronize()
                    times[which].append(start.elapsed_time(end))
                    outs[which] = (out[2], out[3], bs, out[0])
            build._LIBS["simplex"] = kept
            (ks, ki, kb, ko), (fs, fi, fb, fo) = outs["kept"], outs["fma"]
            differ = (ks != fs) | (ki != fi) | (kb != fb).any(dim=1)
            ok = (ks == 1) & (fs == 1)
            rel = ((ko - fo).abs() / ko.abs().clamp(min=1.0))[ok]
            print(json.dumps(dict(
                case=name, variant=simplex_cuda.plan(spec, tab.dtype, dev).variant,
                kept_ms=times["kept"], fma_ms=times["fma"],
                kept_min_ms=min(times["kept"]), fma_min_ms=min(times["fma"]),
                lps_with_other_trajectory=int(differ.sum()), lps=bsz,
                max_rel_obj_diff_both_optimal=float(rel.max()) if rel.numel() else 0.0)),
                flush=True)
            del a, b, c, batch, tab, basis, phase, outs
            torch.cuda.empty_cache()
    print(chip_smoke.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
