#!/usr/bin/env python3
"""The mesh phase of ``chip_smoke.py`` (slice 13) alone on the card.

    python3 tools/mesh_phase.py

Needs one CUDA device.  Builds every kernel, computes the one-process
results that the phase's rows are held against (type 1, type 2, the
hyperbox and shared rows, the rounds of type 1 and the serve mix, from
the same seeds as ``chip_smoke.py``), then runs ``chip_smoke.mesh_phase``:
NCCL with one rank on a (1, 1) mesh, then gloo ranks that share the card
on the (data=4) and (data=2, model=2) meshes.  Prints the phase's JSON
lines as ``chip_smoke.py`` does, then its launch counts and the card's
name and power limit.  Exits non-zero if a row fails its check.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as s  # noqa: E402


def main():
    import repro_torch as rt
    from repro_torch.core.lp import LPBatch
    from repro_torch.kernels import build, hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda

    t0 = time.perf_counter()
    build.compile_all()
    print("build", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda")
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}

    def reset():
        for mod in counters.values():
            mod.launches = 0
            for v in getattr(mod, "variant_launches", {}):
                mod.variant_launches[v] = 0

    t0 = time.perf_counter()
    type1_row = s.simplex_row(rt, dev, name="type1_feasible_100x100", bsz=50_000, m=100, n=100,
                              feasible=True, seed=0, counters=counters)
    s.simplex_row(rt, dev, name="type2_infeasible_start_200x100", bsz=10_000, m=200, n=100,
                  feasible=False, seed=1, counters=counters)
    s.hyperbox_row(rt, dev, name="hyperbox_4000000x5", bsz=4_000_000, n=5, seed=2,
                   counters=counters)
    s.shared_row(rt, dev, name="shared_type1_100x100", bsz=50_000, m=100, n=100, feasible=True,
                 seed=30, counters=counters, dense_row=type1_row, reruns=[])
    a, b, c, _ = s.chunked_lp_batch(np.random.default_rng(0), 50_000, 100, 100, True,
                                    torch.float32, dev, chunk=5000)
    s.MESH_REFS["rounds_type1"] = s.sol_digest(rt.solve(LPBatch(a, b, c)))
    del a, b, c
    oneshot = rt.SolveSession(device=dev).solve(s.serve_requests(rt))
    s.MESH_REFS["serve"] = s.requests_digest(oneshot)
    del oneshot
    torch.cuda.empty_cache()
    print("refs", time.perf_counter() - t0, flush=True)
    out = s.mesh_phase(rt, dev, seed=0, counters=counters, reset=reset, type1_row=type1_row)
    print("mesh launches", out, flush=True)
    print(s.smi_line(), flush=True)


if __name__ == "__main__":
    main()
