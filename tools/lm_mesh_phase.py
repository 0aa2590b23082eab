#!/usr/bin/env python3
"""The LM mesh phase of ``chip_smoke.py`` (slice 14) alone on the card.

    python3 tools/lm_mesh_phase.py

Needs one CUDA device and ``tests/data/lm_deepseek_v2_lite_mesh_reference.npz``
(``tools/lm_reference_fixture.py --mesh 2,2``).  Builds the simplex
kernel (the phase's only kernel: the router LP of every MoE layer), then
runs ``chip_smoke.lm_mesh_phase``: NCCL with one rank on a (1, 1) mesh
(deepseek-v2-lite-16b under ``router="lp"`` and gemma2-2b at full width
and depth, bit-identical to the meshless run), then gloo ranks that
share the card on a (2, 2) mesh, held against the one-process run under
the abstract mesh and against the fixture.  Prints the phase's JSON lines
as ``chip_smoke.py`` does, then its launch counts and the card's name
and power limit.  Exits non-zero if a row fails its check.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as s  # noqa: E402


def main():
    from repro_torch import configs
    from repro_torch.kernels import build, hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda

    t0 = time.perf_counter()
    build.compile_all(["simplex"])
    print("build", time.perf_counter() - t0, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}

    def reset():
        for mod in counters.values():
            mod.launches = 0
            for v in getattr(mod, "variant_launches", {}):
                mod.variant_launches[v] = 0

    t0 = time.perf_counter()
    out = s.lm_mesh_phase(configs, torch.device("cuda"), seed=0, counters=counters, reset=reset)
    print("lm mesh launches", out, "wall_s", time.perf_counter() - t0, flush=True)
    print(s.smi_line(), flush=True)


if __name__ == "__main__":
    main()
