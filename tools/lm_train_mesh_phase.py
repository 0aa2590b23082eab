#!/usr/bin/env python3
"""The mesh training phase of ``chip_smoke.py`` (slice 15) alone on the card.

    python3 tools/lm_train_mesh_phase.py

Needs one CUDA device and ``tests/data/lm_train_gemma2_2b_mesh_reference.npz``
(``tools/lm_reference_fixture.py --train --layers 4 --mesh 2,2``).  Builds
the simplex kernel (the phase's only kernel: the router LP of every MoE
layer of the eval step under ``lp``), then runs
``chip_smoke.lm_train_mesh_phase``: NCCL with one rank on a (1, 1) mesh
(gemma2-2b at full width and depth in bfloat16, its parameters and
optimizer state bit-identical to the meshless steps), then gloo ranks
that share the card on a (2, 2) mesh (gemma2-2b cut in depth, held
against the one-process run under the abstract mesh and the fixture;
mamba2-130m's checkpoints; deepseek's eval step under ``lp``).  The MoE
training case on the ranks is the ``gpu`` tier's
(``tests/test_torch_gpu.py::test_train_mesh_moe_at_full_width_holds_the_float64_witness``).
Prints the phase's JSON lines as
``chip_smoke.py`` does, then its launch counts and the card's name and
power limit.  Exits non-zero if a row fails its check.
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
    out = s.lm_train_mesh_phase(configs, torch.device("cuda"), seed=0, counters=counters,
                                reset=reset)
    print("lm train mesh launches", out, "wall_s", time.perf_counter() - t0, flush=True)
    print(s.smi_line(), flush=True)


if __name__ == "__main__":
    main()
