#!/usr/bin/env python3
"""The catalog phase of ``chip_smoke.py`` (slice 16) alone on the card.

    python3 tools/lm_catalog_phase.py

Needs one CUDA device and ``tests/data/lm_qwen2_vl_72b_reference.npz``.
Builds the simplex kernel (the phase's only kernel: dbrx's router LP of
every MoE layer under ``router="lp"``), loads qwen2-vl-72b's 2-layer
models as slice 11's ``lm_vlm_reference`` does (its checks included),
then runs ``chip_smoke.lm_catalog_phase``: qwen2-vl-72b, qwen1.5-4b,
internlm2-20b, dbrx-132b (4 layers, ``topk`` and ``lp``) and
command-r-plus-104b (8 layers) served at full width through
``Engine.generate``.  Prints the phase's JSON lines as ``chip_smoke.py``
does, then its launch counts, its seconds and the card's name and power
limit.  Exits non-zero if a row fails its check.
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

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model, vlm_model, _ = s.lm_family_reference(configs, dev, "lm_vlm")
    del model
    torch.cuda.empty_cache()
    print("lm_vlm_reference s", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    out = s.lm_catalog_phase(configs, dev, seed=0, counters=counters, reset=reset,
                             vlm_model=vlm_model)
    print("lm catalog launches", out["launches"], "wall_s", time.perf_counter() - t0, flush=True)
    print(s.smi_line(), flush=True)


if __name__ == "__main__":
    main()
