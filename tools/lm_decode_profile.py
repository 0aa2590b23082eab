#!/usr/bin/env python3
"""Profile an LM's decode steps on the card: device time, host calls, syncs.

    PYTHONPATH=src python3 tools/lm_decode_profile.py [--arch deepseek-v2-lite-16b]
        [--batch 8] [--prompt 4096] [--steps 6] [--routers topk,lp]

Card only.  Builds the config at full width in bfloat16 with
``Model.init`` on the card, prefills ``batch`` prompts of ``prompt``
tokens, runs three warm decode steps, then ``steps`` decode steps under
``torch.profiler`` (CPU and CUDA activities) and the same number again
timed with CUDA events alone.  For each MoE router (switched on the
loaded model, as ``chip_smoke.py:with_router`` does) it prints one JSON
line: the profiled wall ms a step, the device's kernel ms a step (the
sum of the kernels' self time), its idle share, the ATen calls and the
host-device synchronisations a step, and the unprofiled step times;
then the profiler's tables by device time and by host time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--routers", default="topk,lp", help="MoE routers, comma-separated")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke
    from repro_torch import configs
    from repro_torch.models import Model

    if not torch.cuda.is_available():
        raise SystemExit("lm_decode_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(args.arch)
    dev = torch.device("cuda")
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    b, p, steps = args.batch, args.prompt, args.steps
    toks = configs.make_inputs(cfg, configs.Shape("profile", p, b, "prefill"), 3,
                               device=dev)["tokens"]
    routers = args.routers.split(",") if cfg.family == "moe" else [cfg.router]
    print(chip_smoke.smi_line(), flush=True)
    for router in routers:
        chip_smoke.with_router(model, router)
        cache = model.init_cache(b, p + 3 + 2 * steps)
        model.prefill({"tokens": toks}, cache)
        cur = toks[:, -1:]
        for i in range(3):
            model.decode_step({"tokens": cur}, cache, p + i)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(3, 3 + steps):
                model.decode_step({"tokens": cur}, cache, p + i)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        ev = prof.key_averages()
        # kernels only (no ATen rows, which repeat their kernels' time)
        kernel_ms = sum(e.self_device_time_total for e in ev
                        if not e.key.startswith(("aten::", "cuda", "cu"))) / steps / 1e3
        plain = []
        for i in range(3 + steps, 3 + 2 * steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.decode_step({"tokens": cur}, cache, p + i)
            end.record()
            end.synchronize()
            plain.append(start.elapsed_time(end))
        print(json.dumps({
            "arch": cfg.name, "router": router, "batch": b, "prompt": p, "steps": steps,
            "profiled_wall_ms_per_step": wall, "kernel_ms_per_step": kernel_ms,
            "device_idle_share": max(0.0, 1.0 - kernel_ms / wall),
            "aten_calls_per_step": sum(e.count for e in ev if e.key.startswith("aten::")) / steps,
            "syncs_per_step": {e.key: e.count / steps for e in ev if "ynchronize" in e.key},
            "unprofiled_step_ms": plain}), flush=True)
        print(ev.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))
        print(ev.table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
