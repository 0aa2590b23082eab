"""Batched LM serving with the PyTorch port: prefill + greedy decode with a KV cache.

The twin of ``examples/serve_lm.py``: a reduced dense config, random
weights from a seeded ``torch.Generator``, ``Engine.generate``.  Runs on
the card by default; pass ``--device cpu`` to run on the CPU.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-2b --steps 16 [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.lp import resolve_device
from repro_torch.models import Model
from repro_torch.serve.engine import Engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None, help="'cpu', or the card (default)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    engine = Engine(model, max_len=args.prompt_len + args.steps, device=dev)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    out = engine.generate({"tokens": tokens}, steps=args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.steps
    print(f"{args.arch} (reduced) on {dev}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, first call)")
    print("sample continuation ids:", out[0][:12].cpu().numpy())


if __name__ == "__main__":
    main()
