"""Batched LM serving with the PyTorch port: prefill + greedy decode with a KV cache.

The twin of ``examples/serve_lm.py``: a reduced config of any family,
random weights from a seeded ``torch.Generator``, ``Engine.generate``.
The prompt's inputs are ``make_inputs``' (frames for the
encoder-decoder, patch embeddings for the vision frontend), with
M-RoPE positions whose coordinates differ (``mrope_positions``) and the
encoder-decoder's ``enc_len`` set to its frames' length.  Runs on the
card by default; pass ``--device cpu`` to run on the CPU.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-2b --steps 16 [--device cpu]
  PYTHONPATH=src python examples/torch_serve_lm.py --arch seamless-m4t-large-v2 --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import Shape, get_config, make_inputs, mrope_positions
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
    inputs = make_inputs(cfg, Shape("example", args.prompt_len, args.batch, "prefill"), seed=0,
                         device=dev)
    if cfg.mrope_sections:
        inputs["positions"] = torch.as_tensor(
            mrope_positions(args.batch, args.prompt_len, cfg.num_patches, seed=0), device=dev)
    enc_len = inputs["frames"].shape[1] if "frames" in inputs else 0
    engine = Engine(model, max_len=args.prompt_len + args.steps, enc_len=enc_len, device=dev)

    t0 = time.perf_counter()
    out = engine.generate(inputs, steps=args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.steps
    print(f"{args.arch} (reduced) on {dev}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, first call)")
    print("sample continuation ids:", out[0][:12].cpu().numpy())


if __name__ == "__main__":
    main()
