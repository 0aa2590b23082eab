"""End-to-end LM training with the PyTorch port.

The twin of ``examples/train_lm.py``: trains a reduced-config model on
the synthetic recurrence language with checkpointing, through the port's
launcher (``python -m repro_torch.launch.train``); the loss should drop
well below the uniform baseline ln(V).  Runs on the card by default;
pass ``--device cpu`` to run on the CPU.

  PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-130m --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --arch gemma2-2b --steps 100 --device cpu
"""

import argparse
import os
import subprocess
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--no-reduced", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="'cpu', or the card (default)")
    args = ap.parse_args()

    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--seq", str(args.seq),
        "--batch", str(args.batch),
        "--ckpt", args.ckpt,
        "--lr", "1e-3",
    ]
    if args.device:
        cmd += ["--device", args.device]
    if not args.no_reduced:
        cmd.append("--reduced")
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
