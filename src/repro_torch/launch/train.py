"""End-to-end training driver (fault-tolerant).

Follows ``repro/launch/train.py``, with the same flags and ``--device``
(default: the card; ``cpu`` to run on the host).  Weights come from
``Model.init`` with a ``torch.Generator`` seeded ``--seed``.

Examples:
  # reduced-config smoke train on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch mamba2-130m \\
      --reduced --seq 256 --batch 8 --steps 50 --ckpt ck

  # resume after a crash: the identical command restores the newest checkpoint.

  # a (data, model) = (2, 2) mesh of 4 ranks on the CPU (gloo)
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --arch gemma2-2b --reduced --seq 64 --batch 4 --steps 4 --model-axis 2 --ckpt ck

Under ``torchrun`` (``WORLD_SIZE`` above 1) or with ``--model-axis``
above 1, every rank joins the process group (``mesh.init_distributed``,
``--backend``: ``nccl`` on the cards, one rank a card; ``gloo`` for
ranks that share a card, and the default with ``--device cpu``), makes
the ``(world / model_axis, model_axis)`` mesh and trains under
``partition.activate(mesh)``: each rank builds the model's slices, draws
the whole batch from the seed (as the reference's ``SyntheticLM`` does)
and runs its rows; rank 0 logs, and checkpoints are whole leaves that
any mesh restores (``runtime/fault.py``).  The reference's
``tpu_env_flags`` (XLA flags for TPU pods) and its buffer donation have
no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..core.lp import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM, to_device
from ..models.model import Model
from ..runtime.fault import DriverConfig, TrainDriver
from ..sharding import partition
from ..train import optimizer as opt_mod
from . import mesh as mesh_lib
from ..train.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="simulate a failure at this step (testing)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--backend", default=None,
                    help="process group backend under a mesh (default: nccl on the cards, "
                         "gloo with --device cpu; gloo for ranks that share a card)")
    args = ap.parse_args(argv)

    meshed = args.model_axis > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not meshed:
        return _train(args, resolve_device(args.device))
    mesh_lib.init_distributed(args.backend, device=args.device)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if args.device is None
               else resolve_device(args.device))
        mesh = mesh_lib.make_local_mesh(model=args.model_axis, device=dev)
        with partition.activate(mesh):
            return _train(args, dev)
    finally:
        dist.destroy_process_group()


def _train(args, dev):
    """The training run on ``dev`` (under the caller's mesh, if any)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(args.seed))
    ocfg = opt_mod.OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1))
    opt_state = opt_mod.init(dict(model.named_parameters()), ocfg)
    step_fn = make_train_step(model, ocfg, accum=args.accum, remat=True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed))

    quiet = dist.is_initialized() and dist.get_rank() != 0

    def log(step, m):
        if quiet:
            return
        print(f"step {step:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
              f"lr {m['lr']:.2e} {m['steps_per_s']:.2f} it/s", flush=True)

    driver = TrainDriver(
        DriverConfig(args.ckpt, ckpt_every=args.ckpt_every, log_every=10),
        model, train_step=step_fn, data_fn=data.batch,
        put_fn=lambda b: to_device(b, dev), log_fn=log,
    )
    opt_state, hist = driver.run(opt_state, args.steps, preempt_at=args.preempt_at)
    if not quiet:
        print(f"done: final loss {hist[-1][1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
