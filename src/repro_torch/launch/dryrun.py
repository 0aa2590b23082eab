"""Multi-pod dry run: plan every (arch x shape x mesh) cell as one rank, on the meta device.

Follows ``repro/launch/dryrun.py``, with its cells, flags and record keys;
records go to ``results/dryrun/*.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]

The reference lowers and compiles each cell's step for 256 (or 512)
forced host devices and reads XLA's analyses of the partitioned module.
The port runs one process a rank, eagerly, so one process plans one rank
(``--rank``, default 0) of the production mesh, ``(16, 16)`` ``("data",
"model")`` or ``(2, 16, 16)`` with ``--multi-pod``, under
``partition.activate({axis: size}, rank=r)``: the model is made on the
meta device at that rank's local shapes (``partition.local_slices``),
and the step (the train step with remat, ``prefill`` or ``decode_step``)
runs on meta tensors under ``launch/op_stats.py:OpCounter``; each
collective gives its result's shape and its wire bytes
(``sharding/collectives.py``).  No card, no process group and no memory
is needed.

The record, per device (the rank):

* ``memory``: bytes from the resolved placements, at the rank's local
  shapes.  ``argument_size_in_bytes`` holds the parameters, the optimizer
  state of a train cell (:func:`_abstract_opt_state`: ``m``, ``v`` and
  the master copy in float32, the int32 step), the caches of an
  inference cell, and the inputs: the rank's rows of the batch (the
  train step reads every input's rows on every rank, and a launcher need
  hand a rank no more).  ``output_size_in_bytes`` is what the step gives
  back, ``alias_size_in_bytes`` the part of it written over its
  arguments in place (the parameters and the optimizer state, the
  caches), as the reference's donated buffers alias.
  ``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are None:
  XLA's are its compiled buffer assignment's scratch and the size of the
  program it generated, and an eager step has neither (its temporaries
  come and go one operation at a time, and it runs prebuilt kernels).
* ``flops_per_device`` and ``hlo_dot_flops_per_device``: the rank's
  matmul FLOPs (``op_stats``' ``dot_flops``, every loop trip counted);
  ``bytes_per_device`` and ``hlo_traffic_bytes_per_device``: its eager
  traffic model; ``collective_bytes_per_device``: the wire bytes by kind
  and their ``total``, by the reference's ring model.
* ``lower_s``: the planning's wall time; ``compile_s``: None (nothing is
  compiled).

A config under ``router="lp"`` cannot be planned: its simplex loop runs
until the LP's pivots stop, which tensors without values cannot decide,
so such a cell raises.  Every config's default router is ``topk``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import ARCH_IDS, SHAPES, cell_is_applicable, get_config, input_specs
from ..models.model import Model
from ..sharding import ParamSpec, collectives, leaves, partition
from ..train import optimizer as opt_mod
from ..train.train_step import make_train_step
from .op_stats import analyze

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun")
#: The production meshes (``launch/mesh.py:make_production_mesh``) as ``{axis: size}``.
MESHES = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def _local_bytes(spec_shape, axes, dtype) -> int:
    shape = partition.local_shape(spec_shape, axes)
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _spec_bytes(specs) -> int:
    """Bytes of this rank's slices of a tree (or list) of ``ParamSpec``s."""
    if isinstance(specs, ParamSpec):
        return _local_bytes(specs.shape, specs.axes, getattr(torch, specs.dtype))
    if isinstance(specs, list):
        return sum(_spec_bytes(s) for s in specs)
    return sum(_spec_bytes(s) for _, s in leaves(specs))


def _abstract_opt_state(param_specs) -> Dict[str, object]:
    """The AdamW state's specs, one float32 spec a parameter for ``m``, ``v``
    and ``master`` (each parameter's axes), and the step."""
    f32 = {k: ParamSpec(s.shape, s.axes, "float32", "zeros") for k, s in param_specs.items()}
    return {"step": ParamSpec((), (), "int32", "zeros"), "m": f32, "v": dict(f32),
            "master": dict(f32)}


def _meta_inputs(cfg, shape):
    """The cell's whole-batch inputs on the meta device, and the bytes of
    this rank's rows of them."""
    specs = input_specs(cfg, shape)
    inputs = {k: torch.empty(s.shape, dtype=getattr(torch, s.dtype), device="meta")
              for k, s in specs.items()}
    return inputs, sum(_local_bytes(s.shape, s.axes, getattr(torch, s.dtype))
                       for s in specs.values())


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    accum: int = 1,
    donate: bool = True,
    cfg_override=None,
    rules_override=None,
    *,
    rank: int = 0,
    mesh_override: Optional[Dict[str, int]] = None,
    shape_override=None,
):
    """Plan one cell as rank ``rank`` of the production mesh (or of
    ``mesh_override``, an ``{axis: size}`` mapping; ``shape_override`` a
    ``configs.Shape``).  Returns ``(record, None)``: there is no compiled
    object."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    skip = cell_is_applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": skip}, None
    if cfg.num_experts and cfg.router == "lp":
        raise ValueError(f"{arch}: router='lp' cannot be planned on the meta device (its "
                         "simplex loop runs until the pivots stop, which tensors without "
                         "values cannot decide); plan the config's topk router")
    mesh = dict(mesh_override or MESHES[multi_pod])
    n_chips = 1
    for size in mesh.values():
        n_chips *= size
    enc_len = shape.seq_len if cfg.family == "encdec" else 0
    t0 = time.perf_counter()
    with partition.activate(mesh, rules_override, rank=rank), collectives.wire_bytes() as wire:
        model = Model(cfg, device="meta")
        pspecs = model.abstract_params()
        param_bytes = _spec_bytes(pspecs)
        inputs, input_bytes = _meta_inputs(cfg, shape)
        if shape.kind == "train":
            state_bytes = _spec_bytes(_abstract_opt_state(pspecs))
            ocfg = opt_mod.OptConfig()
            opt_state = opt_mod.init(dict(model.named_parameters()), ocfg)
            step = make_train_step(model, ocfg, accum=accum, remat=True)
            stats = analyze(step, opt_state, inputs)
            metrics = 3 * 4  # loss, grad_norm, lr: float32 scalars
            argument = param_bytes + state_bytes + input_bytes
            output = param_bytes + state_bytes + metrics
            alias = param_bytes + state_bytes if donate else 0
        else:
            cache_specs = model.cache_specs(shape.global_batch, shape.seq_len, enc_len=enc_len)
            cache_bytes = _spec_bytes(cache_specs)
            cache = model.init_cache(shape.global_batch, shape.seq_len, enc_len=enc_len)
            if shape.kind == "prefill":
                stats = analyze(model.prefill, inputs, cache)
            else:
                stats = analyze(model.decode_step, inputs, cache, shape.seq_len - 1)
            rows = partition.batch_rows(shape.global_batch)
            logits = (rows.stop - rows.start) * cfg.padded_vocab * torch.empty(
                (), dtype=getattr(torch, cfg.dtype)).element_size()
            argument = param_bytes + cache_bytes + input_bytes
            output = logits + cache_bytes
            alias = cache_bytes if donate else 0
    lower_s = time.perf_counter() - t0
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "n_chips": n_chips,
        "mesh": mesh,
        "rank": rank,
        "status": "ok",
        "lower_s": round(lower_s, 2),
        "compile_s": None,
        "flops_per_device": stats["dot_flops"],
        "bytes_per_device": stats["traffic_bytes"],
        "hlo_dot_flops_per_device": stats["dot_flops"],
        "hlo_traffic_bytes_per_device": stats["traffic_bytes"],
        "collective_bytes_per_device": {**wire, "total": sum(wire.values())},
        "memory": {
            "argument_size_in_bytes": argument,
            "output_size_in_bytes": output,
            "temp_size_in_bytes": None,
            "alias_size_in_bytes": alias,
            "generated_code_size_in_bytes": None,
        },
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "accum": accum,
    }
    print(f"[{arch} x {shape_name} x {'2x16x16' if multi_pod else '16x16'} rank {rank}] "
          f"flops {record['flops_per_device']:.3e} traffic {record['bytes_per_device']:.3e} "
          f"collectives {record['collective_bytes_per_device']['total']:.3e} "
          f"arguments {argument:.3e} B, {lower_s:.1f} s")
    return record, None


def cell_path(arch: str, shape_name: str, multi_pod: bool, out_dir: str) -> str:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    safe = arch.replace("/", "_").replace(".", "_")
    return os.path.join(out_dir, f"{safe}__{shape_name}__{mesh_tag}.json")


def run_cell(arch, shape_name, multi_pod, out_dir, skip_existing=False, accum=1, rank=0):
    os.makedirs(out_dir, exist_ok=True)
    path = cell_path(arch, shape_name, multi_pod, out_dir)
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok" or rec.get("status", "").startswith("skip"):
            print(f"[skip existing] {path}")
            return rec
    try:
        rec, _ = lower_cell(arch, shape_name, multi_pod, accum=accum, rank=rank)
    except Exception as e:  # record the failure: it is a fault to fix
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": f"FAIL: {type(e).__name__}: {e}"}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"-> {path}: {rec['status']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0, help="the rank of the mesh to plan")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)

    cells = []
    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    n_ok = n_skip = n_fail = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, mp, args.out, args.skip_existing, args.accum, args.rank)
        st = rec["status"]
        if st == "ok":
            n_ok += 1
        elif st.startswith("skip"):
            n_skip += 1
        else:
            n_fail += 1
    print(f"\ndry-run complete: ok={n_ok} skip={n_skip} FAIL={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
