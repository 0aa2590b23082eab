"""Rank processes for ``tests/test_torch_mamba2_mesh.py`` (gloo on the CPU).

Imported by spawned children (``torch_mesh_worker.spawn`` with the
scenario ``"torch_mamba2_mesh_worker:mixer"``), so it imports torch,
NumPy and ``repro_torch`` only.  Each rank stores its slices of one
mamba2 mixer with two groups of B and C (reduced mamba2-130m with
``ssm_ngroups=2``: 8 heads of 4 a group), and on each mesh runs the
prefill into a cache, two decode steps, and one forward and backward
without a cache on its rows of the batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: (data, model) meshes of the 4-rank group: 2 heads a rank (half a
#: group) on (1, 4), 4 heads (one whole group) on (2, 2), every head on
#: (4, 1).
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
BATCH, SEQ, STEPS, SEED = 4, 20, 2, 5


def config():
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("mamba2-130m", reduced=True), ssm_ngroups=2)


def arrays(cfg) -> dict:
    """The mixer's weights (by spec name), the prompt ``x``, the decode
    steps' inputs and the loss's probe, NumPy-seeded float32."""
    from repro_torch.models import mamba2 as mb

    rng = np.random.default_rng(SEED)
    out = {k: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
           for k, s in sorted(mb.mamba_specs(cfg).items())}
    d = cfg.d_model
    out["x"] = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    out["steps"] = rng.standard_normal((STEPS, BATCH, 1, d)).astype(np.float32)
    out["probe"] = rng.standard_normal((BATCH, SEQ, d)).astype(np.float32)
    return out


def run(cfg, arr) -> dict:
    """The mixer on this rank's slices under the active mesh (every slice
    without one): its rows of the prefill's and the decode steps' outputs,
    its slices of the caches after them, and of the gradient of
    ``sum(y * probe)`` over the whole batch (each rank seeded ``1 / model``
    ranks, then ``train_step.sum_replicated``)."""
    from repro_torch.models import mamba2 as mb
    from repro_torch.sharding import ParamSpec, partition
    from repro_torch.sharding import collectives as coll
    from repro_torch.train.train_step import sum_replicated

    params = {}
    for k, spec in mb.mamba_specs(cfg).items():
        p = torch.nn.Parameter(torch.as_tensor(arr[k][partition.local_slices(spec.shape,
                                                                             spec.axes)]))
        p.spec = spec
        params[k] = p
    cache = {}
    for k, (shape, dtype) in mb.mamba_cache_specs(cfg, BATCH, cfg.dtype).items():
        spec = ParamSpec(shape, mb.CACHE_AXES[k], dtype, "zeros")
        cache[k] = torch.zeros(partition.local_shape(shape, spec.axes))
        cache[k].spec = spec
    rows = partition.batch_rows(BATCH)
    x = torch.as_tensor(arr["x"][rows])
    with torch.no_grad():
        ys = [mb.mamba_mixer(x, params, cfg, cache=cache)[0]]
        for i in range(STEPS):
            step = torch.as_tensor(arr["steps"][i][rows])
            ys.append(mb.mamba_mixer(step, params, cfg, cache=cache, cache_index=SEQ + i)[0])
    y, _ = mb.mamba_mixer(x, params, cfg)
    loss = (y * torch.as_tensor(arr["probe"][rows])).sum() / coll.size("model")
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    grads = sum_replicated(grads, params)
    return {"rows": (rows.start, rows.stop), "prefill": ys[0], "steps": ys[1:],
            "cache": {k: v.clone() for k, v in cache.items()},
            "grads": {k: g.detach() for k, g in grads.items()},
            "heads": mb.head_split(params, cfg) if partition.distributed() else None}


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"))


def mixer(rank, world, tmp):
    from repro_torch.sharding import partition

    cfg = config()
    arr = arrays(cfg)
    out = {}
    for name, shape in MESHES.items():
        with partition.activate(_mesh(shape)):
            out[name] = dict(run(cfg, arr), coords=partition.coordinates())
    return out
