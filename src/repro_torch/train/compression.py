"""Gradient compression: int8 quantization with error feedback.

Follows ``repro/train/compression.py``: each gradient leaf is quantized
to int8 with a per-leaf scale, and the quantization residual is kept as
*error feedback*, added back on the next step (EF-SGD, Karimireddy et
al., 2019).  ``torch.round`` rounds half to even, as ``jnp.round`` does.

:func:`dp_allreduce_int8` is the explicit int8 all-reduce over a mesh
axis (the reference's ``shard_map`` form): every step is exact or
elementwise, so it matches the reference bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..sharding import collectives as coll


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    return _quantize_with(g, scale), scale


def _quantize_with(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_ef_compressor(leaf_of: Optional[Dict[str, str]] = None):
    """Returns ``(init_fn, compress_fn)`` over name -> tensor dicts.

    ``compress_fn(grads, ef) -> (decompressed_grads, new_ef)``:
    ``g' = Q(g + e)``, ``e_new = (g + e) - g'``, in float32.  The scale is
    per leaf: ``leaf_of`` maps each parameter name to the leaf it belongs
    to, and parameters of one leaf share a scale (the reference's leaves
    stack a group's layers: ``models/convert.py:reference_leaf_of(model)``
    gives that map); by default each parameter is a leaf of its own.

    Under a mesh each rank holds its slices of the gradients: the scale
    is the maximum over the whole leaf, an all-reduce max of the slices'
    over the axes the leaf is stored split on (read from the error
    state, which ``init_fn`` makes at the parameters' local shapes with
    their ``.spec``), so every rank quantizes with the one-device scale.
    """

    def init_fn(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: coll.with_spec(torch.zeros(p.shape, dtype=torch.float32, device=p.device), p)
                for k, p in params.items()}

    def compress_fn(grads: Dict[str, torch.Tensor], ef: Dict[str, torch.Tensor]):
        tot = {k: g.to(torch.float32) + ef[k] for k, g in grads.items()}
        leaves: Dict[str, list] = {}
        for k in tot:
            leaves.setdefault(leaf_of[k] if leaf_of else k, []).append(k)
        new_g, new_e = {}, {}
        for names in leaves.values():
            amax = torch.stack([torch.max(torch.abs(tot[k])) for k in names]).max()
            # a leaf's parameters share one spec, so one set of split axes
            amax = coll.all_reduce(amax, coll.stored_split(ef[names[0]]), "max")
            scale = torch.clamp(amax, min=1e-12) / 127.0
            for k in names:
                deq = _dequantize(_quantize_with(tot[k], scale), scale)
                new_g[k], new_e[k] = deq, coll.with_spec(tot[k] - deq, ef[k])
        return new_g, new_e

    return init_fn, compress_fn


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all-reduce; gloo reduces a CUDA tensor through the host."""
    if t.is_cuda and dist.get_backend(group) != "nccl":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def dp_allreduce_int8(grads, mesh, axis: str = "data"):
    """The mean of each gradient leaf over a mesh axis, with an int8 payload.

    ``grads`` is a tree (nested dicts) of this rank's local blocks, the
    reference's ``P(axis)`` shards; each comes back as this rank's block
    of the mean.  Per leaf: an all-reduce MAX of ``max |g|`` agrees on one
    scale ``max(amax, 1e-12) / 127``; each rank quantizes to int8; the
    payload crosses as an all-reduce SUM in int32; the sum is dequantized
    and divided by the axis size.
    """
    group = mesh.get_group(axis)
    size = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32)

    def leaf(g: torch.Tensor) -> torch.Tensor:
        amax = _all_reduce(torch.max(torch.abs(g)).reshape(1), dist.ReduceOp.MAX, group)[0]
        scale = torch.clamp(amax, min=1e-12) / 127.0
        summed = _all_reduce(_quantize_with(g, scale).to(torch.int32), dist.ReduceOp.SUM, group)
        return summed.to(torch.float32) * scale / size.to(g.device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)

    return walk(grads)
