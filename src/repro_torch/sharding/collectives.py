"""Collectives over named axes of the active mesh: the LM's one door to
``torch.distributed``.

New in the port.  The reference lets XLA insert its collectives from
``with_sharding_constraint``; the port runs one process a rank, and the
model files call these instead, each over the group of one or more
named mesh axes (the ranks that share every other coordinate):

* :func:`all_reduce` (``"sum"`` or ``"max"``): a float sum where the
  reference's SPMD sums partial products (a row-parallel product, the
  embedding's vocabulary blocks, a split softmax); bfloat16 and float16
  partials are summed in float32 and rounded once, as one product
  accumulates;
* :func:`all_gather` along a dimension, in the group's rank order, which
  is the row-major order of the axes (``partition.local_slices`` cuts
  the same way), so the pieces go back where they came from; a gather
  moves raw values and changes no bit;
* :func:`all_to_all`: splits a dimension into one block a rank and
  concatenates the blocks received along another.

A group of one rank returns its input, so a ``(1, 1)`` mesh runs the
bits of no mesh.  NCCL works on device tensors; gloo, which has no
``all_gather``, ``reduce_scatter`` or ``all_to_all`` of CUDA tensors,
works through host copies (as ``core/spmd.py:BatchSplit`` stages its
rows).  Groups are made once per mesh and axes
(``core/spmd.py:_cached_group``); every rank makes them in the same
order because every rank runs the same layers.  No backward: the
forward path runs under ``torch.inference_mode``.

Parameters are stored by their placements (``rules.py``): :func:`weight`
gathers the dimensions a parameter stores split over the data (``fsdp``)
axes, at its use, and the gathered copy is freed with the layer's
temporaries.  The model axis stays split: the layers compute on it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..core.spmd import _cached_group, _subgroups
from . import partition


def _mesh_axes(axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in partition._CTX.shape if a in axes)


def size(axes) -> int:
    """Ranks in this rank's group over ``axes`` (1 without a ``DeviceMesh``)."""
    if not partition.distributed():
        return 1
    return partition.axes_size((axes,) if isinstance(axes, str) else axes)


def group(axes):
    """This rank's process group over the mesh axes ``axes`` (mesh order)."""
    mesh = partition.active_mesh()
    axes = _mesh_axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return _cached_group(mesh, ("axes",) + axes, lambda: _subgroups(mesh, axes))


def _via_host(x: torch.Tensor, grp) -> bool:
    return x.device.type == "cuda" and dist.get_backend(grp) != "nccl"


def _staged(x: torch.Tensor, grp) -> torch.Tensor:
    """``x`` where the group's backend can take it: a host copy for gloo
    and a CUDA tensor, else ``x`` itself (contiguous)."""
    if _via_host(x, grp):
        return x.to("cpu")
    return x.contiguous()


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The sum (or maximum) of ``x`` over the group of ``axes``, on every rank of it."""
    if size(axes) == 1:
        return x
    grp = group(axes)
    wide = x.float() if op == "sum" and x.dtype in (torch.bfloat16, torch.float16) else x
    buf = _staged(wide, grp)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=grp)
    return buf.to(device=x.device, dtype=x.dtype)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim`` in rank order
    (every piece of ``x``'s shape)."""
    n = size(axes)
    if n == 1:
        return x
    grp = group(axes)
    buf = _staged(x, grp)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=grp)
    return torch.cat(parts, dim=dim).to(x.device)


def all_to_all(x: torch.Tensor, axes, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``x`` cut into one block a rank along ``split_dim``; block ``j`` goes
    to rank ``j`` of the group, and the blocks received are concatenated
    along ``cat_dim`` in rank order."""
    n = size(axes)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    grp = group(axes)
    src = _staged(torch.movedim(x, split_dim, 0).contiguous(), grp)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=grp)
    blocks = torch.movedim(dst.to(x.device), 0, split_dim).chunk(n, dim=split_dim)
    return torch.cat(blocks, dim=cat_dim)


# ---------------------------------------------------------------------------
# Parameters stored by their placements
# ---------------------------------------------------------------------------


def spec_of(t: torch.Tensor):
    """The ``ParamSpec`` a parameter was made from (None for other tensors)."""
    return getattr(t, "spec", None)


def split_dims(t: torch.Tensor):
    """``(dim, mesh axes)`` of every dimension the parameter ``t`` stores
    split on this rank's mesh over more than one rank (empty without a
    ``DeviceMesh``: an axis of size 1 splits nothing, so a (1, 1) mesh
    runs the code of no mesh)."""
    spec = spec_of(t)
    if spec is None or not partition.distributed():
        return []
    memo, key = partition.memo(), ("split", spec)
    if key not in memo:
        resolved = partition.resolve_spec(spec.shape, spec.axes)
        out = [(d, partition.entry_axes(e)) for d, e in enumerate(resolved) if e is not None]
        memo[key] = [(d, axes) for d, axes in out if size(axes) > 1]
    return memo[key]


def _data(axes) -> bool:
    """Whether ``axes`` are data axes (the ``fsdp`` and ``batch`` rules')."""
    return set(axes) <= set(partition.rule_axes("fsdp")) | set(partition.rule_axes("batch"))


def weight(t: torch.Tensor) -> torch.Tensor:
    """The parameter ``t`` gathered over the data axes it is stored split
    on: whole along every dimension but those the model axis splits."""
    for d, axes in split_dims(t):
        if _data(axes):
            t = all_gather(t, axes, d)
    return t


def whole(t: torch.Tensor) -> torch.Tensor:
    """The parameter ``t`` gathered over every axis it is stored split on."""
    for d, axes in split_dims(t):
        t = all_gather(t, axes, d)
    return t


def model_whole(t: torch.Tensor) -> torch.Tensor:
    """A cache leaf gathered over the model axes it is stored split on (its
    batch rows stay this rank's)."""
    for d, axes in split_dims(t):
        if not _data(axes):
            t = all_gather(t, axes, d)
    return t


def model_part(full: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``full`` (``model_whole(t)``'s shape) along the
    dimensions the model axes split ``t`` over."""
    for d in range(full.dim()):
        lo, hi, axes = model_range(t, d)
        if axes:
            full = full.narrow(d, lo, hi - lo)
    return full


def model_range(t: torch.Tensor, dim: int) -> Tuple[int, int, Tuple[str, ...]]:
    """``(lo, hi, axes)``: the index range of dimension ``dim`` that
    ``weight(t)`` holds, and the model axes that split it (empty: whole)."""
    spec = spec_of(t)
    if spec is None or not partition.distributed():
        return 0, t.shape[dim], ()
    memo, key = partition.memo(), ("range", spec, dim)
    if key not in memo:
        memo[key] = 0, spec.shape[dim], ()
        for d, axes in split_dims(t):
            if d == dim and not _data(axes):
                sl = partition.local_slices(spec.shape, spec.axes)[dim]
                memo[key] = sl.start, sl.stop, axes
    return memo[key]


def local_range(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    """The index range of dimension ``dim`` the parameter ``t`` stores on
    this rank, whatever axes split it."""
    spec = spec_of(t)
    if spec is None or not partition.distributed():
        return 0, t.shape[dim]
    sl = partition.local_slices(spec.shape, spec.axes)[dim]
    return sl.start, sl.stop


def data_axes(t: torch.Tensor, dim: int) -> Tuple[str, ...]:
    """The data (``fsdp``) axes the parameter ``t`` stores dimension ``dim``
    split over (empty where that dimension is whole)."""
    for d, axes in split_dims(t):
        if d == dim and _data(axes):
            return axes
    return ()


def dim_range(size_: int, logical: str) -> Tuple[int, int, Tuple[str, ...]]:
    """``(lo, hi, axes)`` of this rank's block of a dimension of ``size_``
    named ``logical`` (the whole range and no axes where it is not split)."""
    if not partition.distributed():
        return 0, size_, ()
    memo, key = partition.memo(), ("dim", size_, logical)
    if key not in memo:
        axes = partition.split_axes(size_, logical)
        sl = partition.local_slices((size_,), (logical,))[0] if axes else slice(0, size_)
        memo[key] = sl.start, sl.stop, axes
    return memo[key]


def gather_rows(x: torch.Tensor, batch: int, dim: int = 0) -> torch.Tensor:
    """A batch's rows from every rank: ``x`` holds this rank's
    ``partition.batch_rows(batch)`` along ``dim``; the result all of them."""
    axes = partition.split_axes(batch, "batch")
    return all_gather(x, axes, dim) if axes else x
