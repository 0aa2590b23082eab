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
* :func:`reduce_scatter` along a dimension: the group's sum, cut into
  one block a rank in rank order (a row-parallel product whose output is
  kept sequence-parallel); bfloat16 and float16 summed in float32, as
  the all-reduce sums them;
* :func:`all_to_all`: splits a dimension into one block a rank and
  concatenates the blocks received along another.

The residual stream between a model's sublayers is sequence-parallel,
as the reference constrains it to ``("batch", "seq_tp", None)``: a rank
holds its rows and its block of the positions that
``partition.global_seq`` names (:func:`stream_range`; every position
where the model axes do not divide them).  A sublayer gathers its
normalised input along the sequence where it needs every position
(:func:`seq_whole`), and leaves its output in the stream's layout: a
row-parallel product's partial sums reduce-scattered along the sequence
(:func:`seq_sum`), a position-wise result cut (:func:`seq_part`),
queries already cut by ``seq_tp`` kept.

A group of one rank returns its input, both ways, so a ``(1, 1)`` mesh
runs the bits of no mesh.  NCCL works on device tensors; gloo, which has
no ``all_gather``, ``reduce_scatter`` or ``all_to_all`` of CUDA tensors,
works through host copies (as ``core/spmd.py:BatchSplit`` stages its
rows).  Groups are made once per mesh and axes
(``core/spmd.py:_cached_group``); every rank makes them in the same
order because every rank runs the same layers (in the backward too, and
``torch.utils.checkpoint`` repeats a layer's forward collectives there
on every rank alike).

**The backward.**  Each collective is a ``torch.autograd.Function``
whose backward is its adjoint: an all-reduce sum's is an all-reduce sum
of the gradients; an all-gather's along ``dim`` a reduce-scatter along
``dim`` (the sum over the group, each rank keeping its own piece;
bfloat16 and float16 summed in float32), and a reduce-scatter's the
all-gather; an all-to-all's the all-to-all
back, with the two dimensions swapped.  An all-reduce max takes no
gradient: its one user, the split softmax's shift
(``models/attention.py:_split_softmax``), cancels, as in
``torch.logsumexp``.  A rank's backward then gives the gradient of the
*sum over the ranks* of their copies of the loss, and a parameter stored
whole on an axis is one variable with one copy a rank:
``train/train_step.py`` seeds each rank with ``1 / ranks`` and sums the
gradient of such a parameter over those axes (:func:`replicated_axes`).
The mesh context is the process's (``partition``), so a backward that
the autograd engine runs on a thread of its own sees its forward's mesh.

**Planning.**  Under ``partition.planning()`` (an abstract mesh answered
as one rank) there is no process group: each collective returns an
uninitialised tensor of its result's shape (``new_empty``, which
``launch/op_stats.py`` counts as no traffic) and adds its wire bytes to
the counter of the innermost :func:`wire_bytes`, by the ring model of
the reference's ``launch/hlo_stats.py``: an all-gather moves its output,
an all-reduce twice its output, a reduce-scatter its input, an
all-to-all its output.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..core.spmd import _cached_group, _subgroups
from . import partition

#: The wire-byte counters of the open :func:`wire_bytes` blocks, innermost last.
_WIRE: List[Dict[str, float]] = []
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
#: ``reduce_scatter_tensor``, named ``reduce_scatter_single`` from torch 2.13 on.
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _mesh_axes(axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in partition.mesh_axes() if a in axes)


def size(axes) -> int:
    """Ranks in this rank's group over ``axes`` (1 unless each rank holds
    its own slices: a ``DeviceMesh`` or a planned rank)."""
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


@contextlib.contextmanager
def wire_bytes():
    """Count the wire bytes of the planned collectives of the block, by
    kind (:data:`KINDS`); yields the counter."""
    counter = {k: 0.0 for k in KINDS}
    _WIRE.append(counter)
    try:
        yield counter
    finally:
        _WIRE.pop()


def _planned(kind: str, x: torch.Tensor, shape, wire_of) -> torch.Tensor:
    """A planned collective's result: ``new_empty(shape)``, and ``wire_of``
    times the bytes of (``"in"``: ``x``, else the result) on the counter."""
    nbytes = math.prod(x.shape if wire_of == "in" else shape) * x.element_size()
    if _WIRE:
        _WIRE[-1][kind] += (2.0 if kind == "all-reduce" else 1.0) * nbytes
    return x.new_empty(tuple(shape))


def _via_host(x: torch.Tensor, grp) -> bool:
    return x.device.type == "cuda" and dist.get_backend(grp) != "nccl"


def _staged(x: torch.Tensor, grp) -> torch.Tensor:
    """``x`` where the group's backend can take it: a host copy for gloo
    and a CUDA tensor, else ``x`` itself (contiguous)."""
    if _via_host(x, grp):
        return x.to("cpu")
    return x.contiguous()


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the dtype a sum of it takes: float32 for bfloat16 and float16."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _reduce(x: torch.Tensor, axes, op: str) -> torch.Tensor:
    """The sum (or maximum) of ``x`` over the group of ``axes`` (more than one rank)."""
    if partition.planning():
        return _planned("all-reduce", x, x.shape, "out")
    grp = group(axes)
    wide = _wide(x) if op == "sum" else x
    buf = _staged(wide, grp)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=grp)
    return buf.to(device=x.device, dtype=x.dtype)


def _gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    n = size(axes)
    if partition.planning():
        shape = list(x.shape)
        shape[dim] *= n
        return _planned("all-gather", x, shape, "out")
    grp = group(axes)
    buf = _staged(x, grp)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=grp)
    return torch.cat([p.to(x.device) for p in parts], dim=dim)


def _scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The reduce-scatter along ``dim``: the group's sum of ``x``, cut into
    one block a rank in rank order; this rank's block."""
    n = size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    if partition.planning():
        shape = list(x.shape)
        shape[dim] //= n
        return _planned("reduce-scatter", x, shape, "in")
    grp = group(axes)
    src = _staged(torch.movedim(_wide(x), dim, 0).contiguous(), grp)
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _REDUCE_SCATTER(out, src, group=grp)
    return torch.movedim(out.to(device=x.device, dtype=x.dtype), 0, dim)


def _to_all(x: torch.Tensor, axes, split_dim: int, cat_dim: int) -> torch.Tensor:
    n = size(axes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    if partition.planning():
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[cat_dim] *= n
        return _planned("all-to-all", x, shape, "out")
    grp = group(axes)
    src = _staged(torch.movedim(x, split_dim, 0).contiguous(), grp)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=grp)
    blocks = torch.movedim(dst.to(x.device), 0, split_dim).chunk(n, dim=split_dim)
    return torch.cat(blocks, dim=cat_dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _reduce(x, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axes, "sum"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return _gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axes, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return _scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axes, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, split_dim, cat_dim):
        ctx.axes, ctx.dims = axes, (split_dim, cat_dim)
        return _to_all(x, axes, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _to_all(g, ctx.axes, cat_dim, split_dim), None, None, None


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The sum (or maximum) of ``x`` over the group of ``axes``, on every
    rank of it; the sum's backward is the sum of the gradients, the
    maximum takes none."""
    if size(axes) == 1:
        return x
    if op == "max":
        return _reduce(x.detach(), axes, "max")
    return _AllReduce.apply(x, axes)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim`` in rank order
    (every piece of ``x``'s shape); the backward is the reduce-scatter."""
    if size(axes) == 1:
        return x
    return _AllGather.apply(x, axes, dim)


def reduce_scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the group of ``axes``, cut along ``dim`` into one
    block a rank in rank order: this rank's block (bfloat16 and float16
    summed in float32); the backward is the all-gather along ``dim``."""
    if size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, axes, dim)


def all_to_all(x: torch.Tensor, axes, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``x`` cut into one block a rank along ``split_dim``; block ``j`` goes
    to rank ``j`` of the group, and the blocks received are concatenated
    along ``cat_dim`` in rank order.  The backward is the all-to-all back."""
    if size(axes) == 1:
        return x
    return _AllToAll.apply(x, axes, split_dim, cat_dim)


# ---------------------------------------------------------------------------
# Parameters stored by their placements
# ---------------------------------------------------------------------------


def spec_of(t: torch.Tensor):
    """The ``ParamSpec`` a parameter was made from (None for other tensors)."""
    return getattr(t, "spec", None)


def with_spec(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` carrying ``like``'s ``ParamSpec`` as ``.spec`` (if it has one):
    an optimizer or error-feedback state of a parameter's local shape."""
    spec = spec_of(like)
    if spec is not None:
        t.spec = spec
    return t


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


def stored_split(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes (of more than one rank) the parameter ``t`` is stored
    split over, in mesh order: a sum over its elements is completed by a
    sum over them."""
    axes = {a for _, ax in split_dims(t) for a in ax}
    return tuple(a for a in partition.mesh_axes() if a in axes)


def replicated_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes (of more than one rank) the parameter ``t`` is stored
    whole on, in mesh order (empty unless each rank holds its own
    slices): each rank's copy is one variable, so its gradient is summed
    over them."""
    if not partition.distributed():
        return ()
    split = set(stored_split(t))
    return tuple(a for a in partition.mesh_axes() if size(a) > 1 and a not in split)


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


# ---------------------------------------------------------------------------
# The residual stream's sequence-parallel layout
# ---------------------------------------------------------------------------


def stream_range() -> Tuple[int, int, Tuple[str, ...]]:
    """``(lo, hi, axes)``: this rank's block of the residual stream's
    positions (``partition.global_seq``), ``dim_range(S, "seq_tp")``, and
    the model axes that split them; ``(0, 0, ())`` outside a stream, where
    a sublayer takes and returns every position."""
    seq = partition.current_seq()
    if seq is None:
        return 0, 0, ()
    return dim_range(seq, "seq_tp")


def seq_whole(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``x``, this rank's block of the stream's positions along ``dim``,
    with every position: the all-gather over the axes that split them (its
    backward the reduce-scatter); ``x`` itself where the stream is whole."""
    _, _, axes = stream_range()
    return all_gather(x, axes, dim) if axes else x


def seq_part(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of the stream's positions of ``x``, which holds every
    position along ``dim``."""
    lo, hi, axes = stream_range()
    return x.narrow(dim, lo, hi - lo) if axes else x


def seq_sum(x: torch.Tensor, axes, dim: int = 1) -> torch.Tensor:
    """The sum over the group of ``axes`` of the partial products ``x`` (every
    position along ``dim``; no axes: ``x`` is whole), left in the stream's
    layout: the reduce-scatter along ``dim`` where the stream is split (the
    Megatron-SP pattern: on a ``(data, model)`` mesh the stream and every
    model-axis product are split over the same ``model`` axis), the
    all-reduce where it is whole, this rank's block where there is no sum."""
    if not axes:
        return seq_part(x, dim)
    _, _, sax = stream_range()
    if not sax:
        return all_reduce(x, axes)
    assert _mesh_axes(sax) == _mesh_axes(axes), (sax, axes)
    return reduce_scatter(x, axes, dim)
