"""Logical-axis partitioning with divisibility fallback.

Follows ``repro/sharding/partition.py``.  Model code names its tensor
dimensions by *logical* axes; a rules table maps them to physical mesh
axes.  An assignment that does not divide a dimension evenly is dropped
to replication, so the same code runs on one device, a 256-rank mesh and
a 512-rank multi-pod mesh without per-architecture tuning.

    with partition.activate(mesh):
        spec = partition.resolve_spec(x.shape, ("batch", "seq_tp", None))
        x = partition.constrain(x, ("batch", "seq_tp", None))

``activate`` takes a ``torch.distributed.device_mesh.DeviceMesh``, or an
abstract ``{axis: size}`` mapping (the counterpart of JAX's
``AbstractMesh``) for plans and tests at 256 or 512 ranks in one
process.  An abstract mapping with ``rank=r`` answers as rank ``r`` of
that mesh (:func:`planning`): it stores and computes that rank's slices,
and ``sharding/collectives.py`` gives each collective's result shape
without a process group (``launch/dryrun.py`` plans on the meta device
this way).  :func:`resolve_spec` returns what the reference's
``PartitionSpec`` holds, as a tuple: per dimension ``None``, one axis
name, or a tuple of names.  :func:`placements` turns it into one
``Shard(d)`` / ``Replicate()`` per mesh dimension, the form a ``DTensor``
takes (the reference's ``named_sharding``).

Under a ``DeviceMesh`` each rank stores and computes its own slice:
:func:`local_slices` / :func:`local_shape` give a rank's index range in
every dimension of a resolved spec (a dimension split over several mesh
axes is cut row-major over them, in the order the spec names them), and
:func:`batch_rows` the rows of a batch a rank runs.  Under an abstract
mesh one process holds every slice: the local shape is the whole shape,
while :func:`axis_size` still reports the mesh (the MoE group count reads
it), so one process computes the function of the split run.
:func:`global_batch` and :func:`global_seq` name the whole batch and the
residual stream's positions of a model's computation, which a rank holds
a block of.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

AxisName = Union[str, Tuple[str, ...], None]

#: Default logical -> physical rules of the production meshes.  "fsdp" is
#: every data-parallel axis the mesh has (pod and data).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "seq_tp": ("model",),  # sequence/context parallelism
    "heads_tp": ("model",),  # tensor parallelism over heads
    "embed_tp": ("model",),  # tensor parallelism over hidden/ffn
    "vocab_tp": ("model",),
    "expert_tp": ("model",),  # expert parallelism
    "kv_seq_tp": ("model",),  # KV-cache sequence sharding
    "layer": (),  # the reference's scan-stacked layer dim: replicated
}


class _Ctx:
    """The mesh context, one a process: each rank is a process of its own,
    and the autograd engine runs a backward (and the recompute of a
    ``torch.utils.checkpoint`` region) on a thread of its own, which must
    see the forward's mesh."""

    def __init__(self):
        self.mesh = None
        self.shape: Dict[str, int] = {}
        self.rules: Dict[str, Tuple[str, ...]] = {}
        self.batch: Optional[int] = None
        self.seq: Optional[int] = None
        self.rank: Optional[int] = None
        self.memo: dict = {}


_CTX = _Ctx()


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or an abstract mapping, in mesh order."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


@contextlib.contextmanager
def activate(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None,
             rank: Optional[int] = None):
    """Make ``mesh`` (a ``DeviceMesh``, an ``{axis: size}`` mapping, or None)
    and ``rules`` (default :data:`DEFAULT_RULES`) current for the block.
    ``rank`` (an abstract mapping only) makes the process answer as that
    rank of the mesh (:func:`planning`)."""
    if rank is not None and not isinstance(mesh, Mapping):
        raise ValueError("activate: rank= plans on an abstract {axis: size} mesh only")
    prev = (_CTX.mesh, _CTX.shape, _CTX.rules, _CTX.memo, _CTX.rank)
    _CTX.mesh = mesh
    _CTX.shape = mesh_shape(mesh)
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    _CTX.memo = {}
    _CTX.rank = rank
    try:
        yield
    finally:
        _CTX.mesh, _CTX.shape, _CTX.rules, _CTX.memo, _CTX.rank = prev


def active_mesh():
    """The mesh of the innermost :func:`activate`, or None."""
    return _CTX.mesh


def mesh_axes() -> Tuple[str, ...]:
    """The active mesh's axis names, in mesh order (empty without one)."""
    return tuple(_CTX.shape)


def memo() -> dict:
    """A cache that lives as long as the innermost :func:`activate` (what a
    spec resolves to on this mesh and rank does not change within it)."""
    return _CTX.memo


def axes_size(axes: Sequence[str]) -> int:
    """The product of the active mesh's sizes of ``axes`` (those it has)."""
    return math.prod(_CTX.shape[a] for a in axes if a in _CTX.shape)


def distributed() -> bool:
    """Whether each rank holds its own slices: the active mesh is a
    ``DeviceMesh``, or an abstract one planned as one rank
    (:func:`planning`).  Under an abstract mesh without a rank one
    process holds them all."""
    return _CTX.mesh is not None and (not isinstance(_CTX.mesh, Mapping)
                                      or _CTX.rank is not None)


def planning() -> bool:
    """Whether the active mesh is abstract and answered as one rank: no
    process group exists, and a collective only gives its result's shape."""
    return isinstance(_CTX.mesh, Mapping) and _CTX.rank is not None


def coordinates() -> Dict[str, int]:
    """This rank's index along each axis of the active ``DeviceMesh`` or
    planned rank (every index 0 under an abstract mesh or none)."""
    if planning():
        coords, rest = {}, _CTX.rank
        for ax in reversed(list(_CTX.shape)):
            rest, coords[ax] = divmod(rest, _CTX.shape[ax])
        return {ax: coords[ax] for ax in _CTX.shape}
    if not distributed():
        return {ax: 0 for ax in _CTX.shape}
    return dict(zip(_CTX.shape, _CTX.mesh.get_coordinate()))


def rule_axes(logical: str) -> Tuple[str, ...]:
    """The active mesh's axes that the rules map ``logical`` to, in rule order."""
    return tuple(a for a in _CTX.rules.get(logical, ()) if a in _CTX.shape)


def entry_axes(entry: AxisName) -> Tuple[str, ...]:
    """One entry of :func:`resolve_spec` as a tuple of mesh axes."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(shape: Sequence[int], logical_axes: Sequence[AxisName],
                 coords: Optional[Mapping[str, int]] = None) -> Tuple[slice, ...]:
    """The index range, per dimension, of the slice the rank at ``coords``
    holds of a ``shape`` tensor laid out by ``logical_axes``.

    A dimension :func:`resolve_spec` maps to mesh axes ``(a1, a2, ...)``
    is cut into ``prod(sizes)`` equal blocks, and the rank takes the
    block of its row-major index over those axes.  ``coords`` defaults to
    this rank's (:func:`coordinates`); without a ``DeviceMesh`` and
    without ``coords`` every range is whole.
    """
    if coords is None:
        if not distributed():
            return tuple(slice(0, d) for d in shape)
        coords = coordinates()
    spec = resolve_spec(shape, logical_axes) or (None,) * len(shape)
    return _cut(shape, [entry_axes(e) for e in spec], coords)


def _cut(shape: Sequence[int], dim_axes, coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """Each dimension cut into one equal block per rank of its mesh axes
    (``dim_axes``: a tuple of axes a dimension), the block of ``coords``'
    row-major index over those axes."""
    out = []
    for dim, axes in zip(shape, dim_axes):
        n, idx = 1, 0
        for ax in axes:
            n *= _CTX.shape[ax]
            idx = idx * _CTX.shape[ax] + int(coords[ax])
        per = dim // n
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def local_shape(shape: Sequence[int], logical_axes: Sequence[AxisName]) -> Tuple[int, ...]:
    """The shape of this rank's slice (:func:`local_slices`)."""
    return tuple(s.stop - s.start for s in local_slices(shape, logical_axes))


def split_axes(size: int, logical: AxisName) -> Tuple[str, ...]:
    """The mesh axes a dimension of ``size`` named ``logical`` is split over
    on this rank's mesh (empty where it is whole: no ``DeviceMesh``, the
    divisibility fallback replicated it, or its axes hold one rank)."""
    if not distributed():
        return ()
    axes = entry_axes(resolve_spec((size,), (logical,))[0])
    return axes if math.prod(_CTX.shape[a] for a in axes) > 1 else ()


def batch_rows(batch: int) -> slice:
    """The rows of a ``batch``-row input this rank runs: its block over the
    batch axes, or every row where they do not divide ``batch``."""
    key = ("rows", batch)
    if key not in _CTX.memo:
        _CTX.memo[key] = local_slices((batch,), ("batch",))[0]
    return _CTX.memo[key]


@contextlib.contextmanager
def global_batch(batch: int):
    """Name ``batch`` as the whole batch of the block's computation; a
    layer that works across rows (the MoE token groups) reads it with
    :func:`current_batch`."""
    prev = _CTX.batch
    _CTX.batch = batch
    try:
        yield
    finally:
        _CTX.batch = prev


def current_batch() -> Optional[int]:
    """The whole batch named by the innermost :func:`global_batch`, or None."""
    return _CTX.batch


@contextlib.contextmanager
def global_seq(seq: Optional[int]):
    """Name ``seq`` as the positions of the residual stream of the block's
    computation: between its sublayers a rank holds its block of them,
    ``local_slices((seq,), ("seq_tp",))`` (the reference's ``(B, S, D)``
    under ``("batch", "seq_tp", None)``), and each sublayer reads the
    layout from :func:`current_seq` (``sharding/collectives.py``:
    ``stream_range``).  None: no stream (a sublayer called alone takes
    and returns every position)."""
    prev = _CTX.seq
    _CTX.seq = seq
    try:
        yield
    finally:
        _CTX.seq = prev


def current_seq() -> Optional[int]:
    """The positions named by the innermost :func:`global_seq`, or None."""
    return _CTX.seq


def axis_size(logical: str) -> int:
    """Product of the mesh-axis sizes a logical axis maps to (1 if inactive)."""
    shape = _CTX.shape
    if _CTX.mesh is None:
        return 1
    return math.prod(shape[a] for a in _CTX.rules.get(logical, ()) if a in shape)


def resolve_spec(shape: Sequence[int], logical_axes: Sequence[AxisName]) -> Tuple[AxisName, ...]:
    """Map logical axes to mesh axes, dropping indivisible assignments.

    One entry per dimension: ``None`` (replicated), a mesh-axis name, or
    a tuple of names.  A mesh axis is used by one dimension at most.
    Where the axes' product does not divide the dimension, trailing axes
    are dropped until it does (or none is left).  Without an active mesh
    the spec is empty, as the reference's ``P()``.
    """
    mshape = _CTX.shape
    if _CTX.mesh is None:
        return ()
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    used: set = set()
    out: list = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        names = (name,) if isinstance(name, str) else tuple(name)
        phys: list = []
        for ln in names:
            for ax in _CTX.rules.get(ln, ()):
                if ax in mshape and ax not in used:
                    phys.append(ax)
        if not phys:
            out.append(None)
            continue
        total = math.prod(mshape[a] for a in phys)
        if dim % total != 0 or dim == 0:
            while phys:
                total = math.prod(mshape[a] for a in phys)
                if dim % total == 0 and total > 1:
                    break
                phys.pop()
            if not phys:
                out.append(None)
                continue
        used.update(phys)
        out.append(tuple(phys) if len(phys) > 1 else phys[0])
    return tuple(out)


def placements(shape: Sequence[int], logical_axes: Sequence[AxisName]):
    """One ``Shard(d)`` / ``Replicate()`` per mesh dimension, or None without a mesh.

    The ``DTensor`` form of :func:`resolve_spec` (the reference's
    ``named_sharding``).  A dimension split over several mesh axes shards
    along each of them, in order.
    """
    from torch.distributed.tensor import Replicate, Shard

    if _CTX.mesh is None:
        return None
    spec = resolve_spec(shape, logical_axes)
    by_axis = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            by_axis[ax] = Shard(d)
    return tuple(by_axis.get(ax, Replicate()) for ax in _CTX.shape)


def placement_slices(shape: Sequence[int], place,
                     coords: Optional[Mapping[str, int]] = None) -> Tuple[slice, ...]:
    """The index range, per dimension, that the rank at ``coords`` (default:
    this rank's) holds of a ``shape`` tensor laid out by ``place`` (one
    ``Shard(d)`` / ``Replicate()`` per axis of the active mesh, as
    :func:`placements` gives them; None: whole).  A dimension sharded
    along several axes is cut row-major over them in mesh order, as
    :func:`local_slices` cuts it; without a ``DeviceMesh`` and without
    ``coords`` every range is whole."""
    if place is None or _CTX.mesh is None or (coords is None and not distributed()):
        return tuple(slice(0, d) for d in shape)
    dim_axes = [tuple(ax for ax, pl in zip(_CTX.shape, place) if getattr(pl, "dim", None) == d)
                for d in range(len(shape))]
    return _cut(shape, dim_axes, coordinates() if coords is None else coords)


def constrain(x: torch.Tensor, logical_axes: Sequence[AxisName]) -> torch.Tensor:
    """Lay ``x`` out by logical names: the reference's ``with_sharding_constraint``.

    Without a mesh, ``x`` comes back unchanged; with one, a ``DTensor``
    is redistributed to :func:`placements` and a plain tensor is left as
    it is (a plain tensor is one rank's whole value).
    """
    if _CTX.mesh is None or isinstance(_CTX.mesh, Mapping) or type(x) in (torch.Tensor,
                                                                          torch.nn.Parameter):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_CTX.mesh, placements(x.shape, logical_axes))
