"""Parameter specs: one source of truth for shapes, dtypes and init.

Follows ``repro/sharding/rules.py``.  A model module describes its
parameters as a tree (nested dicts) of ``ParamSpec`` leaves, and
``materialize`` makes the tensors.  ``sharding/partition.py`` resolves
the logical axes against the active mesh: under a ``DeviceMesh`` each
rank stores only its slice of every leaf (``partition.local_slices``),
``materialize`` keeps only that slice, and :func:`shardings` gives each
leaf's placements (the reference's ``NamedSharding`` tree).  The model
files call ``partition.constrain`` where the reference does, and reach
other ranks through ``sharding/collectives.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import partition

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def std(self) -> float:
        """The reference's rule: ``scale / sqrt(shape[-2])`` for tensors of
        two or more dimensions, ``scale`` otherwise."""
        if len(self.shape) >= 2:
            return self.scale / math.sqrt(self.shape[-2])
        return self.scale


def leaves(tree, path=()):
    """(path, leaf) pairs of a tree of nested dicts, in sorted-path order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def draw(spec: ParamSpec, generator: torch.Generator, device,
         dtype_override: Optional[str] = None) -> torch.Tensor:
    """One leaf of :func:`materialize`: ``zeros`` and ``ones`` are constant;
    ``normal`` draws float32 normals from ``generator`` (which must live on
    ``device``), scales them by ``ParamSpec.std`` in place and casts to the
    leaf's dtype.  Under a ``DeviceMesh`` the leaf is drawn whole and the
    rank's slice (``partition.local_slices``) kept."""
    dt = getattr(torch, dtype_override or spec.dtype)
    local = partition.local_shape(spec.shape, spec.axes)
    if spec.init == "zeros":
        return torch.zeros(local, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(local, dtype=dt, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    if local != tuple(spec.shape):
        x = x[partition.local_slices(spec.shape, spec.axes)].clone()
    return x.mul_(spec.std()).to(dt)


def materialize(specs, generator: torch.Generator, device, dtype_override: Optional[str] = None):
    """Tensors for a tree of ``ParamSpec``s, each made directly on ``device``
    by :func:`draw`, in the tree's sorted key order.  The bits differ from
    the reference's ``jax.random`` draws (``ROADMAP.md``, "Kept
    divergences"): weights that must agree with it come from
    ``models/convert.py``.

    Under a ``DeviceMesh`` each leaf is drawn whole (every rank draws the
    same stream), the rank's slice is kept and the rest is freed before
    the next leaf: no rank holds more than one whole leaf at a time.
    """
    device = torch.device(device)

    def walk(tree):
        if isinstance(tree, ParamSpec):
            return draw(tree, generator, device, dtype_override)
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(specs)


def shardings(specs):
    """The placements of every leaf of a spec tree on the active mesh
    (``partition.placements``; None leaves without a mesh)."""
    if isinstance(specs, ParamSpec):
        return partition.placements(specs.shape, specs.axes)
    return {k: shardings(specs[k]) for k in sorted(specs)}
