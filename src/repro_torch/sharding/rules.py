"""Parameter specs: one source of truth for shapes, dtypes and init.

Follows ``repro/sharding/rules.py``.  A model module describes its
parameters as a tree (nested dicts) of ``ParamSpec`` leaves, and
``materialize`` makes the tensors.  ``sharding/partition.py`` resolves
the logical axes against a mesh; the model files do not call its
``constrain`` yet, which does nothing on one device (``ROADMAP.md``, item
6.5b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


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


def materialize(specs, generator: torch.Generator, device, dtype_override: Optional[str] = None):
    """Tensors for a tree of ``ParamSpec``s, each made directly on ``device``.

    ``zeros`` and ``ones`` are constant; ``normal`` draws float32 normals
    from ``generator`` (which must live on ``device``), scales them by
    ``ParamSpec.std`` and casts to the leaf's dtype.  Leaves are drawn in
    the tree's sorted key order.  The bits differ from the reference's
    ``jax.random`` draws (``ROADMAP.md``, "Kept divergences"): weights
    that must agree with it come from ``models/convert.py``.
    """
    device = torch.device(device)

    def make(spec: ParamSpec) -> torch.Tensor:
        dt = getattr(torch, dtype_override or spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * spec.std()).to(dt)

    def walk(tree):
        if isinstance(tree, ParamSpec):
            return make(tree)
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(specs)
