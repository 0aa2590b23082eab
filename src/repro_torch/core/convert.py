"""Carry data across the two packages through numpy.

The port's records (``LPBatch``, ``SharedLPBatch``, ``LPProblem``,
``ResumeState``, ``RevisedResumeState``, ``LPSolution``) are dataclasses
of tensors, and so are the reference's of arrays.  :func:`to_numpy`
turns any such record into a dict of numpy arrays (plain fields such as
``LPProblem``'s structure flags pass through); :func:`from_numpy` builds
a port record from such a dict on a device, keeping each array's shape
(``SharedLPBatch.a`` has no batch axis).  A reference ``ResumeState`` or
``RevisedResumeState`` taken to numpy can so continue in the port, and a
port ``LPSolution`` can be held against the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Type, TypeVar

import numpy as np
import torch

from .lp import resolve_device

R = TypeVar("R")


def to_numpy(record: Any) -> Dict[str, Any]:
    """A dataclass record as ``{field: numpy array | None | plain value}``.

    Works on the port's tensor records and on any other dataclass whose
    array fields ``np.asarray`` understands.
    """
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(record):
        v = getattr(record, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def from_numpy(cls: Type[R], data: Mapping[str, Any], device=None) -> R:
    """Build the port record ``cls`` from a mapping of arrays.

    Array fields become tensors on ``device`` (None = the card) with
    their numpy dtype kept (int32 bases stay int32); plain values pass
    through; fields missing from ``data`` keep their defaults.
    """
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if v is None or isinstance(v, (bool, int, float, str)):
            kwargs[f.name] = v
        else:
            kwargs[f.name] = torch.as_tensor(np.array(v), device=dev)
    return cls(**kwargs)
