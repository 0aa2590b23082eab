"""Operation counts of an eager PyTorch function: matmul flops and tensor traffic.

Takes over the role that ``repro/launch/hlo_stats.py`` plays for the
reference's autotuner.  The reference compiles its XLA solver and reads
the HLO text, multiplying each ``while`` body by its trip count.  Torch
runs eagerly and has no HLO, so this module counts what actually runs:
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten
operation a function executes (composites such as ``einsum`` and
``matmul`` arrive already lowered to ``bmm``/``mm`` and views), so a
Python loop is counted once per trip, with no trip-count recovery to
get wrong.

* ``dot_flops``     — ``2 M N K`` for every ``mm``/``bmm``/``addmm``/
  ``baddbmm`` (``2 M K`` for ``mv``, ``2 K`` for ``dot``); under
  ``torch.inference_mode`` the composites ``matmul`` and ``einsum``
  reach the counter undecomposed, and count the same (an ``einsum`` of
  two operands: twice the product of its index sizes).
* ``traffic_bytes`` — the bytes of each operation's tensor inputs and
  outputs, each counted once per operation (a broadcast input counts
  its distinct elements); views and metadata operations cost nothing.
  This is the eager loop's device-memory traffic model: every eager
  operation reads its operands from device memory and writes its result
  back, which is what the plain loops pay and a fused kernel does not.
* ``ops``           — operations counted (views and metadata excluded):
  the launches an eager loop issues, each a host round trip.

Why counting, and not the analytic profile alone: the autotuner ranks
the plain ``torch`` loop against the kernels, and the analytic
roofline (``runtime/roofline.py``) only knows the fused kernel's
traffic.  Counting measures the plain loop itself, operation for
operation, as the reference's HLO reader measures its ``xla`` solver;
``runtime/autotune.py:op_profile`` differences two iteration caps to
isolate one iteration.  The counts do not depend on the device, so
they are taken on CPU tensors, with no device work.

The reference's collective bytes and ``summarize`` have no counterpart:
the port's solves run on one device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten


def _dot_flops(packet, args) -> float:
    """``2 M N K`` of a contraction from its operand shapes, else 0."""
    if packet in (aten.addmm, aten.baddbmm):
        args = args[1:]  # the added term
    if packet in (aten.mm, aten.addmm):
        a, b = args[:2]
        return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = args[:2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if packet is aten.mv:
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if packet is aten.dot:
        return 2.0 * args[0].shape[0]
    if packet is aten.matmul:
        a, b = (t.shape if t.dim() > 1 else (1,) + tuple(t.shape) for t in args[:2])
        if len(args[1].shape) == 1:
            b = (args[1].shape[0], 1)
        batch = torch.broadcast_shapes(tuple(a[:-2]), tuple(b[:-2]))
        return 2.0 * math.prod(batch) * a[-2] * b[-1] * a[-1]
    if packet is aten.einsum and len(args[1]) == 2:
        sizes = {}
        for spec, t in zip(args[0].replace(" ", "").split("->")[0].split(","), args[1]):
            sizes.update(zip(spec, t.shape))
        return 2.0 * math.prod(sizes.values())
    return 0.0


#: Operations that move no data: allocation and metadata (views are
#: recognised by ``OpOverload.is_view``).
_FREE = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.lift_fresh, aten.alias,
    aten._unsafe_view, aten._reshape_alias, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
}


def _shape_bytes(dtype: torch.dtype, dims: Iterable[int]) -> int:
    """Bytes of a dense tensor of ``dtype`` and shape ``dims``."""
    return torch.empty((), dtype=dtype).element_size() * math.prod(int(d) for d in dims)


def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (a broadcast, stride-0
    dimension counts once)."""
    dims = [s for s, st in zip(t.shape, t.stride()) if st != 0]
    return _shape_bytes(t.dtype, dims)


class OpCounter(TorchDispatchMode):
    """Counts ``dot_flops``, ``traffic_bytes`` and ``ops`` of what runs under it."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.traffic_bytes = 0.0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return out
        flops = _dot_flops(packet, args)
        byts = float(sum(_tensor_bytes(t) for t in tree_leaves((args, kwargs, out))
                         if isinstance(t, torch.Tensor)))
        self.dot_flops += flops
        self.traffic_bytes += byts
        self.ops += 1
        return out


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` under :class:`OpCounter`; its counts.

    Returns ``{"dot_flops", "traffic_bytes", "ops"}``: the first two are
    the keys ``hlo_stats.analyze`` gives the reference's tuner.
    """
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return {
        "dot_flops": counter.dot_flops,
        "traffic_bytes": counter.traffic_bytes,
        "ops": float(counter.ops),
    }
