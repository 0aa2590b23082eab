"""The CUDA hyperbox kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/hyperbox_pallas.py``.  :func:`hyperbox`
computes ``sum_i d_i * (d_i < 0 ? lo_i : hi_i)`` per row of the
directions ``d`` (B, n): on CUDA tensors with ``csrc/hyperbox.cu``, on
CPU tensors with :func:`hyperbox_plain` (``core/hyperbox.py:support``).
``lo`` and ``hi`` are either (B, n) or one box, (n,) or (1, n), which
the kernel reads with row stride 0 instead of materialising it.

The kernel sums each row in ascending order in double (one rounding to
float32 at the end), ``torch.sum`` in its own order, so the two agree to
rounding (rtol 1e-6 in float32, 1e-12 in float64, relative to the sum of
the absolute terms), not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.hyperbox import support

#: Kernel launches so far; raised by one per launch of the CUDA kernel only.
launches = 0

_SYMBOLS = {torch.float32: "hyperbox_f32", torch.float64: "hyperbox_f64"}


def _box_stride(v: torch.Tensor, d: torch.Tensor, name: str) -> int:
    """Row stride of a bound: ``n`` for a (B, n) array, 0 for one box."""
    bsz, n = d.shape
    if v.dtype != d.dtype or v.device != d.device:
        raise ValueError(f"hyperbox kernel: {name} is {v.dtype} on {v.device}, "
                         f"directions {d.dtype} on {d.device}")
    if not v.is_contiguous():
        raise ValueError(f"hyperbox kernel: {name} is not contiguous")
    if tuple(v.shape) == (bsz, n):
        return n
    if tuple(v.shape) in ((n,), (1, n)):
        return 0
    raise ValueError(f"hyperbox kernel: {name} is {tuple(v.shape)}, expected "
                     f"({bsz}, {n}), ({n},) or (1, {n})")


def hyperbox_plain(lo, hi, directions) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return support(lo, hi, directions)


def hyperbox(lo, hi, directions) -> torch.Tensor:
    """Box support values (B,) of ``directions`` (B, n)."""
    global launches
    from . import build  # the library is built at first launch, never at import

    if not directions.is_cuda:
        build.note_specialization("hyperbox", directions.dtype, "plain")
        return hyperbox_plain(lo, hi, directions)
    d = directions
    if d.dim() != 2 or d.dtype not in _SYMBOLS or not d.is_contiguous():
        raise ValueError(f"hyperbox kernel: directions must be a contiguous (B, n) "
                         f"float32/float64 tensor, got {tuple(d.shape)} {d.dtype}")
    lo_stride = _box_stride(lo, d, "lo")
    hi_stride = _box_stride(hi, d, "hi")
    out = torch.empty((d.shape[0],), dtype=d.dtype, device=d.device)
    if d.shape[0] == 0:
        return out
    lib = build.load("hyperbox")
    fn = getattr(lib, _SYMBOLS[d.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(lo.data_ptr(), hi.data_ptr(), d.data_ptr(), out.data_ptr(),
                 d.shape[0], d.shape[1], lo_stride, hi_stride, stream)
    if err != 0:
        raise build.launch_error(lib, "hyperbox", err, "hyperbox kernel")
    with build.LAUNCH_LOCK:
        launches += 1
    build.note_specialization("hyperbox", d.dtype, "kernel")
    return out
