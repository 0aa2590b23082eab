"""The CUDA PDHG kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/pdhg_pallas.py`` (the Pallas TPU kernel).
:func:`pdhg` launches ``csrc/pdhg.cu`` on CUDA tensors and runs
:func:`pdhg_plain`, the lockstep loop of ``core/pdhg.py``, on CPU
tensors.  Both take the same arguments and write the terminal state the
same way:

* ``a`` (B, m, n), ``b`` (B, m), ``c`` (B, n) are the problem data;
* ``state`` is a :class:`~repro_torch.core.pdhg.PDHGResumeState` whose
  nine buffers are updated in place to the terminal state (so a resume
  is the same call on the same buffers);
* ``tau``, ``sigma`` and ``scales = (anorm, bscale, cscale)``, each (B,),
  are the step sizes of ``core/pdhg.py:step_sizes``, computed once by the
  caller, so both versions step with the same bits;
* the return value is ``(status, iterations)``; the objective is
  computed by the caller (``core/pdhg.py:objective``).

The two agree in status and step count per LP and in the iterates to
rounding; they are not bit-identical (the plain matvecs are library
products with their own reduction order).  There is no fallback: a CUDA
tensor goes to the kernel, every shape runs there, and a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import pdhg as _pdhg

#: Kernel launches so far; raised by one per launch of the CUDA kernel only.
launches = 0

_SYMBOLS = {torch.float32: "pdhg_f32", torch.float64: "pdhg_f64"}


def _check(a, b, c, state: _pdhg.PDHGResumeState, tau, sigma, scales):
    if a.dtype not in _SYMBOLS:
        raise TypeError(f"pdhg kernel takes float32 or float64, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"pdhg kernel: a is {tuple(a.shape)}, expected (B, m, n)")
    bsz, m, n = a.shape
    vec = {"b": m, "c": n, "x": n, "y": m, "ax": m, "x_sum": n, "y_sum": m, "ax_sum": m}
    want = {"a": (a, (bsz, m, n), a.dtype), "b": (b, (bsz, m), a.dtype),
            "c": (c, (bsz, n), a.dtype)}
    for name in list(vec)[2:]:
        want[name] = (getattr(state, name), (bsz, vec[name]), a.dtype)
    want["inner"] = (state.inner, (bsz,), torch.int32)
    for name, t in [("x_grow", state.x_grow), ("y_grow", state.y_grow), ("tau", tau),
                    ("sigma", sigma), ("anorm", scales[0]), ("bscale", scales[1]),
                    ("cscale", scales[2])]:
        want[name] = (t, (bsz,), a.dtype)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"pdhg kernel: {name} is {tuple(t.shape)} {t.dtype}, expected {shape} {dtype}"
            )
        if t.device != a.device:
            raise ValueError(f"pdhg kernel: {name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"pdhg kernel: {name} is not contiguous")


def pdhg_plain(a, b, c, state: _pdhg.PDHGResumeState, tau, sigma, scales, cap: int, *,
               tol: float, restart: int):
    """The kernel's function in plain PyTorch (the lockstep loop)."""
    _check(a, b, c, state, tau, sigma, scales)
    status, iters, out = _pdhg.iterate_with(a, b, c, state, cap, tau, sigma, scales, tol=tol,
                                            restart=restart)
    for f in dataclasses.fields(state):
        getattr(state, f.name).copy_(getattr(out, f.name))
    return status, iters


def pdhg(a, b, c, state: _pdhg.PDHGResumeState, tau, sigma, scales, cap: int, *, tol: float,
         restart: int):
    """Run restarted PDHG on every LP of the batch, up to ``cap`` steps.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`pdhg_plain`.
    """
    global launches
    if not a.is_cuda:
        return pdhg_plain(a, b, c, state, tau, sigma, scales, cap, tol=tol, restart=restart)
    _check(a, b, c, state, tau, sigma, scales)
    from . import build  # the library is built at first launch, never at import

    lib = build.load("pdhg")
    fn = getattr(lib, _SYMBOLS[a.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 5
                   + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p])
    bsz, m, n = a.shape
    dev = a.device
    status = torch.empty((bsz,), dtype=torch.int32, device=dev)
    iters = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz == 0:
        return status, iters
    scratch = torch.empty((bsz, n), dtype=a.dtype, device=dev)
    ptrs = [t.data_ptr() for t in (
        a, b, c, state.x, state.y, state.ax, state.x_sum, state.y_sum, state.ax_sum,
        state.inner, state.x_grow, state.y_grow, tau, sigma, *scales, scratch, status, iters)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, bsz, m, n, int(cap), int(restart), float(tol),
                 _pdhg.GROWTH_FRACTION * restart, stream)
    if err != 0:
        lib.pdhg_error_string.restype = ctypes.c_char_p
        lib.pdhg_error_string.argtypes = [ctypes.c_int]
        msg = lib.pdhg_error_string(err).decode()
        raise RuntimeError(f"pdhg kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return status, iters
