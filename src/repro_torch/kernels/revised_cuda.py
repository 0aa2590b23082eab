"""The CUDA revised-simplex kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/revised_pallas.py`` (the Pallas TPU kernel).
:func:`revised` launches ``csrc/revised.cu`` on CUDA tensors and runs
:func:`revised_plain`, the lockstep loop of ``core/revised.py``, on CPU
tensors.  Both take the same arguments and write the terminal state the
same way:

* ``a`` (m, n) is the one shared constraint matrix; ``b`` (B, m),
  ``c`` (B, n) and ``feas`` (B,) the per-LP data;
* ``binv`` (B, m, m), ``basis`` (B, m) int32, ``xb`` (B, m) and ``phase``
  (B,) int32 are updated in place to the terminal state (so a resume is
  the same call on the same buffers);
* the return value is ``(x, status, iterations)``; the objective is
  computed by the caller from the terminal ``(basis, xb)``
  (``core/revised.py:objective``).

On the card the two are bit-identical (see ``core/revised.py`` for the
rules that make them so).  There is no fallback: a CUDA tensor goes to
the kernel, every shape runs there, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import revised as _revised
from ..core.engine import BLAND, LPC, RPC

#: Kernel launches so far; raised by one per launch of the CUDA kernel only.
launches = 0

_RULE_CODES = {LPC: 0, RPC: 1, BLAND: 2}
_SYMBOLS = {torch.float32: "revised_f32", torch.float64: "revised_f64"}


def _check(a, b, c, binv, basis, xb, phase, feas):
    if a.dtype not in _SYMBOLS:
        raise TypeError(f"revised kernel takes float32 or float64, got {a.dtype}")
    if a.dim() != 2:
        raise ValueError(f"revised kernel: a is {tuple(a.shape)}, expected (m, n)")
    m, n = a.shape
    bsz = b.shape[0]
    want = {
        "a": (a, (m, n), a.dtype),
        "b": (b, (bsz, m), a.dtype),
        "c": (c, (bsz, n), a.dtype),
        "binv": (binv, (bsz, m, m), a.dtype),
        "basis": (basis, (bsz, m), torch.int32),
        "xb": (xb, (bsz, m), a.dtype),
        "phase": (phase, (bsz,), torch.int32),
        "feas": (feas, (bsz,), a.dtype),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"revised kernel: {name} is {tuple(t.shape)} {t.dtype}, expected {shape} {dtype}"
            )
        if t.device != a.device:
            raise ValueError(f"revised kernel: {name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"revised kernel: {name} is not contiguous")


def revised_plain(a, b, c, binv, basis, xb, phase, feas, cap: int, *, rule: str = LPC,
                  seed: int = 0, tol: float = 1e-5):
    """The kernel's function in plain PyTorch (the lockstep loop)."""
    _check(a, b, c, binv, basis, xb, phase, feas)
    state = _revised.RevisedResumeState(binv, basis, xb, phase)
    sol, out = _revised._iterate(a, b, c, state, feas, cap, seed, rule=rule, tol=tol)
    binv.copy_(out.binv)
    basis.copy_(out.basis)
    xb.copy_(out.xb)
    phase.copy_(out.phase)
    return sol.x, sol.status, sol.iterations


def revised(a, b, c, binv, basis, xb, phase, feas, cap: int, *, rule: str = LPC,
            seed: int = 0, tol: float = 1e-5):
    """Run the revised simplex on every LP of the batch, up to ``cap`` steps.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`revised_plain`.
    """
    global launches
    if not a.is_cuda:
        return revised_plain(a, b, c, binv, basis, xb, phase, feas, cap, rule=rule, seed=seed,
                             tol=tol)
    _check(a, b, c, binv, basis, xb, phase, feas)
    if rule not in _RULE_CODES:
        raise ValueError(f"unknown pivot rule {rule!r}")
    from . import build  # the library is built at first launch, never at import

    lib = build.load("revised")
    fn = getattr(lib, _SYMBOLS[a.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 5
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_double, ctypes.c_void_p]
    )
    bsz = b.shape[0]
    m, n = a.shape
    dev = a.device
    x = torch.empty((bsz, n), dtype=a.dtype, device=dev)
    status = torch.empty((bsz,), dtype=torch.int32, device=dev)
    iters = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz == 0:
        return x, status, iters
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), binv.data_ptr(), basis.data_ptr(),
            xb.data_ptr(), phase.data_ptr(), feas.data_ptr(), x.data_ptr(), status.data_ptr(),
            iters.data_ptr(), bsz, m, n, int(cap), _RULE_CODES[rule],
            int(seed) & 0xFFFFFFFF, 0, float(tol), stream,
        )
    if err != 0:
        lib.revised_error_string.restype = ctypes.c_char_p
        lib.revised_error_string.argtypes = [ctypes.c_int]
        msg = lib.revised_error_string(err).decode()
        raise RuntimeError(f"revised kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return x, status, iters
