"""The CUDA revised-simplex kernel's wrappers and their plain PyTorch versions.

Replaces ``repro/kernels/revised_pallas.py`` (the Pallas TPU kernel) and
the ``lax.scan`` of ``repro/core/revised.py:sweep_batched`` around it.
:func:`revised` and :func:`revised_sweep` launch ``csrc/revised.cu`` on
CUDA tensors and run :func:`revised_plain` and
:func:`revised_sweep_plain`, the lockstep loops of ``core/revised.py``,
on CPU tensors.  Each pair takes the same arguments and gives the same
results:

* ``a`` (m, n) is the one shared constraint matrix; ``b`` (B, m) and
  ``feas`` (B,) the per-LP data; ``c`` (B, n), or for the sweep a
  ``c_stack`` (T, B, n) of cost rows;
* :func:`revised` updates ``binv`` (B, m, m), ``basis`` (B, m) int32,
  ``xb`` (B, m) and ``phase`` (B,) int32 in place to the terminal state
  (so a resume is the same call on the same buffers) and returns
  ``(objective, x, status, iterations)``; the kernel computes the
  objective from the terminal ``(basis, xb)`` as
  ``core/revised.py:objective`` does;
* :func:`revised_sweep` returns the same four with a leading (T, B): the
  whole sweep is one launch, each LP restarting warm from its own
  terminal state where the step before ended OPTIMAL (``warm``) and
  cold elsewhere.

The kernel has two variants (``csrc/revised.cu``): the resident variant,
one CTA an LP holding ``binv`` in shared memory, and the global variant,
``binv`` in device memory, for shapes past the resident budget.
``kernels/cluster.py:plan_revised`` picks one from the shape before the
launch.  On the card both are
bit-identical to the plain version (see ``core/revised.py`` for the rules
that make them so).  There is no fallback: a CUDA tensor goes to the
kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import revised as _revised
from ..core.engine import BLAND, LPC, RPC
from . import cluster

#: Kernel launches so far; raised by one per launch of the CUDA kernel only
#: (a whole sweep is one launch).
launches = 0
#: The same launches by variant.
variant_launches = {"resident": 0, "global": 0}

_RULE_CODES = {LPC: 0, RPC: 1, BLAND: 2}


def _check(a, b, c, feas, state=(), steps=None):
    """Shapes, types, devices and contiguity; ``c`` is (B, n), or (steps, B, n)
    for a sweep."""
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"revised kernel takes float32 or float64, got {a.dtype}")
    if a.dim() != 2:
        raise ValueError(f"revised kernel: a is {tuple(a.shape)}, expected (m, n)")
    m, n = a.shape
    bsz = b.shape[0]
    want = {
        "a": (a, (m, n), a.dtype),
        "b": (b, (bsz, m), a.dtype),
        "c": (c, (bsz, n) if steps is None else (steps, bsz, n), a.dtype),
        "feas": (feas, (bsz,), a.dtype),
    }
    if state:
        binv, basis, xb, phase = state
        want.update({
            "binv": (binv, (bsz, m, m), a.dtype),
            "basis": (basis, (bsz, m), torch.int32),
            "xb": (xb, (bsz, m), a.dtype),
            "phase": (phase, (bsz,), torch.int32),
        })
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
    _check(a, b, c, feas, (binv, basis, xb, phase))
    state = _revised.RevisedResumeState(binv, basis, xb, phase)
    sol, out = _revised._iterate(a, b, c, state, feas, cap, seed, rule=rule, tol=tol)
    binv.copy_(out.binv)
    basis.copy_(out.basis)
    xb.copy_(out.xb)
    phase.copy_(out.phase)
    return sol.objective, sol.x, sol.status, sol.iterations


def revised_sweep_plain(a, b, c_stack, feas, cap: int, *, rule: str = LPC, seed: int = 0,
                        tol: float = 1e-5, warm: bool = True):
    """The sweep's function in plain PyTorch: one lockstep loop a step."""
    _check(a, b, c_stack, feas, steps=c_stack.shape[0])

    def step(c_t, start):
        return _revised._iterate(a, b, c_t, start, feas, cap, seed, rule=rule, tol=tol)

    return _revised.sweep_loop(a, b, c_stack, step, warm)


def _symbol(lib, name: str, dtype: torch.dtype, n_ptr: int, n_int: int, tail):
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + tail
    return fn


def _raise(lib, err: int, how: cluster.Plan, what: str):
    from . import build

    raise build.launch_error(lib, "revised", err, f"revised {what} ({how.variant})")


def _count(how: cluster.Plan, entry: str, dtype):
    global launches
    from . import build

    with build.LAUNCH_LOCK:
        launches += 1
        variant_launches[how.variant] += 1
    build.note_specialization(entry, dtype, how.variant)


def revised(a, b, c, binv, basis, xb, phase, feas, cap: int, *, rule: str = LPC,
            seed: int = 0, tol: float = 1e-5, _variant: Optional[str] = None):
    """Run the revised simplex on every LP of the batch, up to ``cap`` steps.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`revised_plain`.  ``_variant`` forces the variant (private, for
    the tests and ``chip_smoke.py``): ``"resident"`` or ``"global"``; a
    resident launch that cannot fit raises.
    """
    m, n = a.shape
    how = cluster.plan_revised(m, n, a.dtype, _variant)
    if not a.is_cuda:
        from . import build

        build.note_specialization("revised", a.dtype, "plain")
        return revised_plain(a, b, c, binv, basis, xb, phase, feas, cap, rule=rule, seed=seed,
                             tol=tol)
    _check(a, b, c, feas, (binv, basis, xb, phase))
    if rule not in _RULE_CODES:
        raise ValueError(f"unknown pivot rule {rule!r}")
    from . import build  # the library is built at first launch, never at import

    lib = build.load("revised")
    fn = _symbol(lib, "revised", a.dtype, 12, 5,
                 [ctypes.c_uint, ctypes.c_uint, ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
    bsz = b.shape[0]
    dev = a.device
    obj = torch.empty((bsz,), dtype=a.dtype, device=dev)
    x = torch.empty((bsz, n), dtype=a.dtype, device=dev)
    status = torch.empty((bsz,), dtype=torch.int32, device=dev)
    iters = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz == 0:
        return obj, x, status, iters
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), binv.data_ptr(), basis.data_ptr(),
            xb.data_ptr(), phase.data_ptr(), feas.data_ptr(), obj.data_ptr(), x.data_ptr(),
            status.data_ptr(), iters.data_ptr(), bsz, m, n, int(cap), _RULE_CODES[rule],
            int(seed) & 0xFFFFFFFF, 0, float(tol), int(how.variant == cluster.RESIDENT), stream,
        )
    if err != 0:
        _raise(lib, err, how, "kernel")
    _count(how, "revised", a.dtype)
    return obj, x, status, iters


def revised_sweep(a, b, c_stack, feas, cap: int, *, rule: str = LPC, seed: int = 0,
                  tol: float = 1e-5, warm: bool = True, _variant: Optional[str] = None):
    """Solve a (T, B, n) stack of cost rows over one ``(a, b)``: ``(objective,
    x, status, iterations)``, each with a leading (T, B).

    CUDA tensors launch the sweep kernel once on the current stream; CPU
    tensors run :func:`revised_sweep_plain`.  ``_variant`` as for
    :func:`revised`.
    """
    m, n = a.shape
    how = cluster.plan_revised(m, n, a.dtype, _variant)
    if not a.is_cuda:
        from . import build

        build.note_specialization("revised_sweep", a.dtype, "plain")
        return revised_sweep_plain(a, b, c_stack, feas, cap, rule=rule, seed=seed, tol=tol,
                                   warm=warm)
    _check(a, b, c_stack, feas, steps=c_stack.shape[0])
    if rule not in _RULE_CODES:
        raise ValueError(f"unknown pivot rule {rule!r}")
    from . import build  # the library is built at first launch, never at import

    lib = build.load("revised")
    fn = _symbol(lib, "revised_sweep", a.dtype, 9, 6,
                 [ctypes.c_uint, ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    steps, bsz = c_stack.shape[:2]
    dev = a.device
    obj = torch.empty((steps, bsz), dtype=a.dtype, device=dev)
    x = torch.empty((steps, bsz, n), dtype=a.dtype, device=dev)
    status = torch.empty((steps, bsz), dtype=torch.int32, device=dev)
    iters = torch.empty((steps, bsz), dtype=torch.int32, device=dev)
    if steps == 0 or bsz == 0:
        return obj, x, status, iters
    resident = how.variant == cluster.RESIDENT
    scratch = torch.empty((0 if resident else bsz, m, m), dtype=a.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), c_stack.data_ptr(), scratch.data_ptr(),
            feas.data_ptr(), obj.data_ptr(), x.data_ptr(), status.data_ptr(), iters.data_ptr(),
            bsz, steps, m, n, int(cap), _RULE_CODES[rule], int(seed) & 0xFFFFFFFF, float(tol),
            int(bool(warm)), int(resident), stream,
        )
    if err != 0:
        _raise(lib, err, how, "sweep")
    _count(how, "revised_sweep", a.dtype)
    return obj, x, status, iters
