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

The kernel has two variants (``csrc/pdhg.cu``): the cluster variant,
where a cluster of ``k`` CTAs holds the LP's ``A`` in shared memory, and
the streaming variant for an ``A`` past the largest cluster.
:func:`plan` picks one from the shape before the launch
(``kernels/cluster.py:plan_pdhg``).  Both agree with the plain version
in status and step count per LP and in the iterates to rounding; they
are not bit-identical to it (the plain matvecs are library products with
their own reduction order), nor to each other, nor across ``k``.  There
is no fallback: a CUDA tensor goes to the kernel, every shape runs
there, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import pdhg as _pdhg
from . import cluster

#: Kernel launches so far; raised by one per launch of the CUDA kernel only.
launches = 0
#: The same launches by variant.
variant_launches = {"cluster": 0, "streaming": 0}

_SYMBOLS = {torch.float32: "pdhg_f32", torch.float64: "pdhg_f64"}
_CLUSTER_SYMBOLS = {torch.float32: "pdhg_cluster_f32", torch.float64: "pdhg_cluster_f64"}


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


def device_max_k(dtype: torch.dtype, device: torch.device) -> int:
    """The largest cluster of the PDHG kernel the device schedules (the
    hardware's :data:`~repro_torch.kernels.cluster.MAX_CLUSTER` off the card)."""
    if device.type != "cuda":
        return cluster.MAX_CLUSTER
    from . import build  # the library is built at first use, never at import

    return cluster.device_max_cluster(build.load("pdhg"), "pdhg_cluster_occupancy",
                                      torch.empty((), dtype=dtype).element_size(), device)


def plan(m: int, n: int, dtype: torch.dtype, device: torch.device, k=None) -> cluster.Plan:
    """The variant and cluster size of a launch on this shape and device."""
    return cluster.plan_pdhg(m, n, dtype, device_max_k(dtype, device), k)


def pdhg(a, b, c, state: _pdhg.PDHGResumeState, tau, sigma, scales, cap: int, *, tol: float,
         restart: int, _k=None):
    """Run restarted PDHG on every LP of the batch, up to ``cap`` steps.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`pdhg_plain`.  ``_k`` forces the variant (private, for the tests
    and ``chip_smoke.py``): a cluster of ``_k`` CTAs, or ``0`` for the
    streaming variant; a cluster the device cannot schedule raises.
    """
    global launches
    if _k is not None and a.dim() == 3:
        plan(a.shape[1], a.shape[2], a.dtype, a.device, _k)
    from . import build  # the library is built at first launch, never at import

    if not a.is_cuda:
        build.note_specialization("pdhg", a.dtype, "plain")
        return pdhg_plain(a, b, c, state, tau, sigma, scales, cap, tol=tol, restart=restart)
    _check(a, b, c, state, tau, sigma, scales)

    lib = build.load("pdhg")
    bsz, m, n = a.shape
    how = plan(m, n, a.dtype, a.device, _k)
    on_cluster = how.variant == cluster.CLUSTER
    fn = getattr(lib, (_CLUSTER_SYMBOLS if on_cluster else _SYMBOLS)[a.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (19 if on_cluster else 20) + [ctypes.c_int] * 5
                   + [ctypes.c_double, ctypes.c_double] + [ctypes.c_int] * on_cluster
                   + [ctypes.c_void_p])
    dev = a.device
    status = torch.empty((bsz,), dtype=torch.int32, device=dev)
    iters = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz == 0:
        return status, iters
    # The streaming variant keeps aty, then x1, of each LP in device memory.
    scratch = [] if on_cluster else [torch.empty((bsz, n), dtype=a.dtype, device=dev)]
    ptrs = [t.data_ptr() for t in (
        a, b, c, state.x, state.y, state.ax, state.x_sum, state.y_sum, state.ax_sum,
        state.inner, state.x_grow, state.y_grow, tau, sigma, *scales, *scratch, status, iters)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, bsz, m, n, int(cap), int(restart), float(tol),
                 _pdhg.GROWTH_FRACTION * restart, *([how.k] if on_cluster else []), stream)
    if err != 0:
        raise build.launch_error(lib, "pdhg", err, f"pdhg kernel ({how.variant}, k={how.k})")
    with build.LAUNCH_LOCK:
        launches += 1
        variant_launches[how.variant] += 1
    build.note_specialization("pdhg", a.dtype, how.variant)
    return status, iters
