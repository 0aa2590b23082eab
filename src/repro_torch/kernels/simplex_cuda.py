"""The CUDA simplex kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/simplex_pallas.py`` (the Pallas TPU kernel).
:func:`simplex` launches ``csrc/simplex.cu`` on CUDA tensors and runs
:func:`simplex_plain`, the lockstep loop of ``core/simplex.py``, on CPU
tensors.  Both take the same arguments and write the terminal state the
same way:

* ``tab`` (B, m+1, q), ``basis`` (B, m) int32 and ``phase`` (B,) int32
  are updated in place to the terminal state (so a resume is the same
  call on the same buffers);
* the return value is ``(objective, x, status, iterations)``.

The kernel has two variants (``csrc/simplex.cu``): the cluster variant,
where a cluster of ``k`` CTAs holds the LP's tableau in shared memory,
and the global variant for tableaus past the largest cluster.
:func:`plan` picks one from the shape before the launch
(``kernels/cluster.py:plan_simplex``).  On the card both are
bit-identical to the plain version (see ``core/engine.py`` for the rules
that make them so).  There is no fallback: a CUDA tensor goes to the
kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import simplex as _simplex
from ..core.engine import BLAND, LPC, RPC
from ..core.tableau import TableauSpec
from . import cluster

#: Kernel launches so far; raised by one per launch of the CUDA kernel only.
launches = 0
#: The same launches by variant.
variant_launches = {"cluster": 0, "global": 0}

_RULE_CODES = {LPC: 0, RPC: 1, BLAND: 2}
_SYMBOLS = {torch.float32: "simplex_f32", torch.float64: "simplex_f64"}
_CLUSTER_SYMBOLS = {torch.float32: "simplex_cluster_f32", torch.float64: "simplex_cluster_f64"}


def _outputs(tab: torch.Tensor, n: int):
    bsz, dev = tab.shape[0], tab.device
    return (
        torch.empty((bsz,), dtype=tab.dtype, device=dev),
        torch.empty((bsz, n), dtype=tab.dtype, device=dev),
        torch.empty((bsz,), dtype=torch.int32, device=dev),
        torch.empty((bsz,), dtype=torch.int32, device=dev),
    )


def _check(tab, basis, phase, c_ext, feas, spec: TableauSpec):
    bsz = tab.shape[0]
    want = {
        "tab": (tab, (bsz, spec.m + 1, spec.q), tab.dtype),
        "basis": (basis, (bsz, spec.m), torch.int32),
        "phase": (phase, (bsz,), torch.int32),
        "c_ext": (c_ext, (bsz, spec.q), tab.dtype),
        "feas": (feas, (bsz,), tab.dtype),
    }
    if tab.dtype not in _SYMBOLS:
        raise TypeError(f"simplex kernel takes float32 or float64, got {tab.dtype}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"simplex kernel: {name} is {tuple(t.shape)} {t.dtype}, "
                f"expected {shape} {dtype}"
            )
        if t.device != tab.device:
            raise ValueError(f"simplex kernel: {name} is on {t.device}, tab on {tab.device}")
        if not t.is_contiguous():
            raise ValueError(f"simplex kernel: {name} is not contiguous")


def simplex_plain(tab, basis, phase, c_ext, feas, cap: int, *, spec: TableauSpec,
                  rule: str = LPC, seed: int = 0, tol: float = 1e-5):
    """The kernel's function in plain PyTorch (the lockstep loop)."""
    _check(tab, basis, phase, c_ext, feas, spec)
    sol, state = _simplex._iterate(
        tab, basis, phase, c_ext, feas, cap, seed, spec=spec, rule=rule, tol=tol
    )
    tab.copy_(state.tab)
    basis.copy_(state.basis)
    phase.copy_(state.phase)
    return sol.objective, sol.x, sol.status, sol.iterations


def device_max_k(dtype: torch.dtype, device: torch.device) -> int:
    """The largest cluster of the simplex kernel the device schedules (the
    hardware's :data:`~repro_torch.kernels.cluster.MAX_CLUSTER` off the card)."""
    if device.type != "cuda":
        return cluster.MAX_CLUSTER
    from . import build  # the library is built at first use, never at import

    return cluster.device_max_cluster(build.load("simplex"), "simplex_cluster_occupancy",
                                      torch.empty((), dtype=dtype).element_size(), device)


def plan(spec: TableauSpec, dtype: torch.dtype, device: torch.device,
         k=None) -> cluster.Plan:
    """The variant and cluster size of a launch on this shape and device."""
    return cluster.plan_simplex(spec.m, spec.q, dtype, device_max_k(dtype, device), k)


def simplex(tab, basis, phase, c_ext, feas, cap: int, *, spec: TableauSpec,
            rule: str = LPC, seed: int = 0, tol: float = 1e-5, _k=None):
    """Run the two-phase simplex on every LP of the batch, up to ``cap`` steps.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`simplex_plain`.  ``_k`` forces the variant (private, for the
    tests and ``chip_smoke.py``): a cluster of ``_k`` CTAs, or ``0`` for
    the global variant; a cluster the device cannot schedule raises.
    """
    global launches
    from . import build  # the library is built at first launch, never at import

    if _k is not None:
        plan(spec, tab.dtype, tab.device, _k)
    if not tab.is_cuda:
        build.note_specialization("simplex", tab.dtype, "plain")
        return simplex_plain(tab, basis, phase, c_ext, feas, cap, spec=spec,
                             rule=rule, seed=seed, tol=tol)
    _check(tab, basis, phase, c_ext, feas, spec)
    if rule not in _RULE_CODES:
        raise ValueError(f"unknown pivot rule {rule!r}")
    lib = build.load("simplex")
    how = plan(spec, tab.dtype, tab.device, _k)
    on_cluster = how.variant == cluster.CLUSTER
    fn = getattr(lib, (_CLUSTER_SYMBOLS if on_cluster else _SYMBOLS)[tab.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 7
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_double]
        + [ctypes.c_int] * on_cluster
        + [ctypes.c_void_p]
    )
    obj, x, status, iters = _outputs(tab, spec.n)
    if tab.shape[0] == 0:
        return obj, x, status, iters
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = fn(
            tab.data_ptr(), basis.data_ptr(), phase.data_ptr(), c_ext.data_ptr(),
            feas.data_ptr(), obj.data_ptr(), x.data_ptr(), status.data_ptr(),
            iters.data_ptr(), tab.shape[0], spec.m, spec.n, spec.q, spec.art_start,
            int(cap), _RULE_CODES[rule], int(seed) & 0xFFFFFFFF, 0, float(tol),
            *([how.k] if on_cluster else []), stream,
        )
    if err != 0:
        raise build.launch_error(lib, "simplex", err,
                                 f"simplex kernel ({how.variant}, k={how.k})")
    with build.LAUNCH_LOCK:
        launches += 1
        variant_launches[how.variant] += 1
    build.note_specialization("simplex", tab.dtype, how.variant)
    return obj, x, status, iters
