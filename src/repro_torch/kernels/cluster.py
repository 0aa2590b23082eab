"""Which variant of the simplex and PDHG kernels a launch takes, and at what cluster size.

Each of the two kernels has a cluster variant, where one LP is one
thread-block cluster of ``k`` CTAs that hold the LP's data in their
shared memory for the whole solve (``csrc/cluster.cuh``), and a second
variant for shapes past it: the simplex kernel's global-memory tableau,
the PDHG kernel's streaming of ``A`` from device memory.

:func:`plan_simplex` and :func:`plan_pdhg` are pure functions of the
shape, the element type and the device's largest schedulable ``k``.  The
wrappers call them before every launch; nothing tries a launch and falls
back.  The byte counts mirror the kernels' layouts
(``simplex.cu:cluster_smem``, ``pdhg.cu:cluster_elems``); the kernels
export the same arithmetic (``*_cluster_smem``), and the tests on the
card hold the two against each other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

#: Shared memory one block may hold on Hopper (``sharedMemPerBlockOptin``).
SMEM_LIMIT = 232_448
#: Static shared memory a cluster kernel may declare beside its dynamic buffer.
STATIC_RESERVE = 2_048
#: The largest cluster the hardware schedules (non-portable above 8).
MAX_CLUSTER = 16
#: The eight per-step partials of the PDHG kernel.
PDHG_PARTS = 8

CLUSTER = "cluster"


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's variant: ``"cluster"`` with ``k`` CTAs an LP and ``smem``
    bytes of dynamic shared memory a CTA, or the second variant (``k == 0``)."""

    variant: str
    k: int = 0
    smem: int = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def simplex_smem(m: int, q: int, itemsize: int, k: int) -> int:
    """Dynamic shared memory of one simplex CTA: a band of ``ceil(m/k)`` rows
    of the ``q``-column tableau, the objective row copy, the normalised
    pivot row, the band's pivot column and its basis entries."""
    mb = _ceil(m, k)
    return itemsize * (mb * q + 2 * q + mb + 1) + 4 * mb


def pdhg_smem(m: int, n: int, itemsize: int, k: int) -> int:
    """Dynamic shared memory of one PDHG CTA: ``ceil(m/k)`` rows of ``A``,
    the partial ``A'y`` and the gathered ``x1`` (n each), six row vectors,
    four column vectors and the published and gathered partials."""
    mr, nc = _ceil(m, k), _ceil(n, k)
    return itemsize * (mr * n + 2 * n + 6 * mr + 4 * nc + PDHG_PARTS * (1 + MAX_CLUSTER))


def fits(smem: int) -> bool:
    return smem + STATIC_RESERVE <= SMEM_LIMIT


def _plan(smem_of: Callable[[int], int], max_k: int, k: Optional[int], second: str,
          what: str) -> Plan:
    """The least ``k`` whose CTAs' shared memory holds the LP (``k=None``),
    a forced ``k`` (``0``: the second variant), or ``second`` when the least
    ``k`` is beyond ``max_k``.  A forced ``k`` the device cannot schedule
    raises."""
    if k is not None:
        k = int(k)
        if k == 0:
            return Plan(second)
        if not 1 <= k <= MAX_CLUSTER:
            raise ValueError(f"{what}: cluster size {k} is outside 1..{MAX_CLUSTER}")
        if k > max_k:
            raise ValueError(f"{what}: the device schedules clusters of at most {max_k} CTAs, "
                             f"not {k}")
        if not fits(smem_of(k)):
            raise ValueError(f"{what}: {smem_of(k)} bytes of shared memory a CTA at k={k} "
                             f"exceed {SMEM_LIMIT - STATIC_RESERVE}")
        return Plan(CLUSTER, k, smem_of(k))
    for cand in range(1, min(max_k, MAX_CLUSTER) + 1):
        if fits(smem_of(cand)):
            return Plan(CLUSTER, cand, smem_of(cand))
    return Plan(second)


def plan_simplex(m: int, q: int, dtype: torch.dtype, max_k: int,
                 k: Optional[int] = None) -> Plan:
    """The simplex launch for an (m+1) x q tableau: the cluster variant at the
    least ``k`` whose bands fit, else ``"global"``."""
    item = torch.empty((), dtype=dtype).element_size()
    return _plan(lambda kk: simplex_smem(m, q, item, kk), max_k, k, "global",
                 f"simplex kernel ({m + 1} x {q} {dtype})")


def plan_pdhg(m: int, n: int, dtype: torch.dtype, max_k: int,
              k: Optional[int] = None) -> Plan:
    """The PDHG launch for an m x n ``A``: the cluster variant at the least
    ``k`` whose row slices fit, else ``"streaming"``."""
    item = torch.empty((), dtype=dtype).element_size()
    return _plan(lambda kk: pdhg_smem(m, n, item, kk), max_k, k, "streaming",
                 f"pdhg kernel ({m} x {n} {dtype})")


_MAX_K: Dict[Tuple[str, int, int], int] = {}
_LOCK = threading.Lock()


def active_clusters(lib: ctypes.CDLL, symbol: str, itemsize: int, k: int, smem: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a cluster kernel at ``k`` CTAs and
    ``smem`` bytes (``<symbol>(itemsize, k, smem)``); raises on a CUDA error."""
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    got = fn(itemsize, k, smem)
    if got < 0:
        raise RuntimeError(f"{symbol}: cudaOccupancyMaxActiveClusters failed with CUDA error "
                           f"{-got}")
    return got


def device_max_cluster(lib: ctypes.CDLL, symbol: str, itemsize: int,
                       device: torch.device) -> int:
    """The largest ``k`` (at most :data:`MAX_CLUSTER`) for which the device
    holds one cluster of the kernel at the full shared-memory budget, so at
    any budget the planner gives it.  Cached per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (symbol, itemsize, index)
    with _LOCK:
        if key not in _MAX_K:
            best = 0
            with torch.cuda.device(index):
                for k in range(MAX_CLUSTER, 0, -1):
                    if active_clusters(lib, symbol, itemsize, k,
                                       SMEM_LIMIT - STATIC_RESERVE) >= 1:
                        best = k
                        break
            _MAX_K[key] = best
        return _MAX_K[key]
