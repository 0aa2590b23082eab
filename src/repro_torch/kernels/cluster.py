"""Which variant of the simplex, PDHG and revised kernels a launch takes.

The simplex and PDHG kernels each have a cluster variant, where one LP is
one thread-block cluster of ``k`` CTAs that hold the LP's data in their
shared memory for the whole solve (``csrc/cluster.cuh``), and a second
variant for shapes past it: the simplex kernel's global-memory tableau,
the PDHG kernel's streaming of ``A`` from device memory.  The revised
kernel has a resident variant, one CTA an LP holding ``binv`` and the
per-step vectors in shared memory, and the global variant past it.

:func:`plan_simplex`, :func:`plan_pdhg` and :func:`plan_revised` are pure
functions of the shape, the element type and (for the clusters) the
device's largest schedulable ``k``.  The wrappers call them before every
launch; nothing tries a launch and falls back.  The byte counts mirror
the kernels' layouts (``simplex.cu:cluster_smem``,
``pdhg.cu:cluster_elems``, ``revised.cu:resident_smem``); the kernels
export the same arithmetic (``*_cluster_smem``,
``revised_resident_smem``), and the tests on the card hold the two
against each other.
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
#: Shared memory one SM holds, and the part the runtime keeps for each CTA.
SM_SMEM = 233_472
CTA_RESERVE = 1_024
#: Threads of a revised CTA.
THREADS = 256

CLUSTER = "cluster"
RESIDENT = "resident"


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's variant: ``"cluster"`` with ``k`` CTAs an LP (or
    ``"resident"``, one CTA) and ``smem`` bytes of dynamic shared memory a
    CTA, or the second variant (``k == 0``)."""

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


def binv_ld(m: int, itemsize: int) -> int:
    """The row stride of the resident revised kernel's ``binv``: an odd
    number of 16-byte vectors, at least ``m`` elements."""
    vw = 16 // itemsize
    ld = _ceil(m, vw) * vw
    return ld if (ld // vw) % 2 else ld + vw


def _revised_base(m: int, n: int, itemsize: int, rows: int) -> int:
    vw = 16 // itemsize

    def vec(k: int) -> int:
        return _ceil(k, vw) * vw

    span = vec(rows * n) + vw if rows else 0
    return (itemsize * (m * binv_ld(m, itemsize) + 7 * vec(m) + vec(n) + vec(1 + n + m)
                        + 2 * span) + 4 * m)


def revised_stage_rows(m: int, n: int, itemsize: int) -> int:
    """Rows of ``A`` each of the resident revised CTA's two staging buffers
    holds: 0 where two CTAs share an SM (``A`` stays in L1 beside them) or
    where the pricing has more columns than threads; else as many as the
    CTA's budget leaves, a multiple of the 16-byte vector, at most the padded
    ``m``."""
    vw = 16 // itemsize
    base = _revised_base(m, n, itemsize, 0)
    if n > THREADS or 2 * (base + STATIC_RESERVE + CTA_RESERVE) <= SM_SMEM:
        return 0
    room = (SMEM_LIMIT - STATIC_RESERVE - base) // itemsize // 2 - 2 * vw
    rows = min(room // n // vw * vw, _ceil(m, vw) * vw)
    return rows if rows >= vw else 0


def revised_smem(m: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one resident revised CTA: ``binv`` in ``m``
    rows of stride :func:`binv_ld`, then each a whole number of 16-byte
    vectors: seven vectors of ``m`` (sgn, c_B, w, the entering column, u,
    the normalised pivot row, x_B), the LP's costs (``n``), the objective
    row (``1 + n + m``) and two buffers of :func:`revised_stage_rows` rows of
    ``A`` (with room to align each); then the basis (``m`` ints)."""
    return _revised_base(m, n, itemsize, revised_stage_rows(m, n, itemsize))


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


def plan_revised(m: int, n: int, dtype: torch.dtype, variant: Optional[str] = None) -> Plan:
    """The revised launch for an m x n shared ``A``: the resident variant
    (one CTA an LP, ``k = 1``) wherever its shared memory fits, else
    ``"global"``.  A forced ``variant`` that cannot run raises."""
    smem = revised_smem(m, n, torch.empty((), dtype=dtype).element_size())
    if variant not in (None, RESIDENT, "global"):
        raise ValueError(f"revised kernel: unknown variant {variant!r}")
    if variant == "global" or (variant is None and not fits(smem)):
        return Plan("global")
    if not fits(smem):
        raise ValueError(f"revised kernel ({m} x {n} {dtype}): {smem} bytes of shared memory "
                         f"a CTA exceed {SMEM_LIMIT - STATIC_RESERVE}")
    return Plan(RESIDENT, 1, smem)


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
