"""Batched LP containers, status codes and the random generators.

Follows ``repro/core/lp.py``.  An LP batch is a struct-of-arrays over B
independent LPs of identical shape:

    maximize    c . x
    subject to  A x <= b,   x >= 0

with ``A: (B, m, n)``, ``b: (B, m)``, ``c: (B, n)`` as torch tensors;
:class:`SharedLPBatch` stores one ``A: (m, n)`` for the whole batch.
The tableau column map and its layouts live in ``core/tableau.py``.

The generators build their arrays in numpy from the caller's
``np.random.Generator`` exactly as the reference does, so the same
generator state gives the same problems in both packages; only the last
step (``torch.as_tensor(..., device=)``) differs.

Entry points put their tensors on the card unless the caller asks for
the CPU: ``device=None`` means ``"cuda"``, and raises when there is no
card (:func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .tableau import TableauSpec, build_tableau  # noqa: F401  (re-exported API)

# Status codes shared by every solver in the library.
RUNNING = 0
OPTIMAL = 1
UNBOUNDED = 2
INFEASIBLE = 3
ITER_LIMIT = 4
# A row whose solution or carried state went non-finite (numerical
# guardrails of a later slice); no certificate can be trusted for it.
NUMERICAL = 5

STATUS_NAMES = {
    RUNNING: "running",
    OPTIMAL: "optimal",
    UNBOUNDED: "unbounded",
    INFEASIBLE: "infeasible",
    ITER_LIMIT: "iter_limit",
    NUMERICAL: "numerical",
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on.

    ``None`` means the card (``"cuda"``).  Without a card that raises:
    the port never picks the CPU on its own; pass ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def _writable(x) -> np.ndarray:
    """``x`` as a numpy array torch may wrap (read-only arrays are copied)."""
    arr = np.asarray(x)
    return arr if arr.flags.writeable else arr.copy()


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; numpy and tensors alike."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(_writable(x), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class LPBatch:
    """A batch of B identical-shape LPs: max c.x s.t. Ax <= b, x >= 0.

    ``basis0`` optionally carries a warm-start basis per LP: tableau
    column indices (1..n originals, n+1..n+m slacks).  Rows whose basis
    is out of range, singular or infeasible fall back to the cold
    two-phase start (see ``build_tableau``).
    """

    a: torch.Tensor  # (B, m, n)
    b: torch.Tensor  # (B, m)
    c: torch.Tensor  # (B, n)
    basis0: Optional[torch.Tensor] = None  # (B, m) int32 warm-start basis

    @classmethod
    def from_numpy(cls, a, b, c, basis0=None, device=None) -> "LPBatch":
        """Build a batch from array-likes on ``device`` (None = the card)."""
        dev = resolve_device(device)
        return cls(
            _tensor(a, device=dev),
            _tensor(b, device=dev),
            _tensor(c, device=dev),
            None if basis0 is None else _tensor(basis0, torch.int32, dev),
        )

    @property
    def batch(self) -> int:
        return self.a.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[1]

    @property
    def n(self) -> int:
        return self.a.shape[2]

    def take(self, idx) -> "LPBatch":
        """Rows ``idx`` (a slice or an index tensor) of the batch."""
        return LPBatch(
            self.a[idx],
            self.b[idx],
            self.c[idx],
            None if self.basis0 is None else self.basis0[idx],
        )


@dataclasses.dataclass(frozen=True)
class SharedLPBatch:
    """B LPs over ONE constraint matrix: max c_k.x s.t. A x <= b_k, x >= 0.

    The shared-structure counterpart of :class:`LPBatch` for support
    sweeps, reachability and scenario analysis, where the LPs differ only
    in ``c`` and/or ``b``.  ``A`` is stored once, and the revised-simplex
    engine (``core/revised.py``) keeps O(m^2) basis state per LP.
    ``basis0`` is an optional warm-start basis with the column convention
    of :class:`LPBatch`.
    """

    a: torch.Tensor  # (m, n): ONE constraint matrix for the whole batch
    b: torch.Tensor  # (B, m)
    c: torch.Tensor  # (B, n)
    basis0: Optional[torch.Tensor] = None  # (B, m) int32 warm-start basis

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[0]

    @property
    def n(self) -> int:
        return self.a.shape[1]

    def astype(self, dtype) -> "SharedLPBatch":
        return SharedLPBatch(self.a.to(dtype), self.b.to(dtype), self.c.to(dtype), self.basis0)

    def take(self, idx) -> "SharedLPBatch":
        """Rows ``idx`` of the per-LP arrays; the shared ``A`` is not copied."""
        return SharedLPBatch(
            self.a, self.b[idx], self.c[idx],
            None if self.basis0 is None else self.basis0[idx],
        )

    def densify(self) -> LPBatch:
        """The per-LP-``A`` view for shared-blind backends.

        ``a`` is an ``expand`` of the shared matrix (row stride 0): a
        caller that writes to it must ``.contiguous()`` it first.
        """
        return LPBatch(self.a.expand(self.batch, self.m, self.n), self.b, self.c, self.basis0)


@dataclasses.dataclass(frozen=True)
class ResumeState:
    """Mid-solve simplex state: the exact tableau, basis and phase.

    Continuing from a carried state replays the arithmetic an
    uninterrupted solve would have done, so a chain of capped rounds
    whose caps sum to K ends bit-identical to one solve at cap K.  The
    layout is recovered from ``tab.shape[-1]``
    (``TableauSpec.from_tableau``).
    """

    tab: torch.Tensor  # (B, m+1, q)
    basis: torch.Tensor  # (B, m) int32
    phase: torch.Tensor  # (B,) int32 (1 or 2)

    @property
    def batch(self) -> int:
        return self.tab.shape[0]

    def take(self, idx) -> "ResumeState":
        """Gather state rows (a slice or an index tensor): the compaction gather."""
        return ResumeState(self.tab[idx], self.basis[idx], self.phase[idx])


def concat_states(parts):
    """Row-wise concatenation of resume states of one flavor (the chunks of a round).

    Works for every state record of the library (:class:`ResumeState`,
    the revised and PDHG records): each is a frozen dataclass of
    batch-leading tensors, as the reference's pytree concatenation
    assumes.  A record with a ``concat`` of its own (a state split over a
    mesh, ``core/spmd.py:ShardedState``) concatenates itself.
    """
    first = parts[0]
    if len(parts) == 1:
        return first
    if hasattr(first, "concat"):
        return type(first).concat(parts)
    return type(first)(*(torch.cat([getattr(p, f.name) for p in parts])
                         for f in dataclasses.fields(first)))


@dataclasses.dataclass(frozen=True)
class LPSolution:
    """Result batch: objective, primal point, status, iterations used.

    ``basis`` is the final simplex basis (same column convention as
    ``LPBatch.basis0``) when the backend tracks one, else None.  ``y`` is
    the dual point of the first-order ``pdhg`` backend (None for the
    simplex backends).
    """

    objective: torch.Tensor  # (B,)
    x: torch.Tensor  # (B, n)
    status: torch.Tensor  # (B,) int32
    iterations: torch.Tensor  # (B,) int32
    basis: Optional[torch.Tensor] = None  # (B, m) int32
    y: Optional[torch.Tensor] = None  # (B, m) dual point (pdhg only)


def row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed pairwise tree: ``(..., n) -> (...)``.

    The axis is zero-padded to a power of two and halved until one entry
    is left, each level one element-wise add.  The order is fixed by
    ``n`` alone, so each row's bits are a function of that row, whatever
    the batch around it.  ``Tensor.sum`` does not promise that: on the
    card its reduction spreads a row over more threads when there are
    few rows (below 16 rows of 100 or 500 entries a row's bits differed
    from the same row's in a batch of 2048, on an H100), which a serve
    loop that retires rows a few at a time would see.
    """
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def row_tiles(rows: torch.Tensor, tile: int):
    """``rows`` as index tiles of exactly ``tile`` entries: yields ``(idx, real)``.

    Consecutive slices of ``rows``, the last padded with replicas of its
    first entry; ``real`` counts the entries that are not padding.  A
    library batched routine (``einsum``) or a launch whose plan depends
    on the batch, called on ``x[idx]`` tile by tile, sees one batch size
    whatever the number of rows, so each row's bits are a function of
    that row and ``tile`` alone.  This and :func:`row_sum` are the port's
    two ways to make a row's bits independent of its batch: sum a row's
    entries by :func:`row_sum`; call a batched routine on tiles.
    """
    for lo in range(0, rows.numel(), tile):
        idx = rows[lo:lo + tile]
        real = idx.numel()
        if real < tile:
            idx = torch.cat([idx, idx[:1].expand(tile - real)])
        yield idx, real


def auto_cap(m: int, n: int) -> int:
    """The library-wide auto iteration cap for ``max_iters <= 0``."""
    return 50 * (m + n)


def random_lp_batch(
    rng: np.random.Generator,
    batch: int,
    m: int,
    n: int,
    feasible_start: bool = True,
    dtype=np.float32,
    device=None,
) -> LPBatch:
    """Random bounded LPs in the style of the paper's benchmarks.

    feasible_start=True  -> all b >= 0 (origin feasible; single-phase).
    feasible_start=False -> a box ``lo <= x <= hi`` with ``0 < lo`` written
                            as ``x <= hi`` and ``-x <= -lo`` (b < 0, so
                            artificials are needed), plus loose cover
                            rows: the paper's "infeasible initial basic
                            solution" class.  Needs ``m >= 2n``.
    """
    dev = resolve_device(device)
    if feasible_start:
        a = rng.uniform(-1.0, 1.0, size=(batch, m, n))
        for j in range(min(m, n)):
            a[:, j, j] = np.abs(a[:, j, j]) + 1.0
        b = rng.uniform(1.0, 10.0, size=(batch, m))
        c = rng.uniform(0.1, 1.0, size=(batch, n))
    else:
        lo = rng.uniform(0.5, 1.0, size=(batch, n))
        hi = lo + rng.uniform(0.5, 2.0, size=(batch, n))
        extra = m - 2 * n
        if extra < 0:
            raise ValueError(
                f"need m >= 2n for infeasible-start generator, got m={m} n={n}"
            )
        a = np.zeros((batch, m, n))
        b = np.zeros((batch, m))
        eye = np.eye(n)
        a[:, :n, :] = eye[None]
        b[:, :n] = hi
        a[:, n : 2 * n, :] = -eye[None]
        b[:, n : 2 * n] = -lo
        if extra > 0:
            w = np.abs(rng.uniform(0.1, 1.0, size=(batch, extra, n)))
            a[:, 2 * n :, :] = w
            b[:, 2 * n :] = np.einsum("bkn,bn->bk", w, hi) + rng.uniform(
                0.1, 1.0, size=(batch, extra)
            )
        c = rng.uniform(0.1, 1.0, size=(batch, n))
    return LPBatch(
        _tensor(np.asarray(a, dtype), device=dev),
        _tensor(np.asarray(b, dtype), device=dev),
        _tensor(np.asarray(c, dtype), device=dev),
    )


def random_shared_lp_batch(
    rng: np.random.Generator,
    batch: int,
    m: int,
    n: int,
    feasible_start: bool = True,
    dtype=np.float32,
    device=None,
) -> SharedLPBatch:
    """Random LPs over ONE shared ``A``: the scenario-analysis workload.

    The two classes of :func:`random_lp_batch`, with the constraint matrix
    drawn once and only ``b``/``c`` per LP.  The infeasible start shares
    the structure ``[I; -I; W]`` and draws the box bounds per LP.
    """
    dev = resolve_device(device)
    if feasible_start:
        a = rng.uniform(-1.0, 1.0, size=(m, n))
        for j in range(min(m, n)):
            a[j, j] = np.abs(a[j, j]) + 1.0
        b = rng.uniform(1.0, 10.0, size=(batch, m))
        c = rng.uniform(0.1, 1.0, size=(batch, n))
    else:
        lo = rng.uniform(0.5, 1.0, size=(batch, n))
        hi = lo + rng.uniform(0.5, 2.0, size=(batch, n))
        extra = m - 2 * n
        if extra < 0:
            raise ValueError(f"need m >= 2n for infeasible-start generator, got m={m} n={n}")
        a = np.zeros((m, n))
        b = np.zeros((batch, m))
        eye = np.eye(n)
        a[:n, :] = eye
        b[:, :n] = hi
        a[n : 2 * n, :] = -eye
        b[:, n : 2 * n] = -lo
        if extra > 0:
            w = np.abs(rng.uniform(0.1, 1.0, size=(extra, n)))
            a[2 * n :, :] = w
            b[:, 2 * n :] = hi @ w.T + rng.uniform(0.1, 1.0, size=(batch, extra))
        c = rng.uniform(0.1, 1.0, size=(batch, n))
    return SharedLPBatch(
        _tensor(np.asarray(a, dtype), device=dev),
        _tensor(np.asarray(b, dtype), device=dev),
        _tensor(np.asarray(c, dtype), device=dev),
    )


def random_hyperbox_batch(
    rng: np.random.Generator, batch: int, n: int, dtype=np.float32, device=None
):
    """Random per-LP boxes and directions: ``(lo, hi, directions)``, (B, n)."""
    dev = resolve_device(device)
    lo = rng.uniform(-2.0, 0.0, size=(batch, n))
    hi = lo + rng.uniform(0.5, 3.0, size=(batch, n))
    directions = rng.normal(size=(batch, n))
    return tuple(_tensor(np.asarray(v, dtype), device=dev) for v in (lo, hi, directions))
