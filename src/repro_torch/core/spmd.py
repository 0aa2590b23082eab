"""The mesh half of the dispatch: LP batches split across ranks.

Follows the mesh half of ``repro/core/dispatch.py`` (``_resolve_axes``,
``_batch_sharding``/``_stage``, and ``dispatch_round``'s pad and chunk
plan under a mesh).  The reference has one controller that sees a global
batch and lets XLA shard it; the port runs one process a rank, under this
rule:

  * **inputs**: every rank is given the same full batch;
  * **work**: a rank solves only its own block of rows, on its own
    device.  The block is its index in the group of the mesh's batch
    axes (:class:`BatchSplit`);
  * **outputs**: every rank returns the same full ``LPSolution``,
    gathered over that group; ranks that differ only along other axes
    (``model``) compute the same rows and gather their own copies.

A round with no carried state pads the batch with edge replicas to a
multiple of the batch axes' product, as the reference does, and gives
each block an equal share; the padding is trimmed off the solution, the
state and the counters.  A carried state stays with the rank that owns
its rows (:class:`ShardedState`): only the solution and the survivors'
indices cross ranks, and the next round's survivors are solved by their
owners.  A row's bits do not depend on which rank solves it or beside
which rows (``core/lp.py:row_sum``, ``row_tiles``), so the split cannot
change a result.

Every sharded round ends in one all-reduce (:meth:`BatchSplit.agree`)
before its one gather.  A rank that raised contributes its failure
there, and every rank raises the same exception class, so
``dispatch_round_safe`` retries a transient failure on all ranks together
and a ``KernelError`` leaves all of them.

Collectives run on the group's backend: NCCL on device tensors; gloo,
which has no ``all_gather`` of CUDA tensors, through the host.  Every row
crosses as raw bytes, so no bit changes on the way (a float sum would
turn -0.0 into +0.0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.build import KernelBuildError, KernelError, KernelLaunchError
from ..runtime.chaos import ChaosError, ShardCrash
from .lp import LPSolution, concat_states

#: The exception classes a failed round is agreed on, least to most
#: binding: a rank that did not fail raises the class of the highest code
#: any rank reported, so the non-transient classes (from ``KeyError`` on)
#: win over the transient ones, and every rank makes the same retry
#: decision.  Any other exception counts as ``RuntimeError`` (transient).
FAILURE_CLASSES = (RuntimeError, ChaosError, ShardCrash, KeyError, TypeError, ValueError,
                   NotImplementedError, KernelError, KernelBuildError, KernelLaunchError)

# (id(mesh), key) -> (mesh, group): groups made here, kept with their mesh.
_GROUPS: Dict[Tuple[int, tuple], tuple] = {}


def _failure_code(exc: BaseException) -> int:
    code = 1
    for i, cls in enumerate(FAILURE_CLASSES):
        if isinstance(exc, cls):
            code = i + 1
    return code


def _cached_group(mesh, key, make):
    hit = _GROUPS.get((id(mesh), key))
    if hit is None:
        hit = _GROUPS[(id(mesh), key)] = (mesh, make())
    return hit[1]


def mesh_device(mesh) -> torch.device:
    """The device this rank solves on: its card (``cuda:current``) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _subgroups(mesh, axes: Sequence[str]):
    """This rank's group over ``axes``: the ranks that share every other coordinate."""
    names = list(mesh.mesh_dim_names)
    if len(axes) == 1 and len(names) > 0:
        return mesh.get_group(axes[0])
    rest = [names.index(a) for a in names if a not in axes]
    grid = mesh.mesh.permute(*rest, *[names.index(a) for a in axes])
    rows = grid.reshape(-1, math.prod(grid.shape[len(rest):])).tolist()
    if len(rows) == 1 and len(rows[0]) == dist.get_world_size():
        return dist.group.WORLD
    cur, _ = dist.new_subgroups_by_enumeration(rows)
    return cur


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """How a mesh splits a batch: its batch axes, their group, this rank's block.

    ``div`` is the product of the batch axes' sizes, ``block`` this rank's
    index in ``group`` (the ranks that differ only along the batch axes),
    ``everyone`` the group of the whole mesh, over which failures are
    agreed, and ``device`` where this rank solves.
    """

    axes: Tuple[str, ...]
    div: int
    block: int
    group: object
    everyone: object
    device: torch.device
    via_host: bool

    def even_owner(self, bsz: int) -> Tuple[np.ndarray, int]:
        """``(owner, per)``: equal blocks of ``per`` rows after padding to ``div``."""
        per = max(1, -(-bsz // self.div))
        return np.arange(bsz) // per, per

    def agree(self, exc: Optional[BaseException], header: Sequence[int] = ()) -> List[int]:
        """One all-reduce (MAX) over the mesh: the round's outcome and a small header.

        ``header`` is a few non-negative integers (the layout of the rows
        about to be gathered, a specialisation count); the maximum over
        the ranks comes back.  If any rank passed an exception, every rank
        raises: its own exception where it is of the agreed class, else a
        new one of that class naming the rank that failed.
        """
        world = dist.get_world_size(self.everyone)
        me = dist.get_rank(self.everyone)
        code = 0 if exc is None else _failure_code(exc) * world + me
        dev = torch.device("cpu") if self.via_host else self.device
        vec = torch.tensor([code, *header], dtype=torch.int64, device=dev)
        dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=self.everyone)
        out = vec.tolist()
        agreed = out[0]
        if agreed:
            cls = FAILURE_CLASSES[agreed // world - 1]
            if exc is not None and _failure_code(exc) == agreed // world:
                raise exc
            raise cls(f"a dispatch round failed on rank {agreed % world} of the mesh "
                      f"({cls.__name__}); every rank stops with it")
        return out[1:]

    def gather(self, parts: Sequence[Optional[torch.Tensor]], counts: Sequence[int],
               specs: Sequence[Tuple[torch.dtype, Tuple[int, ...]]]) -> List[torch.Tensor]:
        """All-gather row blocks over the batch group, bit for bit.

        ``parts`` are this rank's rows of each field (None where it holds
        no row), ``counts`` the rows of every block, ``specs`` each field's
        dtype and trailing shape.  Returns each field with the blocks'
        rows concatenated in block order, on this rank's device.
        """
        widths = [math.prod(shape) * torch.empty((), dtype=dt).element_size()
                  for dt, shape in specs]
        top = max(counts)
        dev = torch.device("cpu") if self.via_host else self.device
        buf = torch.zeros((top, sum(widths)), dtype=torch.uint8, device=dev)
        mine = counts[self.block]
        off = 0
        for t, w in zip(parts, widths):
            if mine and t is not None:
                raw = t.contiguous().reshape(mine, -1).view(torch.uint8) if t.dtype != torch.bool \
                    else t.reshape(mine, -1).to(torch.uint8)
                buf[:mine, off:off + w] = raw.to(dev)
            off += w
        bufs = [torch.empty_like(buf) for _ in range(self.div)]
        dist.all_gather(bufs, buf, group=self.group)
        rows = torch.cat([b[:c] for b, c in zip(bufs, counts)]).to(self.device)
        out, off = [], 0
        for (dt, shape), w in zip(specs, widths):
            # A fresh buffer: a one-row slice counts as contiguous with the
            # parent's stride, which a dtype view refuses.
            col = torch.empty((rows.shape[0], w), dtype=torch.uint8, device=rows.device)
            col.copy_(rows[:, off:off + w])
            out.append((col != 0).reshape(-1, *shape) if dt == torch.bool
                       else col.view(dt).reshape(-1, *shape))
            off += w
        return out


def resolve_split(mesh, batch_axes: Sequence[str]) -> Optional[BatchSplit]:
    """The split of ``mesh`` over the named batch axes it has (None: no split).

    Axes the mesh lacks are ignored, as the reference's ``_resolve_axes``
    does; a mesh with none of them solves unsplit, on every rank.
    """
    if mesh is None:
        return None
    axes = tuple(ax for ax in batch_axes if ax in mesh.mesh_dim_names)
    if not axes:
        return None
    group = _cached_group(mesh, ("batch",) + axes, lambda: _subgroups(mesh, axes))
    everyone = _cached_group(mesh, ("all",), lambda: _subgroups(mesh, mesh.mesh_dim_names))
    dev = mesh_device(mesh)
    return BatchSplit(
        axes=axes, div=math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes),
        block=dist.get_rank(group), group=group, everyone=everyone, device=dev,
        via_host=dev.type == "cuda" and dist.get_backend(group) != "nccl")


def broadcast_choice(mesh, value):
    """``value`` as the mesh's first rank holds it, on every rank of the mesh.

    The one decision of the LP path that depends on timing, the
    autotuner's ``"trial"`` winner, goes through here, so every rank runs
    one backend.
    """
    everyone = _cached_group(mesh, ("all",), lambda: _subgroups(mesh, mesh.mesh_dim_names))
    box = [value]
    dist.broadcast_object_list(box, src=min(dist.get_process_group_ranks(everyone)),
                               group=everyone)
    return box[0]


def total(split: BatchSplit, count: int) -> int:
    """The sum of a per-rank count over the batch group (each block once)."""
    t = torch.tensor([count], dtype=torch.int64,
                     device=torch.device("cpu") if split.via_host else split.device)
    dist.all_reduce(t, group=split.group)
    return int(t.item())


def to_device(record, device: torch.device):
    """A batch or state record with every tensor field on ``device``."""
    moved = {f.name: getattr(record, f.name).to(device) for f in dataclasses.fields(record)
             if isinstance(getattr(record, f.name), torch.Tensor)}
    return dataclasses.replace(record, **moved)


def row_index(idx, bsz: int) -> np.ndarray:
    """Global row numbers of ``idx`` (a slice, an index tensor or array)."""
    if isinstance(idx, slice):
        return np.arange(bsz)[idx]
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    return np.asarray(idx, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """A carried resume state split across ranks: each rank holds its own rows.

    ``owner`` gives every row of the round's batch its block; ``local`` is
    the backend's state record of this rank's rows in ascending row
    order (None where it owns none); ``healthy`` the (B,) all-finite mask
    of every row, gathered with the solution of the round that made the
    state (the guardrails read it), else None.  ``take``, ``concat`` and
    ``scatter`` address rows by their global numbers, on every rank
    alike, and touch only the local rows.
    """

    local: object
    owner: np.ndarray
    block: int
    healthy: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return int(self.owner.shape[0])

    def _mine(self, rows: np.ndarray) -> np.ndarray:
        """Positions in ``local`` of the rows of ``rows`` this rank owns, in order."""
        held = np.nonzero(self.owner == self.block)[0]
        return np.searchsorted(held, rows[self.owner[rows] == self.block])

    def take(self, idx) -> "ShardedState":
        rows = row_index(idx, self.batch)
        pos = self._mine(rows)
        local = None
        if pos.size:
            local = self.local.take(torch.as_tensor(pos, device=_device_of(self.local)))
        healthy = None if self.healthy is None else self.healthy[
            torch.as_tensor(rows, device=self.healthy.device)]
        return ShardedState(local, self.owner[rows], self.block, healthy)

    @staticmethod
    def concat(parts: Sequence["ShardedState"]) -> "ShardedState":
        locals_ = [p.local for p in parts if p.local is not None]
        return ShardedState(concat_states(locals_) if locals_ else None,
                            np.concatenate([p.owner for p in parts]), parts[0].block)

    def scatter(self, idx, part: "ShardedState") -> "ShardedState":
        """This state with rows ``idx`` replaced by ``part``'s (row-aligned with ``idx``)."""
        pos = self._mine(row_index(idx, self.batch))
        if not pos.size:
            return self
        at = torch.as_tensor(pos, device=_device_of(self.local))

        def put(dst, src):
            out = dst.clone()
            out[at] = src
            return out

        local = dataclasses.replace(self.local, **{
            f.name: put(getattr(self.local, f.name), getattr(part.local, f.name))
            for f in dataclasses.fields(self.local)})
        return ShardedState(local, self.owner, self.block)


def _device_of(record) -> torch.device:
    for f in dataclasses.fields(record):
        t = getattr(record, f.name)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def assign_owners(split: BatchSplit, joining: Optional[ShardedState], k: int) -> np.ndarray:
    """Blocks for ``k`` new rows beside ``joining``'s: each to the least loaded.

    Deterministic from the row counts alone, so every rank assigns alike.
    """
    counts = np.zeros(split.div, np.int64)
    if joining is not None:
        counts += np.bincount(joining.owner, minlength=split.div)
    out = np.empty(k, np.int64)
    for i in range(k):
        b = int(np.argmin(counts))
        out[i] = b
        counts[b] += 1
    return out


_SOLUTION_FIELDS = ("objective", "x", "status", "iterations", "basis", "y")
_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64, torch.bool)


def _specs(sol: Optional[LPSolution], extra: Optional[torch.Tensor]) -> List[int]:
    """This rank's layout header: per optional field (basis, y, health) its
    presence, trailing width and dtype code (zeros where it holds no row)."""
    out = []
    for t in ((None, None, extra) if sol is None else (sol.basis, sol.y, extra)):
        if t is None:
            out += [0, 0, 0]
        else:
            out += [1, int(t.shape[1]) if t.dim() > 1 else 0, _DTYPES.index(t.dtype)]
    return out


def gather_solution(split: BatchSplit, local: Optional[LPSolution], counts: Sequence[int],
                    n: int, dtype: torch.dtype, exc: Optional[BaseException] = None,
                    health: Optional[torch.Tensor] = None, header: Sequence[int] = ()):
    """Agree on the round's outcome, then gather every block's solution rows.

    Returns ``(solution, health, header)``: the rows in block order (the
    caller puts them in row order), the gathered health mask (None if no
    rank had one) and the agreed maximum of ``header``.  Raises on every
    rank if any rank passed ``exc``.
    """
    layout = split.agree(exc, [*_specs(local, health), *header])
    specs = [(dtype, ()), (dtype, (n,)), (torch.int32, ()), (torch.int32, ())]
    parts = [None] * 4 if local is None else [local.objective, local.x, local.status,
                                              local.iterations]
    own = (None, None) if local is None else (local.basis, local.y)
    present = []
    for i, (name, t) in enumerate(zip(("basis", "y", "health"), (*own, health))):
        has, width, code = layout[3 * i:3 * i + 3]
        if has:
            specs.append((_DTYPES[code], (width,) if width else ()))
            parts.append(t)
            present.append(name)
    got = dict(zip(["objective", "x", "status", "iterations", *present],
                   split.gather(parts, counts, specs)))
    health = got.pop("health", None)
    return LPSolution(**{"basis": None, "y": None, **got}), health, layout[9:]


def solution_rows(sol: LPSolution, rows) -> LPSolution:
    """Rows ``rows`` (a slice or an index tensor) of every field of a solution."""
    return LPSolution(**{f: (None if getattr(sol, f) is None else getattr(sol, f)[rows])
                         for f in _SOLUTION_FIELDS})


def in_row_order(sol: LPSolution, order: Optional[np.ndarray],
                 health: Optional[torch.Tensor] = None):
    """Rows gathered in block order (``order`` their row numbers) put in row order."""
    if order is None:
        return sol, health
    inv = torch.as_tensor(np.argsort(order), device=sol.status.device)
    return solution_rows(sol, inv), (None if health is None else health[inv])


def map_rows(split: BatchSplit, fn, batch, sol: LPSolution) -> LPSolution:
    """``fn(batch_rows, sol_rows)`` of a row-local post-pass, each rank on its block.

    The certificate confirmation, the crossover polish and the quarantine
    read and write rows alone, so each rank runs them on its equal block
    of the merged solution, on the mesh's device (the batch may stay on
    the host), and the blocks are gathered: no rank solves a row that is
    not its own.
    """
    bsz = sol.status.shape[0]
    owner, per = split.even_owner(bsz)
    mine = slice(min(split.block * per, bsz), min((split.block + 1) * per, bsz))
    counts = np.bincount(owner, minlength=split.div).tolist()
    local, exc = None, None
    try:
        if counts[split.block]:
            local = fn(to_device(batch.take(mine), split.device), solution_rows(sol, mine))
    except Exception as err:  # agreed below: every rank raises
        exc = err
    out, _, _ = gather_solution(split, local, counts, sol.x.shape[1], sol.x.dtype, exc)
    return out
