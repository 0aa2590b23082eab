"""Checkpointing: npz payload + JSON manifest, async, restorable anywhere.

Follows ``repro/ckpt/checkpoint.py`` and writes its on-disk format, so a
checkpoint of either package restores in the other:

    <dir>/step_00000120/manifest.json   step, leaf count, shapes, dtypes
    <dir>/step_00000120/arrays.npz      flat leaf arrays a0, a1, ...
    <dir>/LATEST                        pointer to the newest step

Leaves are flattened in the reference's ``jax.tree_util`` order: dict
keys sorted (so ``g10`` comes before ``g2``), tuples, lists and
NamedTuples (``OptState``) in field order, and ``None`` gives no leaf.
A leaf is a tensor (moved to the host) or a NumPy array.  npz cannot
store bfloat16 or the float8 types: they are saved as bit-equal
``uint16`` / ``uint8`` views under the reference's dtype names
(``_BITCAST``), without ``ml_dtypes``.

Writes go to a temp directory and are renamed into place (atomic on
POSIX); ``LATEST`` is updated last, so a job killed mid-write never
corrupts the restore path, and ``latest_step`` falls back to a scan for
the newest complete step when the pointer is missing or stale.
``AsyncCheckpointer`` writes on a daemon thread and keeps ``keep``
checkpoints.

**Under a mesh** a checkpoint still holds whole leaves and nothing else,
so either package and any mesh reads it.  ``save`` is then a collective
of every rank: a tensor leaf carrying a ``ParamSpec`` as ``.spec`` (a
parameter, an optimizer or error state) is gathered whole
(``collectives.whole``), rank 0 writes the step, every rank passes a
barrier, and rank 0 moves ``LATEST``.  ``restore(..., shardings=)`` is
the reference's elastic re-placement: ``shardings`` is a tree matching
``like`` of each leaf's placements on the active mesh
(``Model.param_shardings`` for name-keyed parameters,
``models/convert.py:reference_shardings`` for the reference's layout;
None leaves whole), and each rank gets its slice of every leaf
(``partition.placement_slices``), whatever mesh wrote it.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..sharding import collectives as coll
from ..sharding import partition

# npz cannot store these: persist as bit-equal unsigned views.
# dtype name -> (the view npz stores, the torch dtype of the same bits)
_BITCAST = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
# An integer dtype of each width that both NumPy and torch have (torch's
# ``from_numpy`` takes no uint16), by the width in bytes.
_INT = {2: (np.int16, torch.int16), 1: (np.uint8, torch.uint8)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _flatten(child)]
    return [tree]


def _flatten_like(tree, like) -> List[Any]:
    """The leaves of ``tree`` at the positions of ``like``'s leaves (a
    placements tuple, or None, is one leaf; a None of ``tree`` where
    ``like`` has a subtree stands for each of its leaves)."""
    if like is None:
        return []
    if tree is None or not isinstance(like, (dict, tuple, list)):
        return [tree] * len(_flatten(like))
    if isinstance(like, dict):
        return [leaf for k in sorted(like) for leaf in _flatten_like(tree[k], like[k])]
    return [leaf for t, l in zip(tree, like) for leaf in _flatten_like(t, l)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(c, leaves) for c in like])
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _to_storable(leaf):
    """(a NumPy array npz can hold, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if name in _BITCAST:
            return t.view(_INT[t.element_size()][1]).numpy().view(_BITCAST[name][0]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _BITCAST:
        return torch.from_numpy(arr.view(_INT[arr.itemsize][0])).view(_BITCAST[dtype_name][1])
    return torch.from_numpy(arr)


def _host(tree):
    """``tree`` with every tensor leaf copied to the host now (so that the
    trainer may overwrite its own tensors while a write is pending)."""
    leaves = [l.detach().to("cpu", copy=True) if isinstance(l, torch.Tensor) else np.array(l)
              for l in _flatten(tree)]
    return _unflatten(tree, iter(leaves))


def meshed() -> bool:
    """Whether this process is one rank of a ``DeviceMesh`` (whose ranks
    save together)."""
    return partition.distributed() and not partition.planning()


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous checkpoint write. Returns the step directory.

    Under a ``DeviceMesh`` every rank calls it (the module's docstring)."""
    if not meshed():
        final = _write_step(directory, step, _flatten(tree))
        _point_latest(directory, step)
        return final
    with torch.no_grad():
        leaves = [coll.whole(l).detach() if isinstance(l, torch.Tensor) else l
                  for l in _flatten(tree)]
    if dist.get_rank() == 0:
        _write_step(directory, step, leaves)
    dist.barrier()
    if dist.get_rank() == 0:
        _point_latest(directory, step)
    dist.barrier()
    return os.path.join(directory, f"step_{step:08d}")


def _write_step(directory: str, step: int, leaves) -> str:
    """Write ``leaves`` as the step's directory (through a temp dir); returns it."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    meta = []
    for i, leaf in enumerate(leaves):
        stored, dtype_name = _to_storable(leaf)
        arrays[f"a{i}"] = stored
        meta.append({"shape": list(stored.shape), "dtype": dtype_name})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    # The restoring job supplies the tree's structure (``like``); the
    # manifest carries the leaves' metadata only.
    manifest = {"step": step, "num_leaves": len(leaves), "leaves": meta}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # re-save of the same step (e.g. resume tail)
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _point_latest(directory: str, step: int) -> None:
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.rename(latest_tmp, os.path.join(directory, "LATEST"))


def _complete_steps(directory: str):
    """Step numbers of every COMPLETE checkpoint dir (torn writes skipped):
    a lingering ``step_*.tmp`` dir, or a renamed dir missing its payload,
    is ignored."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    steps = []
    for d in names:
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        full = os.path.join(directory, d)
        if not (os.path.isfile(os.path.join(full, "manifest.json"))
                and os.path.isfile(os.path.join(full, "arrays.npz"))):
            continue
        try:
            steps.append(int(d.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest restorable step: the ``LATEST`` pointer if it names a
    directory, else the newest complete ``step_*`` directory."""
    path = os.path.join(directory, "LATEST")
    if os.path.exists(path):
        with open(path) as f:
            name = f.read().strip()
        if os.path.isdir(os.path.join(directory, name)):
            return int(name.split("_")[1])
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, like: Any, step: Optional[int] = None, device=None,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, arrays or
    anything with a ``shape``): tensors of the stored dtypes on ``device``
    (the host if None).  A leaf count or shape that differs from the
    stored whole leaf raises.  ``shardings``: a tree matching ``like`` of
    placements on the active mesh (None leaves whole); each leaf comes
    back as this rank's slice of it (the module's docstring)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = _flatten(like)
    places = _flatten_like(shardings, like) if shardings is not None else [None] * len(leaves_like)
    if len(leaves_like) != len(manifest["leaves"]):
        raise ValueError(f"tree structure mismatch: {len(leaves_like)} leaves, "
                         f"the checkpoint has {len(manifest['leaves'])}")
    out = []
    with np.load(os.path.join(final, "arrays.npz")) as data:
        for i, ref in enumerate(leaves_like):
            t = _from_storable(data[f"a{i}"], manifest["leaves"][i]["dtype"])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
            if places[i] is not None:
                t = t[partition.placement_slices(t.shape, places[i])].clone()
            out.append(t.to(device) if device is not None else t)
    return _unflatten(like, iter(out))


def prune(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` step directories."""
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[: -keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Daemon-thread writer; keeps at most ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree = item
            try:
                save(self.directory, step, tree)
                self._gc()
            except Exception as e:  # surfaced on the next submit, wait or close
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        prune(self.directory, self.keep)

    def submit(self, step: int, tree: Any):
        if self._err:
            raise self._err
        self._q.put((step, _host(tree)))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        """Stop the writer thread; a second call does nothing."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=60)
        if self._err:
            raise self._err
