"""Process groups and device meshes over ``torch.distributed``.

Follows ``repro/launch/mesh.py``.  The port runs as SPMD processes, one
a rank, started by ``torchrun`` (or ``torch.multiprocessing``):

    python -m torch.distributed.run --nproc-per-node N script.py

and in the script::

    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_distributed()                  # NCCL, one rank a card
    mesh = mesh_lib.make_local_mesh()            # ("data", "model") = (N, 1)
    sol = repro_torch.solve(batch, mesh=mesh)    # every rank: the whole answer

:func:`init_distributed` reads torchrun's environment and pins each rank
to ``cuda:(local_rank % device_count)``.  NCCL takes one rank a card and
refuses more ranks than cards (it raises here, naming the counts); gloo
is the caller's choice for ranks that share a card, or for the CPU.
The default group is made with ``timeout_s`` (and every subgroup with
torch's default timeout), so a rank that stops answering fails the
collective instead of blocking it for good.

The reference's TPU v5e constants (peak bf16 FLOP/s, HBM and ICI bytes
a second) are not carried over: the H100's figures live in
``runtime/roofline.py``.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: Default collective timeout of :func:`init_distributed` (seconds).
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(backend: Optional[str] = None, *, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S, store=None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> int:
    """Initialize the default process group; returns this process's rank.

    ``backend`` defaults to ``"nccl"`` on the card and ``"gloo"`` when
    ``device="cpu"``.  Without ``store``, rank and world size come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); with a ``torch.distributed.Store`` (a ``FileStore``
    in the tests) they are given.  On the card the rank is pinned to
    ``cuda:(LOCAL_RANK % device_count)``.  Raises ``ValueError`` when
    ``"nccl"`` is asked for more ranks on this host than it has cards:
    NCCL cannot put two ranks on one card, and nothing switches to gloo
    behind the caller's back.
    """
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
    if not on_cpu:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' for the CPU")
        if backend == "nccl" and local_world > count:
            raise ValueError(
                f"init_distributed: NCCL takes one rank a card, and {local_world} ranks on "
                f"this host have {count} card(s); ask for backend='gloo' to share a card")
        torch.cuda.set_device(local_rank % count)
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    dist.init_process_group(**kw)
    return rank


def _device_type(device) -> str:
    """The mesh's device type: the card unless the caller asks for another."""
    return "cuda" if device is None else torch.device(device).type


def make_local_mesh(model: int = 1, device=None) -> DeviceMesh:
    """A ``(world // model, model)`` mesh named ``("data", "model")``.

    Over the initialized process group; the device type is ``"cuda"``
    unless the caller passes ``device="cpu"``.
    """
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"make_local_mesh: {world} ranks do not split into model = {model}")
    return DeviceMesh(_device_type(device), torch.arange(world).reshape(world // model, model),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """The reference's production mesh: ``(16, 16)`` ``("data", "model")``,
    or ``(2, 16, 16)`` ``("pod", "data", "model")`` with ``multi_pod``.

    Raises ``ValueError`` naming the world size when the process group
    does not hold exactly that many ranks.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"make_production_mesh: the {shape} mesh needs {need} ranks; "
                         f"the world has {world}")
    return DeviceMesh(_device_type(device), torch.arange(need).reshape(shape),
                      mesh_dim_names=names)
