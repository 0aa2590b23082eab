"""AdamW with float32 master weights.

Follows ``repro/train/optimizer.py``.  The state is a dict of float32
tensors a field, keyed by the model's ``named_parameters`` names (the
reference's mirror the parameter pytree); ``master`` is ``None`` when
``master_weights=False``.  ``update`` works in place under
``torch.no_grad()``: it writes the new ``m``, ``v``, master and
parameters into the tensors it is given, and returns the state with the
step advanced and the metrics.

The arithmetic follows the reference's order, in float32 whatever the
parameters' dtype: the clip scale from the global norm; ``m``, then
``v``; ``mh / (sqrt(vh) + eps) + wd * base``; ``base - lr * delta``; a
cast to the parameter's dtype.  ``torch.optim.AdamW`` is not the same
function: it divides ``sqrt(v)`` by ``sqrt(bc2)`` before adding ``eps``,
and applies the decay as a separate multiply before the step, so it
rounds differently (``tests/test_torch_optimizer.py`` shows it).

Under a mesh each rank holds its slices of the parameters (``Model``
built under ``partition.activate``), and the update, elementwise, runs
on them: ``m``, ``v`` and ``master`` are made at the parameters' local
shapes and carry their ``ParamSpec`` as ``.spec`` (a checkpoint gathers
them by it).  :func:`global_norm` is the norm of the whole tree: each
leaf's sum of squares over its slice, summed over the mesh axes the
leaf is stored split on, a leaf stored whole counted once; so the clip
scale is the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from ..sharding import collectives as coll


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    master_weights: bool = True


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]]  # float32 copy of the parameters, or None


def init(params: Dict[str, torch.Tensor], cfg: OptConfig) -> OptState:
    """Zeroed moments and (with ``master_weights``) a float32 copy of
    ``params`` (a name -> tensor dict), on the parameters' devices, each
    with its parameter's ``.spec``."""
    def zeros(p):
        return coll.with_spec(torch.zeros(p.shape, dtype=torch.float32, device=p.device), p)

    params = dict(params)
    master = ({k: coll.with_spec(p.detach().to(torch.float32, copy=True), p)
               for k, p in params.items()} if cfg.master_weights else None)
    dev = next(iter(params.values())).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    {k: zeros(p) for k, p in params.items()},
                    {k: zeros(p) for k, p in params.items()}, master)


#: Elements a slice of ``update``'s elementwise pass (256 MB of float32).
SLICE = 1 << 26


def _slices(n: int):
    return [slice(i, min(i + SLICE, n)) for i in range(0, n, SLICE)]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``: the int32 step's true division gives
    float32 in both packages, and so does the product with ``lr``."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, in the
    dict's order (float32).  Under a mesh the leaves' sums are summed over
    the axes each leaf's parameter in ``params`` is stored split on
    (``collectives.stored_split`` of its ``.spec``): one partial sum a
    set of axes, in the dict's order, all-reduced, then added in their
    order (without a mesh, one partial sum: the plain order)."""
    parts: Dict[tuple, torch.Tensor] = {}
    for k, g in tree.items():
        axes = coll.stored_split(params[k])
        s = torch.sum(g.to(torch.float32) ** 2)
        parts[axes] = s if axes not in parts else parts[axes] + s
    total = None
    for axes, s in parts.items():
        s = coll.all_reduce(s, axes) if axes else s
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: OptState, params: Dict[str, torch.Tensor],
           cfg: OptConfig):
    """One AdamW step in place: ``params`` (name -> parameter), and the
    state's ``m``, ``v`` and ``master`` tensors, take their new values.
    Returns ``(new_state, metrics)``; ``metrics`` holds ``grad_norm`` and
    ``lr`` as float32 tensors."""
    step = state.step + 1
    lr = _schedule(cfg, state.step)

    gnorm = global_norm(grads, params)
    clip = _f32(cfg.grad_clip).to(gnorm.device)
    scale = torch.where(gnorm > clip, clip / torch.clamp(gnorm, min=1e-12),
                        torch.ones_like(gnorm))

    stepf = step.to(torch.float32)
    bc1 = 1.0 - _f32(cfg.b1).to(stepf.device) ** stepf
    bc2 = 1.0 - _f32(cfg.b2).to(stepf.device) ** stepf
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    one_b1, one_b2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    eps, wd = _f32(cfg.eps), _f32(cfg.weight_decay)

    for name, g in grads.items():
        p, m, v = params[name], state.m[name], state.v[name]
        master = state.master[name] if state.master is not None else None
        # Elementwise in slices of the flattened leaf: the same bits as one
        # pass, with at most a slice's worth of float32 temporaries.
        for sl in _slices(p.numel()):
            gs = g.reshape(-1)[sl].to(torch.float32) * scale
            ms, vs, ps = m.view(-1)[sl], v.view(-1)[sl], p.view(-1)[sl]
            ms.copy_(b1 * ms + one_b1 * gs)
            vs.copy_(b2 * vs + one_b2 * (gs * gs))
            mh = ms / bc1
            vh = vs / bc2
            base = master.view(-1)[sl] if master is not None else ps.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + eps) + wd * base
            new_master = base - lr * delta
            if master is not None:
                base.copy_(new_master)
            ps.copy_(new_master.to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return state._replace(step=step), metrics
