"""Train step: chunked cross-entropy, gradient accumulation, remat.

Follows ``repro/train/train_step.py``.  The model holds its parameters
(``Model`` is an ``nn.Module``): the step updates them in place and
returns ``(opt_state, metrics)`` where the reference returns
``(params, opt_state, metrics)``.

Memory discipline for the large configs, as the reference's:

* remat: ``Model.forward(..., remat=True)`` recomputes every layer in
  the backward pass;
* chunked CE: logits (B, S, V) are never materialized; the hidden states
  are projected a sequence chunk of ``CE_CHUNK`` at a time, and each
  chunk is recomputed in the backward pass, so one (B, CE_CHUNK, V)
  float32 logits chunk is alive at a time;
* gradient accumulation: ``accum`` microbatches, float32 accumulators.

**Under a mesh** (``with partition.activate(mesh)``, a ``DeviceMesh``; the
model built there, each rank storing its slices) every rank is given
the whole batch: microbatch ``i`` is rows ``[i*mb, (i+1)*mb)`` of it, as
in the reference, and ``Model.forward`` runs this rank's rows of each
(``partition.batch_rows``).  The chunked cross-entropy sums ``(loss,
count)`` over the rank's rows and all-reduces both over the batch axes,
so every rank holds the global mean.  The collectives' backward is their
adjoint (``sharding/collectives.py``), which gives the gradient of the
sum over ranks of their loss copies: each rank seeds its backward with
``1 / ranks``, and the gradient of a parameter is summed over the mesh
axes it is stored whole on (``collectives.replicated_axes``: the norms,
and every weight the divisibility fallback replicates), one all-reduce a
bucket of parameters that share those axes and a dtype.  The gradient
of a parameter split over the data axes is already summed there: the
backward of its gather at use (``collectives.weight``) is the
reduce-scatter the reference's ``shard_like_params`` asks XLA for.  On
a ``(1, 1)`` mesh nothing of this runs, and the step is the bits of no
mesh.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..models.model import Model
from ..sharding import collectives as coll
from ..sharding import partition
from . import optimizer as opt_mod

CE_CHUNK = 512


def _chunk_ce(model: Model, h: torch.Tensor, l: torch.Tensor):
    """(sum of the chunk's token losses, its count of valid labels), float32."""
    logits = model.logits(h).to(torch.float32)  # (B, C, V)
    logz = torch.logsumexp(logits, dim=-1)
    # The gold logit by gather at max(l, 0): one nonzero and zeros, so the
    # same bits as the reference's masked sum over the vocabulary.
    gold = torch.gather(logits, -1, torch.clamp(l, min=0).long()[..., None])[..., 0]
    valid = (l >= 0).to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def chunked_ce_loss(model: Model, hidden: torch.Tensor, labels: torch.Tensor,
                    chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean next-token CE without materializing full logits."""
    total, count = chunked_ce_sums(model, hidden, labels, chunk)
    return total / torch.clamp(count, min=1.0)


def chunked_ce_sums(model: Model, hidden: torch.Tensor, labels: torch.Tensor,
                    chunk: int = CE_CHUNK):
    """(sum of the token losses, count of valid labels), float32.

    The sequence is padded to whole chunks (labels -1, which count for
    nothing); the chunks' sums are added in order, as the reference's
    scan carries them."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        s += pad
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk):
        h, l = hidden[:, start:start + chunk], labels[:, start:start + chunk]
        if torch.is_grad_enabled():
            loss, n = checkpoint(_chunk_ce, model, h, l, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            loss, n = _chunk_ce(model, h, l)
        total = total + loss
        count = count + n
    return total, count


def make_loss_fn(model: Model, remat: bool = True):
    """``loss_fn(batch) -> loss``: the forward and the chunked CE; under a
    mesh, of the whole batch, on every rank (the module's docstring)."""
    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        b = batch["tokens"].shape[0]
        hidden = model.forward(inputs, remat=remat)
        labels = batch["labels"][partition.batch_rows(b)]
        axes = partition.split_axes(b, "batch")  # none without a split: the sums as they are
        total, count = chunked_ce_sums(model, hidden, labels)
        total, count = coll.all_reduce(total, axes), coll.all_reduce(count, axes)
        return total / torch.clamp(count, min=1.0)

    return loss_fn


def _ranks() -> int:
    """The ranks that each hold a copy of the loss: the mesh's, when each
    rank holds its own slices; else 1."""
    if not partition.distributed():
        return 1
    return math.prod(partition.mesh_shape(partition.active_mesh()).values())


def sum_replicated(grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]):
    """``grads`` with each parameter's gradient summed over the mesh axes the
    parameter is stored whole on (``collectives.replicated_axes``), one
    all-reduce a bucket of parameters with the same axes and dtype (an
    elementwise sum: the bits of one all-reduce a parameter)."""
    buckets: Dict[tuple, list] = {}
    for k, p in params.items():
        axes = coll.replicated_axes(p)
        if axes:
            buckets.setdefault((axes, grads[k].dtype), []).append(k)
    out = dict(grads)
    for (axes, _), names in buckets.items():
        flat = coll.all_reduce(torch.cat([grads[k].reshape(-1) for k in names]), axes)
        for k, part in zip(names, flat.split([grads[k].numel() for k in names])):
            out[k] = part.view(grads[k].shape)
    return out


def make_train_step(
    model: Model,
    opt_cfg: opt_mod.OptConfig,
    accum: int = 1,
    remat: bool = True,
    compression=None,  # optional grad transform: (grads, opt_state) -> (grads, opt_state)
):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``,
    which updates ``model``'s parameters in place (under a mesh, this
    rank's slices; the module's docstring).

    Microbatch i is rows ``[i*mb, (i+1)*mb)`` of the batch (``mb = B /
    accum``).  With ``accum > 1`` the gradients accumulate in float32 and
    are divided by ``accum``, and the loss is the mean of the
    microbatches'; with ``accum = 1`` they keep the parameters' dtype until
    ``optimizer.update``.  Then the optional ``compression``, then the
    update.  ``metrics``: ``loss``, ``grad_norm``, ``lr`` (float32 tensors).
    """
    loss_fn = make_loss_fn(model, remat)
    params = dict(model.named_parameters())
    names, leaves = list(params), list(params.values())

    def grad_fn(batch):
        ranks = _ranks()
        with torch.enable_grad():
            loss = loss_fn(batch)
            seed = None if ranks == 1 else torch.full_like(loss, 1.0 / ranks)
            grads = torch.autograd.grad(loss, leaves, grad_outputs=seed, materialize_grads=True)
        return loss.detach(), dict(zip(names, grads))

    def train_step(opt_state, batch):
        if accum > 1:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} microbatches")
            mb = b // accum
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}
            lsum = None
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = grad_fn(micro)
                for k in names:
                    gsum[k].add_(g[k])  # widened exactly, no float32 copy
                del g
                lsum = l if lsum is None else lsum + l
            grads = {k: gsum[k].div_(accum) for k in names}
            loss = lsum / accum
        else:
            loss, grads = grad_fn(batch)
        grads = sum_replicated(grads, params)

        if compression is not None:
            grads, opt_state = compression(grads, opt_state)

        opt_state, metrics = opt_mod.update(grads, opt_state, params, opt_cfg)
        return opt_state, {**metrics, "loss": loss}

    return train_step


def make_eval_step(model: Model):
    """Returns ``eval_step(batch) -> loss``: the forward and the chunked CE
    without gradients or remat."""
    loss_fn = make_loss_fn(model, remat=False)

    @torch.no_grad()
    def eval_step(batch):
        return loss_fn(batch)

    return eval_step
