"""Weights shared with the reference, and the logit summary both sides compare.

New in the port (no reference file).  Neither package can replay the
other's random init (the reference seeds each leaf with Python's
per-process string hash and draws with ``jax.random``), so parity runs
take their weights from NumPy:

* ``reference_weights(cfg, seed)``: NumPy arrays in the reference's tree
  layout (``embed``, one stacked tree a group ``g0``, ``g1``, ...,
  ``final_norm``; zamba2's unstacked ``shared_attn`` tree; the
  encoder-decoder's ``enc_norm``), drawn
  from ``np.random.default_rng(seed)`` leaf by leaf in sorted-path order
  with the reference's std rule (``sharding/rules.py:ParamSpec.std`` on
  the stacked shape);
* ``load_reference_params(model, tree)`` copies such a tree into a
  ``Model`` (layer ``i`` of group ``gj`` into ``layers.(o + i)``, where
  ``o`` counts the layers of the groups before it; an unstacked leaf
  under its own path), casting to each parameter's dtype; a model built
  under a ``DeviceMesh`` takes each rank's slice;
  ``reference_params(model)`` is the way back (``exact=True`` keeps
  each parameter's dtype, bfloat16 included, as CPU tensors); under a
  ``DeviceMesh`` it gathers every leaf whole (``collectives.whole``, so
  every rank calls it), and ``reference_shardings(model)`` gives the
  tree's placements, from which ``ckpt/checkpoint.py:restore`` cuts
  each rank's slices;
* ``reference_leaf_of(model)`` names each parameter's reference leaf
  (the int8 gradient transform shares a scale over it);
* ``reference_opt_state(model, state)`` and
  ``load_reference_opt_state(model, tree)`` move the optimizer state
  (``train/optimizer.py:OptState``: ``step``, ``m``, ``v``, ``master``)
  between the port's name-keyed dicts and the reference's layout (the
  same stacked ``g{i}`` leaves), so that a checkpoint of ``{"params",
  "opt"}`` restores in either package.

``trimmed_rel`` compares the training fixtures' parameter changes.
``logit_summary`` and ``compare_to_summary`` reduce logits to what a
committed fixture stores (a fixed vocabulary subset, the argmax, the
logsumexp, the top-2 margin) and hold new logits against it;
``tools/lm_reference_fixture.py`` writes the fixture from the reference,
and ``chip_smoke.py`` and the tests compare with these functions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..sharding import ParamSpec, leaves, partition
from ..sharding import collectives as coll
from ..sharding.rules import shardings
from .blocks import block_specs, plan, shared_attn_specs
from .config import ModelConfig
from .layers import embed_specs, rmsnorm_spec
from .model import Model


def _stack(specs, count: int):
    """A block's spec tree with every leaf stacked ``count`` deep on a
    leading ``layer`` axis, as the reference's ``_stack_specs``."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((count,) + specs.shape, ("layer",) + specs.axes, specs.dtype,
                         specs.init, specs.scale)
    return {k: _stack(v, count) for k, v in specs.items()}


def _reference_specs(cfg: ModelConfig):
    """The reference's parameter tree (``Model.abstract_params``): one stacked
    tree a group of ``plan``, and the unstacked extras of the hybrid and
    the encoder-decoder."""
    tree = {"embed": embed_specs(cfg), "final_norm": rmsnorm_spec(cfg.d_model, cfg.dtype)}
    for i, group in enumerate(plan(cfg)):
        tree[f"g{i}"] = _stack(block_specs(group.kind, cfg), group.count)
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        tree["shared_attn"] = shared_attn_specs(cfg)
    if cfg.family == "encdec":
        tree["enc_norm"] = rmsnorm_spec(cfg.d_model, cfg.dtype)
    return tree


def _group_offsets(cfg: ModelConfig) -> Dict[str, int]:
    """The model's index of each group's first layer, by the group's key."""
    out, at = {}, 0
    for i, group in enumerate(plan(cfg)):
        out[f"g{i}"] = at
        at += group.count
    return out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def reference_weights(cfg: ModelConfig, seed: int, dtype: str = "float32"):
    """NumPy weights in the reference's tree layout.

    Every ``normal`` leaf is ``rng.standard_normal(shape, float32) * std``;
    ``zeros`` and ``ones`` leaves draw nothing.  ``dtype="float64"``
    widens the same values.  A bfloat16 model is made by casting these
    float32 arrays (round to nearest even, in either package).
    """
    rng = np.random.default_rng(seed)
    tree: Dict = {}
    for path, spec in leaves(_reference_specs(cfg)):
        if spec.init == "zeros":
            arr = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            arr = np.ones(spec.shape, np.float32)
        else:
            arr = rng.standard_normal(spec.shape, dtype=np.float32)
            arr *= np.float32(spec.std())
        if dtype not in ("float32", "float64"):
            raise ValueError(f"dtype {dtype!r}: float32 or float64")
        _set(tree, path, arr.astype(dtype, copy=False))
    return tree


def weights_digest(tree, head: int = 8) -> np.ndarray:
    """The first ``head`` values of every leaf in sorted-path order (float64):
    two trees drawn from different NumPy streams differ here."""
    return np.concatenate([np.asarray(a).reshape(-1)[:head].astype(np.float64)
                           for _, a in leaves(tree)])


def _tensor(arr) -> torch.Tensor:
    """A NumPy array or a tensor as a tensor (NumPy's bits kept)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _copy_from_reference(model: Model, tree, targets: Dict[str, torch.Tensor]) -> None:
    """Copy a reference-layout tree into ``targets`` (parameter name ->
    tensor of the parameter's shape; cast to each target's dtype, moved
    to its device).  A missing, extra or misshapen leaf raises."""
    offsets = _group_offsets(model.cfg)
    seen = set()
    with torch.no_grad():
        for path, arr in leaves(tree):
            arr = _tensor(arr)
            if path[0] in offsets:
                o = offsets[path[0]]
                names = [f"layers.{o + i}.{'.'.join(path[1:])}" for i in range(arr.shape[0])]
                parts = list(arr)
            else:
                names, parts = [".".join(path)], [arr]
            for name, part in zip(names, parts):
                if name not in targets:
                    raise KeyError(f"{'/'.join(path)}: the model has no parameter {name}")
                t = targets[name]
                spec = getattr(t, "spec", None)
                if spec is not None and tuple(part.shape) == tuple(spec.shape):
                    part = part[partition.local_slices(spec.shape, spec.axes)]
                if tuple(t.shape) != tuple(part.shape):
                    raise ValueError(f"{name}: shape {tuple(part.shape)} != {tuple(t.shape)}")
                t.copy_(part)
                seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise KeyError(f"the tree has no weights for {missing}")


def load_reference_params(model: Model, tree) -> Model:
    """Copy a reference-layout tree (NumPy arrays or tensors) into
    ``model`` (cast to each parameter's dtype, moved to its device).  A
    missing, extra or misshapen leaf raises.  Under a ``DeviceMesh`` each
    parameter takes this rank's slice of its leaf
    (``partition.local_slices``)."""
    _copy_from_reference(model, tree, dict(model.named_parameters()))
    return model


def _to_reference(model: Model, named: Dict[str, torch.Tensor], exact: bool):
    """Name-keyed tensors of the parameters' shapes as a reference-layout
    tree: NumPy (bfloat16 widened to float32), or with ``exact`` CPU
    tensors of their own dtype."""
    cfg = model.cfg
    offsets = _group_offsets(cfg)
    counts = {f"g{i}": g.count for i, g in enumerate(plan(cfg))}
    tree: Dict = {}

    def arr(t: torch.Tensor):
        with torch.no_grad():
            t = coll.whole(t).detach().cpu()
        if exact:
            return t
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    stack = torch.stack if exact else np.stack
    for path, _ in leaves(_reference_specs(cfg)):
        if path[0] in offsets:
            sub, o = ".".join(path[1:]), offsets[path[0]]
            parts = [arr(named[f"layers.{o + i}.{sub}"]) for i in range(counts[path[0]])]
            _set(tree, path, stack(parts))
        else:
            _set(tree, path, arr(named[".".join(path)]))
    return tree


def reference_params(model: Model, exact: bool = False):
    """The model's parameters as a reference-layout tree: NumPy arrays
    (bfloat16 parameters come back as float32), or with ``exact`` CPU
    tensors in each parameter's own dtype (a bfloat16 parameter keeps its
    bits).  Whole leaves: under a ``DeviceMesh`` every rank gathers them."""
    return _to_reference(model, dict(model.named_parameters()), exact)


def reference_specs(model: Model):
    """The reference-layout tree of ``ParamSpec``s (whole shapes): what
    ``ckpt/checkpoint.py:restore`` needs of ``like``, with nothing gathered."""
    return _reference_specs(model.cfg)


def reference_shardings(model: Model):
    """The placements of every leaf of the reference-layout tree on the
    active mesh (``partition.placements``; the stacked ``layer`` axis
    whole), for ``ckpt/checkpoint.py:restore(..., shardings=)``."""
    return shardings(_reference_specs(model.cfg))


def reference_leaf_of(model: Model) -> Dict[str, str]:
    """Each parameter's leaf in the reference's tree, by name: the path
    joined with ``/`` (``layers.3.attn.wq`` -> ``g0/attn/wq`` when layer 3
    lies in group ``g0``)."""
    offsets = _group_offsets(model.cfg)
    counts = {f"g{i}": g.count for i, g in enumerate(plan(model.cfg))}
    out = {}
    for path, _ in leaves(_reference_specs(model.cfg)):
        if path[0] in offsets:
            sub, o = ".".join(path[1:]), offsets[path[0]]
            for i in range(counts[path[0]]):
                out[f"layers.{o + i}.{sub}"] = "/".join(path)
        else:
            out[".".join(path)] = "/".join(path)
    return out


def reference_opt_state(model: Model, state):
    """The port's ``OptState`` (name-keyed float32 dicts) in the
    reference's layout: an ``OptState`` whose ``m``, ``v`` and ``master``
    (``None`` if absent) are reference-layout trees of CPU tensors, and
    ``step`` a () int32 CPU tensor."""
    def tree(d):
        return None if d is None else _to_reference(model, d, exact=True)

    return type(state)(state.step.detach().cpu(), tree(state.m), tree(state.v),
                       tree(state.master))


def load_reference_opt_state(model: Model, tree):
    """A reference-layout optimizer state (``step``, ``m``, ``v``,
    ``master``; NumPy arrays or tensors; any object with those fields) as
    the port's ``OptState`` on the model's device, float32 moments and
    master, an int32 ``step``."""
    from ..train.optimizer import OptState

    dev = model.device

    def named(t):
        if t is None:
            return None
        out = {n: coll.with_spec(torch.empty(p.shape, dtype=torch.float32, device=dev), p)
               for n, p in model.named_parameters()}
        _copy_from_reference(model, t, out)
        return out

    step = _tensor(np.asarray(tree.step) if not isinstance(tree.step, torch.Tensor)
                   else tree.step).to(device=dev, dtype=torch.int32).reshape(())
    return OptState(step, named(tree.m), named(tree.v), named(tree.master))


# ---------------------------------------------------------------------------
# Logit summaries
# ---------------------------------------------------------------------------


def vocab_subset(vocab_size: int, n: int, seed: int) -> np.ndarray:
    """``n`` sorted distinct ids of ``[0, vocab_size)`` (all of them if fewer)."""
    if n >= vocab_size:
        return np.arange(vocab_size, dtype=np.int32)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(vocab_size, size=n, replace=False)).astype(np.int32)


def logit_summary(logits: np.ndarray, ids: np.ndarray) -> Dict[str, np.ndarray]:
    """What a fixture stores of logits (..., V): the float32 logits at
    ``ids``, and over the whole vocabulary the argmax (first maximum), the
    logsumexp (float64) and the top-2 margin."""
    x = np.asarray(logits, dtype=np.float64)
    top2 = np.sort(x, axis=-1)[..., -2:]
    mx = x.max(axis=-1, keepdims=True)
    lse = (mx[..., 0] + np.log(np.exp(x - mx).sum(axis=-1)))
    return {
        "logits": x[..., ids].astype(np.float32),
        "argmax": x.argmax(axis=-1).astype(np.int32),
        "logsumexp": lse.astype(np.float32),
        "margin": (top2[..., 1] - top2[..., 0]).astype(np.float32),
    }


def rel_l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``||a - b|| / ||b||`` over the last axis, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def trimmed_rel(a, b, share: float) -> float:
    """Relative L2 of ``a`` against ``b`` without the ``share`` of the
    elements (at least one) that differ most: the training fixtures'
    comparison of parameter changes, where Adam steps an element by about
    ``lr * sign(g)`` and an element whose gradient lies within rounding of
    zero may step either way."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    keep = np.argsort(np.abs(a - b))[:a.size - max(1, int(a.size * share))]
    if not keep.size:
        return 0.0
    nb = np.linalg.norm(b[keep])
    return float(np.linalg.norm(a[keep] - b[keep]) / nb) if nb else float(np.any(a[keep] != 0))


def fixture_view(fixture, router: str) -> Dict[str, np.ndarray]:
    """One router's fixture out of a fixture of several
    (``tools/lm_reference_fixture.py --router topk,lp``): its own arrays,
    stored as ``<router>__<key>``, under their plain keys, beside the
    arrays the routers share."""
    prefix = f"{router}__"
    out = {k: v for k, v in fixture.items() if "__" not in k and k != "routers"}
    own = {k[len(prefix):]: v for k, v in fixture.items() if k.startswith(prefix)}
    if not own:
        raise KeyError(f"the fixture has no run of router {router!r}")
    out.update(own)
    return out


def compare_to_summary(logits, fixture, *, abs_tol, rel_tol, margin: float) -> Dict[str, object]:
    """Hold logits (..., V) against a fixture's summary of the reference's.

    Gates, for every row (prompt, step): the logits at the fixture's ids
    within ``abs_tol`` (max abs) and ``rel_tol`` (relative L2), and the
    logsumexp within ``abs_tol``; each tolerance a number or an array of
    the rows' shape.  The argmax equal wherever the fixture's top-2 margin
    exceeds ``margin``.  Returns the measurements (the worst row's, and
    ``worst_ratio``, the largest error over its row's tolerance) and ``ok``.
    """
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    got = logit_summary(logits, np.asarray(fixture["vocab_ids"]))
    ref = {k: np.asarray(fixture[k]) for k in ("logits", "argmax", "logsumexp", "margin")}
    abs_rows = np.abs(got["logits"].astype(np.float64) - ref["logits"]).max(axis=-1)
    rel_rows = rel_l2(got["logits"], ref["logits"])
    lse_rows = np.abs(got["logsumexp"].astype(np.float64) - ref["logsumexp"])
    ratio = np.maximum.reduce([abs_rows / abs_tol, rel_rows / rel_tol, lse_rows / abs_tol])
    decided = ref["margin"] > margin
    argmax_bad = int(((got["argmax"] != ref["argmax"]) & decided).sum())
    return {
        "max_abs_err": float(abs_rows.max()), "rel_l2": float(rel_rows.max()),
        "logsumexp_err": float(lse_rows.max()), "worst_ratio": float(ratio.max()),
        "argmax_checked": int(decided.sum()), "argmax_mismatch": argmax_bad,
        "ok": bool(ratio.max() <= 1.0) and argmax_bad == 0,
    }
