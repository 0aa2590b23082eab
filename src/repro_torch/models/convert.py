"""Weights shared with the reference, and the logit summary both sides compare.

New in the port (no reference file).  Neither package can replay the
other's random init (the reference seeds each leaf with Python's
per-process string hash and draws with ``jax.random``), so parity runs
take their weights from NumPy:

* ``reference_weights(cfg, seed)``: NumPy arrays in the reference's tree
  layout (``embed``, one stacked tree a group ``g0``, ``g1``, ...,
  ``final_norm``), drawn
  from ``np.random.default_rng(seed)`` leaf by leaf in sorted-path order
  with the reference's std rule (``sharding/rules.py:ParamSpec.std`` on
  the stacked shape);
* ``load_reference_params(model, tree)`` copies such a tree into a
  ``Model`` (layer ``i`` of group ``gj`` into ``layers.(o + i)``, where
  ``o`` counts the layers of the groups before it), casting to each
  parameter's dtype; ``reference_params(model)`` is the way back.

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

from ..sharding import ParamSpec, leaves
from .blocks import block_specs, plan
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
    """The reference's parameter tree: one stacked tree a group of ``plan``."""
    tree = {"embed": embed_specs(cfg), "final_norm": rmsnorm_spec(cfg.d_model, cfg.dtype)}
    for i, group in enumerate(plan(cfg)):
        tree[f"g{i}"] = _stack(block_specs(group.kind, cfg), group.count)
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


def load_reference_params(model: Model, tree) -> Model:
    """Copy a reference-layout tree into ``model`` (cast to each parameter's
    dtype, moved to its device).  A missing, extra or misshapen leaf raises."""
    params = dict(model.named_parameters())
    offsets = _group_offsets(model.cfg)
    seen = set()
    with torch.no_grad():
        for path, arr in leaves(tree):
            arr = np.asarray(arr)
            if path[0] in offsets:
                o = offsets[path[0]]
                names = [f"layers.{o + i}.{'.'.join(path[1:])}" for i in range(arr.shape[0])]
                parts = list(arr)
            else:
                names, parts = [".".join(path)], [arr]
            for name, part in zip(names, parts):
                if name not in params:
                    raise KeyError(f"{'/'.join(path)}: the model has no parameter {name}")
                p = params[name]
                if tuple(p.shape) != tuple(part.shape):
                    raise ValueError(f"{name}: shape {tuple(part.shape)} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.ascontiguousarray(part)))
                seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"the tree has no weights for {missing}")
    return model


def reference_params(model: Model):
    """The model's parameters as a reference-layout NumPy tree (bfloat16
    parameters come back as float32)."""
    cfg = model.cfg
    offsets = _group_offsets(cfg)
    counts = {f"g{i}": g.count for i, g in enumerate(plan(cfg))}
    tree: Dict = {}

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    for path, _ in leaves(_reference_specs(cfg)):
        if path[0] in offsets:
            sub, o = ".".join(path[1:]), offsets[path[0]]
            parts = [arr(model.get_parameter(f"layers.{o + i}.{sub}"))
                     for i in range(counts[path[0]])]
            _set(tree, path, np.stack(parts))
        else:
            _set(tree, path, arr(model.get_parameter(".".join(path))))
    return tree


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
