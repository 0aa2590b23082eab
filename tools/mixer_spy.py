"""What a rank's Mamba2 mixers do over the model axis: the heads of each
SSD scan and decode step, and each all-gather with its bytes.

Imported by ``chip_smoke.py`` (slices 14 and 15) and by the tests' mesh
workers (``tests/torch_lm_mesh_worker.py``,
``tests/torch_train_mesh_worker.py``) from this directory:

    sys.path.insert(0, "<checkout>/tools"); import mixer_spy

``MixerSpy`` wraps ``repro_torch.models.mamba2``'s scan, decode step and
mixer and ``repro_torch.sharding.collectives._gather`` for a ``with``;
``mixer_parent_gathers`` reckons from the shapes the model-axis gathers of
the mixer before the head split, which gathered every weight and cache
whole; ``lm_mesh_mixer_step`` reads both for a prefill and one decode
step.  ``ResidualSpy`` wraps ``repro_torch.models.blocks._res`` and
``collectives._scatter``: the residual stream's block at every block
boundary (rows, positions, shape, a float64 sum over the width of each
position) and every reduce-scatter; ``stream_rows`` reads it over a
prefill and decode steps.  ``SavedLayerInputs`` counts the bytes remat
keeps at the checkpointed layer inputs of ``Model.forward(remat=True)``.
"""

from __future__ import annotations

import math


class MixerSpy:
    """For the length of a ``with``: the heads of each SSD scan and each
    decode step of ``models/mamba2.py`` (``scan_heads``, ``decode_heads``),
    and each all-gather of ``sharding/collectives.py`` as ``(mesh axes,
    input shape, output bytes, inside a mamba mixer)`` (``gathers``)."""

    def __init__(self):
        from repro_torch.models import mamba2
        from repro_torch.sharding import collectives

        self.mb, self.coll = mamba2, collectives
        self.scan_heads, self.decode_heads, self.gathers = [], [], []
        self.depth = 0

    def __enter__(self):
        mb, coll = self.mb, self.coll
        self.orig = (mb._ssd_chunked, mb._decode_step, mb.mamba_mixer, coll._gather)
        scan, step, mixer, gather = self.orig

        def ssd(x, *args, **kw):
            self.scan_heads.append(int(x.shape[2]))
            return scan(x, *args, **kw)

        def decode(state, xs, *args):
            self.decode_heads.append(int(xs.shape[2]))
            return step(state, xs, *args)

        def mamba(*args, **kw):
            self.depth += 1
            try:
                return mixer(*args, **kw)
            finally:
                self.depth -= 1

        def gathered(x, axes, dim):
            out = gather(x, axes, dim)
            self.gathers.append((coll._mesh_axes(axes), tuple(x.shape),
                                 out.numel() * out.element_size(), self.depth > 0))
            return out

        mb._ssd_chunked, mb._decode_step, mb.mamba_mixer, coll._gather = (ssd, decode, mamba,
                                                                          gathered)
        return self

    def __exit__(self, *exc):
        self.mb._ssd_chunked, self.mb._decode_step, self.mb.mamba_mixer, self.coll._gather = \
            self.orig

    def summary(self, parent) -> dict:
        """What the tests and the mesh rows read: the heads of the scans and
        decode steps, the model-axis gathers' bytes inside the mixers, and
        the input shapes of those that gather a whole leaf (``parent``:
        :func:`mixer_parent_gathers`' shapes)."""
        mine = self.model_gathers()
        return dict(scan_heads=sorted(set(self.scan_heads)),
                    decode_heads=sorted(set(self.decode_heads)),
                    model_gather_bytes=sum(g[2] for g in mine),
                    whole_leaf_gathers=[g[1] for g in mine if g[1] in parent["shapes"]])

    def model_gathers(self, mixer_only: bool = True) -> list:
        """The gathers over a group that holds the model axis."""
        return [g for g in self.gathers if "model" in g[0] and (g[3] or not mixer_only)]


def mixer_parent_gathers(model, cache=None) -> dict:
    """The model-axis all-gathers of the mixer before the head split (every
    mixer weight gathered whole, the data axes first where they come
    first, and the conv and state caches over the model axis) for one
    call of every mamba layer, reckoned from this rank's shapes: their
    output ``bytes``, and the input shapes of ``in_proj``'s,
    ``out_proj``'s and the state cache's gathers (``shapes``)."""
    from repro_torch.models.blocks import MambaBlock
    from repro_torch.sharding import collectives as coll

    out, shapes = 0, set()

    def gathers(t, weight: bool):
        nonlocal out
        shape, seen = list(t.shape), []
        for d, axes in coll.split_dims(t):
            if "model" in axes:
                seen.append(tuple(shape))
            if weight or "model" in axes:
                shape[d] = t.spec.shape[d]
                if "model" in axes:
                    out += math.prod(shape) * t.element_size()
        return seen

    layers = [m for m in model.modules() if isinstance(m, MambaBlock)]
    for block in layers:
        for name, w in block.mixer.items():
            seen = gathers(w, True)
            if name in ("in_proj", "out_proj"):
                shapes.update(seen)
    for layer in (cache or []):
        if set(layer) == {"conv", "state"}:
            for name, t in layer.items():
                seen = gathers(t, False)
                if name == "state":
                    shapes.update(seen)
    return dict(bytes=out, shapes=shapes, layers=len(layers))


def mesh_heads(cfg, model: int) -> int:
    """The heads each SSD scan runs on a model axis of ``model`` ranks: its
    block where the axis divides the heads, else all of them."""
    h = cfg.ssm_heads
    return h // model if h % model == 0 else h


def lm_mesh_mixer_step(model, prompts, generated) -> dict:
    """The prefill of ``prompts`` and one decode step (the first generated
    token) under :class:`MixerSpy`: the heads of the prefill's scans and
    of the step's decodes, the step's model-axis all-gather bytes inside
    the mixers and in all, the mixers' before the split reckoned from the
    shapes (:func:`mixer_parent_gathers`), and the input shapes of any
    gather of a whole ``in_proj``, ``out_proj`` or state cache."""
    b, p = prompts.shape
    cache = model.init_cache(b, p + 1)
    with MixerSpy() as pre:
        model.prefill({"tokens": prompts}, cache)
    with MixerSpy() as step:
        model.decode_step({"tokens": generated[:, :1].to(prompts)}, cache, p)
    parent = mixer_parent_gathers(model, cache)
    pre_sum, step_sum = pre.summary(parent), step.summary(parent)
    total = sum(g[2] for g in step.model_gathers(mixer_only=False))
    return dict(scan_heads=pre_sum["scan_heads"], decode_heads=step_sum["decode_heads"],
                mamba_layers=parent["layers"],
                decode_mixer_model_gather_bytes=step_sum["model_gather_bytes"],
                decode_step_model_gather_bytes=total,
                parent_decode_mixer_model_gather_bytes=parent["bytes"],
                parent_decode_step_model_gather_bytes=total - step_sum["model_gather_bytes"]
                + parent["bytes"],
                whole_leaf_gathers=pre_sum["whole_leaf_gathers"] + step_sum["whole_leaf_gathers"])


class ResidualSpy:
    """For the length of a ``with``: the residual stream at every block
    boundary of ``models/blocks.py`` (each ``_res``) as this rank holds it
    (``records``: its ``shape``, its ``rows`` of the batch, its block
    ``seq`` of the ``positions`` the stream names, the mesh ``axes`` that
    cut them and, with ``sums``, each position's float64 sum over the
    width), and each reduce-scatter of ``sharding/collectives.py`` as
    ``(mesh axes, input shape)`` (``scatters``)."""

    def __init__(self, sums: bool = True):
        from repro_torch.models import blocks
        from repro_torch.sharding import collectives, partition

        self.blk, self.coll, self.part = blocks, collectives, partition
        self.sums = sums
        self.records, self.scatters = [], []

    def __enter__(self):
        blk, coll, part = self.blk, self.coll, self.part
        self.orig = (blk._res, coll._scatter)
        res, scatter = self.orig

        def stream(x):
            lo, hi, axes = coll.stream_range()
            batch = part.current_batch()
            rows = part.batch_rows(batch) if batch else slice(0, x.shape[0])
            self.records.append(dict(
                shape=tuple(x.shape), rows=(rows.start, rows.stop), seq=(lo, hi),
                positions=part.current_seq(), axes=tuple(axes),
                sums=x.detach().double().sum(-1).cpu() if self.sums else None))
            return res(x)

        def scattered(x, axes, dim):
            self.scatters.append((coll._mesh_axes(axes), tuple(x.shape), part.current_seq()))
            return scatter(x, axes, dim)

        blk._res, coll._scatter = stream, scattered
        return self

    def __exit__(self, *exc):
        self.blk._res, self.coll._scatter = self.orig

    def blocks(self, positions=None) -> list:
        """The distinct ``[rows, seq, positions]`` of the records (of a stream
        of ``positions`` only, if given), in order."""
        out = []
        for r in self.records:
            key = [list(r["rows"]), list(r["seq"]), r["positions"]]
            if key not in out and positions in (None, r["positions"]):
                out.append(key)
        return out

    def reduce_scatters(self, positions=None) -> int:
        """The reduce-scatters (inside a stream of ``positions`` only, if given)."""
        return sum(positions in (None, sc[2]) for sc in self.scatters)

    def shapes_match(self) -> bool:
        """Whether every record's shape is its rows by its block of positions."""
        return all(r["shape"][:2] == (r["rows"][1] - r["rows"][0], r["seq"][1] - r["seq"][0])
                   for r in self.records)


def stream_rows(spy: ResidualSpy, prompt: int) -> dict:
    """What a :class:`ResidualSpy` over a prefill of ``prompt`` positions and
    decode steps saw: the blocks of each stream at the block boundaries
    (``prefill``, ``decode``: ``[rows, positions, S]``), whether every
    boundary's shape is its block's, and the reduce-scatters of each."""
    return dict(prefill=spy.blocks(prompt), decode=spy.blocks(1),
                shapes_match=spy.shapes_match(),
                prefill_reduce_scatters=spy.reduce_scatters(prompt),
                decode_reduce_scatters=spy.reduce_scatters(1))


class SavedLayerInputs:
    """For a ``with``: the bytes that ``torch.autograd.graph.saved_tensors_hooks``
    sees saved at the checkpointed layer inputs of ``Model.forward(remat=True)``
    (``models/model.py``'s ``checkpoint`` wrapped: inside it the hook sees
    what the checkpoint keeps of its arguments, the layer's input, and the
    checkpoint's own hooks take every tensor its layer saves)."""

    def __enter__(self):
        import torch

        from repro_torch.models import model

        self.mod, self.orig = model, model.checkpoint
        self.bytes, self.layers = 0, 0

        def pack(t):
            self.bytes += t.numel() * t.element_size()
            return t

        def checkpoint(fn, *args, **kw):
            self.layers += 1
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                return self.orig(fn, *args, **kw)

        model.checkpoint = checkpoint
        return self

    def __exit__(self, *exc):
        self.mod.checkpoint = self.orig
