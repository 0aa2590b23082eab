"""Rank processes for the mesh training tests (gloo on the CPU, or ranks on the card).

Imported by spawned children (``torch_mesh_worker.spawn`` with the
scenario ``"torch_train_mesh_worker:<function>"``), so it imports torch,
NumPy and ``repro_torch`` only.  Every rank builds each case's reduced
model under the mesh from the same NumPy weights (its own slice of every
parameter), runs the train step on the whole batch's inputs and saves
the loss, ``grad_norm`` and ``lr`` of each step; rank 0 also the whole
parameters afterwards (``reference_params`` gathers them on every rank)
and every rank their digest.  The test process runs :func:`train_case`
itself under the abstract mesh of the same shape and compares.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import os

import numpy as np
import torch

#: The six families of the mesh training cases (MoE under ``topk``: the LP
#: router takes no gradient).
ARCHS = ("gemma2-2b", "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
         "seamless-m4t-large-v2", "qwen2-vl-72b")
#: (data, model) meshes by name: (2, 2) splits heads, vocabulary, experts and
#: the fsdp dimensions; on (1, 3) the model axis divides neither the 4 heads
#: (attention takes the ``seq_tp`` case over 24 tokens) nor d_model = 64
#: (the divisibility fallback replicates those weights).
MESHES = {"2x2": (2, 2), "1x3": (1, 3), "4x1": (4, 1), "2x4": (2, 4)}
SEED = 3
SEQ, BATCH, ACCUM = 24, 4, 2
OPT = dict(lr=1e-3, warmup_steps=2)


def config(arch: str, dtype: str = ""):
    from repro_torch import configs

    cfg = configs.get_config(arch, reduced=True)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return dataclasses.replace(cfg, router="topk") if cfg.num_experts else cfg


def batch_of(cfg, step: int, seq: int = SEQ, batch: int = BATCH, device="cpu"):
    """Step ``step``'s batch (``configs.make_inputs`` seeded by the step;
    M-RoPE positions whose coordinates differ)."""
    from repro_torch import configs

    out = configs.make_inputs(cfg, configs.Shape("t", seq, batch, "train"), seed=step,
                              device="cpu")
    if cfg.mrope_sections:
        out["positions"] = torch.as_tensor(configs.mrope_positions(batch, seq, cfg.num_patches,
                                                                   step))
    return {k: v.to(device) for k, v in out.items()}


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).view(np.uint8).tobytes())
    return h.hexdigest()


def flat_tree(tree) -> dict:
    from repro_torch.sharding import leaves

    return {"/".join(p): np.asarray(a) for p, a in leaves(tree)}


def nudged(tree, seed: int):
    """Every weight one float32 ulp up or down (a seeded coin a weight)."""
    from repro_torch.sharding import leaves

    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, a in leaves(tree):
        up = rng.random(a.shape) < 0.5
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.nextafter(a, np.where(up, np.float32(np.inf), np.float32(-np.inf)))
    return out


def train_case(cfg, *, steps: int = 1, accum: int = ACCUM, with_ef: bool = False,
               device="cpu", keep_params: bool = True, nudge: int = 0, seq: int = SEQ,
               batch: int = BATCH) -> dict:
    """``steps`` train steps of ``cfg`` from ``reference_weights(cfg, SEED)``
    (``nudged`` by the seed ``nudge`` if given) under the active mesh: each
    step's metrics, and the whole parameters after (``keep_params``) with
    their digest."""
    from repro_torch.models import Model
    from repro_torch.models.convert import (load_reference_params, reference_leaf_of,
                                            reference_params, reference_weights)
    from repro_torch.train import compression, optimizer
    from repro_torch.train.train_step import make_train_step

    tree = reference_weights(cfg, SEED)
    model = load_reference_params(Model(cfg, device=device), nudged(tree, nudge) if nudge else tree)
    ocfg = optimizer.OptConfig(**OPT)
    opt = optimizer.init(dict(model.named_parameters()), ocfg)
    comp, ef = None, {}
    if with_ef:
        init_fn, compress = compression.make_ef_compressor(reference_leaf_of(model))
        ef["state"] = init_fn(dict(model.named_parameters()))

        def comp(g, opt_state):
            g2, ef["state"] = compress(g, ef["state"])
            return g2, opt_state

    step = make_train_step(model, ocfg, accum=accum, remat=True, compression=comp)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for s in range(steps):
        opt, m = step(opt, batch_of(cfg, s, seq=seq, batch=batch, device=device))
        for k in out:
            out[k].append(float(m[k]))
    params = flat_tree(reference_params(model))
    out["digest"] = digest(params[k] for k in sorted(params))
    if keep_params:
        out["params"] = params
    return out


def mesh_of(shape, device="cpu"):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device, torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _no_sum(x, axes, dim):
    """A reduce-scatter without its sum: this rank's block of its own ``x``."""
    from repro_torch.sharding import collectives as coll

    per = x.shape[dim] // coll.size(axes)
    return x.narrow(dim, _group_index(axes) * per, per)


#: The negative controls: the train step with its seed left at 1 (the
#: gradients ``ranks`` times too large), with no sum over the axes a
#: parameter is stored whole on (partial gradients), or with the
#: sequence-parallel stream's reduce-scatter replaced by a cut of the
#: rank's block without the sum (a rank's partial products as the stream).
#: Each: (the ``repro_torch`` module, its attribute, the stand-in).
CONTROLS = {"control_seed": ("train.train_step", "_ranks", lambda: 1),
            "control_sum": ("train.train_step", "sum_replicated", lambda grads, params: grads),
            "control_scatter": ("sharding.collectives", "reduce_scatter", _no_sum)}


def _cases(rank, world, meshes, cases):
    import contextlib

    from torch_lm_mesh_worker import mixer_spy

    from repro_torch.models import Model
    from repro_torch.sharding import partition

    out = {}
    for name in meshes:
        with partition.activate(mesh_of(MESHES[name])):
            for key, kw in cases.items():
                mod, attr, fake = CONTROLS.get(key[1], (None, None, None))
                if mod:
                    mod = importlib.import_module("repro_torch." + mod)
                    orig = getattr(mod, attr)
                    setattr(mod, attr, fake)
                # a step: the residual stream and the layer inputs saved; an
                # SSM or hybrid family's also what mixer_spy.MixerSpy sees of
                # its mixers (the forward, remat's recompute, the backward)
                cfg = config(key[0])
                step = key[1] == "step"
                spy = mixer_spy().MixerSpy() if step and cfg.supports_long_context else None
                stream = mixer_spy().ResidualSpy(sums=False) if step else None
                saved = mixer_spy().SavedLayerInputs() if step else None
                try:
                    with spy or contextlib.nullcontext(), stream or contextlib.nullcontext(), \
                            saved or contextlib.nullcontext():
                        out[(name,) + key] = train_case(cfg, keep_params=rank == 0, **kw)
                finally:
                    if mod:
                        setattr(mod, attr, orig)
                if spy is not None:
                    parent = mixer_spy().mixer_parent_gathers(Model(cfg, device="meta"))
                    out[(name, key[0], "mixer")] = spy.summary(parent)
                if step:
                    out[(name, key[0], "stream")] = dict(
                        records=stream.records, scatters=len(stream.scatters),
                        saved_bytes=saved.bytes, layers_saved=saved.layers)
    return out


def train4(rank, world, tmp):
    """The 4-rank group: the collectives' backward, every family on (2, 2),
    ``accum=2`` with the error-feedback compressor over two steps,
    ``accum=1``, and the negative controls."""
    cases = {(arch, "step"): {} for arch in ARCHS}
    cases[("gemma2-2b", "ef")] = dict(steps=2, with_ef=True)
    cases[("gemma2-2b", "accum1")] = dict(accum=1)
    cases.update({("gemma2-2b", c): {} for c in CONTROLS})
    return {**_cases(rank, world, ["2x2"], cases), "collectives": collectives(rank, world, tmp),
            "checkpoint": name_keyed_checkpoint(rank, world, tmp)}


def name_keyed_checkpoint(rank, world, tmp):
    """A name-keyed checkpoint of a model's parameters written on (2, 2)
    (``save`` gathers every leaf by its ``.spec``; rank 0 writes) and
    restored onto (4, 1) with ``Model.param_shardings``: each rank's
    restored slice against its slice of the whole weights."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights
    from repro_torch.sharding import partition

    cfg = config("deepseek-v2-lite-16b")
    tree = reference_weights(cfg, SEED)
    whole = dict(load_reference_params(Model(cfg, device="cpu"), tree).named_parameters())
    path = os.path.join(tmp, "ckpt")
    with partition.activate(mesh_of(MESHES["2x2"])):
        model = load_reference_params(Model(cfg, device="cpu"), tree)
        ckpt.save(path, 1, {"params": dict(model.named_parameters())})
    out = {"files": sorted(os.listdir(path))}
    like = {"params": {n: torch.zeros(p.shape) for n, p in whole.items()}}
    with partition.activate(mesh_of(MESHES["4x1"])):
        target = Model(cfg, device="cpu")
        got = ckpt.restore(path, like, shardings={"params": target.param_shardings()})["params"]
        mine = {n: p[partition.local_slices(p.spec.shape, p.spec.axes)]
                for n, p in whole.items()}
        out["shapes_equal"] = all(tuple(got[n].shape) == tuple(p.shape)
                                  for n, p in target.named_parameters())
        out["bits_equal"] = all(torch.equal(got[n], mine[n]) for n in whole)
        out["split"] = sum(tuple(got[n].shape) != tuple(whole[n].shape) for n in whole)
    return out


def train3(rank, world, tmp):
    """The 3-rank group: every family on (1, 3)."""
    return _cases(rank, world, ["1x3"], {(arch, "step"): {} for arch in ARCHS})


#: The counterpart of the reference's own
#: ``tests/test_distributed.py::test_sharded_train_step_matches_single_device``:
#: reduced qwen1.5-4b, one step of 8 x 32 tokens, ``accum=2``, on (2, 4).
QWEN = dict(arch="qwen1.5-4b", mesh="2x4", seq=32, batch=8)


def qwen8(rank, world, tmp):
    from repro_torch.sharding import partition

    with partition.activate(mesh_of(MESHES[QWEN["mesh"]])):
        return train_case(config(QWEN["arch"]), seq=QWEN["seq"], batch=QWEN["batch"],
                          keep_params=rank == 0)


#: The reference's side, in a JAX subprocess with 8 forced host devices:
#: argv = (output path,).  The reference's jitted train step on the same
#: NumPy weights and batch under an ``Auto``-typed (2, 4) mesh (the
#: reference's sharded step raises under the default ``Explicit`` axes).
REFERENCE = '''
import sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from jax.sharding import AxisType
from repro import configs as rconfigs
from repro.models import Model
from repro.sharding import partition
from repro.train import optimizer as ropt, train_step as rts
import torch_train_mesh_worker as w
from repro_torch.models.convert import reference_weights
from repro_torch.sharding import leaves

cfg = w.config(w.QWEN["arch"])
rcfg = rconfigs.get_config(w.QWEN["arch"], reduced=True)
tree = reference_weights(cfg, w.SEED)
batch = {k: jnp.asarray(v.numpy())
         for k, v in w.batch_of(cfg, 0, seq=w.QWEN["seq"], batch=w.QWEN["batch"]).items()}
shape = w.MESHES[w.QWEN["mesh"]]
mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:shape[0] * shape[1]])
with partition.activate(mesh):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ocfg = ropt.OptConfig(**w.OPT)
    step = jax.jit(rts.make_train_step(Model(rcfg), ocfg, accum=w.ACCUM, remat=True))
    params, _, metrics = step(params, ropt.init(params, ocfg), batch)
out = {"loss": np.float64(metrics["loss"]), "grad_norm": np.float64(metrics["grad_norm"]),
       "lr": np.float64(metrics["lr"])}
out.update({"params/" + "/".join(p): np.asarray(a) for p, a in leaves(params)})
np.savez(sys.argv[1], **out)
'''


def card_nccl(rank, world, tmp):
    """NCCL with one rank on the card: reduced gemma2 and deepseek's train
    steps without a mesh and on a (1, 1) mesh (every group of one rank),
    deterministic algorithms on."""
    from repro_torch.sharding import partition

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for arch in ("gemma2-2b", "deepseek-v2-lite-16b"):
        cfg = config(arch)
        out[(arch, "plain")] = train_case(cfg, steps=2, device=dev)
        with partition.activate(mesh_of((1, 1), "cuda")):
            out[(arch, "mesh")] = train_case(cfg, steps=2, device=dev)
    return out


def card_gloo(rank, world, tmp):
    """Gloo ranks sharing the card on (2, 2): every family's train step."""
    from repro_torch.sharding import partition

    dev = torch.device("cuda", torch.cuda.current_device())
    with partition.activate(mesh_of(MESHES["2x2"], "cuda")):
        return {arch: train_case(config(arch), device=dev, keep_params=rank == 0)
                for arch in ARCHS}


# ---------------------------------------------------------------------------
# The collectives' backward
# ---------------------------------------------------------------------------


class _Replicated(torch.autograd.Function):
    """A replicated input: the identity forward; the backward sums each
    rank's gradient over the group and divides by its size (every rank's
    copy is one variable of the test's function, as a replicated
    parameter is in the train step)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        from repro_torch.sharding import collectives as coll

        return coll._reduce(g, ctx.axes, "sum") / coll.size(ctx.axes), None


def _group_index(axes) -> int:
    from repro_torch.sharding import partition

    shape, coords, idx = partition.mesh_shape(partition.active_mesh()), partition.coordinates(), 0
    for ax in shape:
        if ax in axes:
            idx = idx * shape[ax] + coords[ax]
    return idx


def _functions(axes):
    """name -> the collective under test as a function of the group's whole
    input ``X`` (n, 4, 4), the same on every rank; each output the same on
    every rank."""
    from repro_torch.sharding import collectives as coll

    def mine(x):
        return _Replicated.apply(x, axes)[_group_index(axes)]

    return {
        "all_reduce": lambda x: coll.all_reduce(mine(x), axes),
        "all_gather_dim0": lambda x: coll.all_gather(mine(x), axes, 0),
        "all_gather_dim1": lambda x: coll.all_gather(mine(x), axes, 1),
        "all_to_all_0_1": lambda x: coll.all_gather(coll.all_to_all(mine(x), axes, 0, 1), axes, 0),
        "all_to_all_1_1": lambda x: coll.all_gather(coll.all_to_all(mine(x), axes, 1, 1), axes, 0),
        "reduce_scatter_dim0": lambda x: coll.all_gather(coll.reduce_scatter(mine(x), axes, 0),
                                                         axes, 0),
        "reduce_scatter_dim1": lambda x: coll.all_gather(coll.reduce_scatter(mine(x), axes, 1),
                                                         axes, 1),
    }


def _adjoint(axes, rank):
    """For each collective C: the sum over the group of <C(x), y> against the
    sum of <x, C*(y)> (C* its backward), on per-rank random x and y, float64."""
    from repro_torch.sharding import collectives as coll

    n = coll.size(axes)
    rng = np.random.default_rng(100 + rank)
    x0 = torch.as_tensor(rng.standard_normal((4 * n, 6 * n)))
    ops = {"all_reduce": lambda x: coll.all_reduce(x, axes),
           "all_gather_dim0": lambda x: coll.all_gather(x, axes, 0),
           "all_gather_dim1": lambda x: coll.all_gather(x, axes, 1),
           "all_to_all_0_1": lambda x: coll.all_to_all(x, axes, 0, 1),
           "all_to_all_1_0": lambda x: coll.all_to_all(x, axes, 1, 0),
           "all_to_all_0_0": lambda x: coll.all_to_all(x, axes, 0, 0),
           "reduce_scatter_dim0": lambda x: coll.reduce_scatter(x, axes, 0),
           "reduce_scatter_dim1": lambda x: coll.reduce_scatter(x, axes, 1)}
    out = {}
    for name, op in ops.items():
        x = x0.clone().requires_grad_(True)
        y = op(x)
        w = torch.as_tensor(rng.standard_normal(tuple(y.shape)))
        y.backward(w)
        sums = torch.stack([(y.detach() * w).sum(), (x * x.grad).sum()])
        out[name] = coll._reduce(sums, axes, "sum").tolist() if n > 1 else sums.tolist()
    return out


def _bf16_scatter(axes):
    """A bfloat16 reduce-scatter whose float32 sum differs from any bfloat16
    one: the group's first rank holds 1, every other 2**-9 (bfloat16 keeps
    8 bits: 1 + 2**-9 rounds back to 1, while 1 + 3 * 2**-9 rounds up).
    Returns (this rank's block, the float32 sum rounded once, the bfloat16
    sum in rank order)."""
    from repro_torch.sharding import collectives as coll

    n = coll.size(axes)
    parts = [1.0] + [2.0 ** -9] * (n - 1)
    x = torch.full((2 * n, 3), parts[_group_index(axes)], dtype=torch.bfloat16)
    seq = torch.tensor(0.0, dtype=torch.bfloat16)
    for v in parts:
        seq = seq + torch.tensor(v, dtype=torch.bfloat16)
    once = torch.tensor(sum(parts), dtype=torch.float32).to(torch.bfloat16)
    return coll.reduce_scatter(x, axes, 0).float().tolist(), float(once), float(seq)


def collectives(rank, world, tmp):
    """Each collective's backward: ``gradcheck`` of the functions of
    :func:`_functions` in float64 and the adjoint identity, over the
    model axis (2 ranks), the data axis (2) and both (4) of (2, 2), and
    the model axis of (4, 1) (1 rank: the identity both ways); and the
    maximum, which takes no gradient."""
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import partition

    out = {}
    for mesh_name, groups in (("2x2", ("model", "data", ("data", "model"))), ("4x1", ("model",))):
        with partition.activate(mesh_of(MESHES[mesh_name])):
            for axes in groups:
                axes = (axes,) if isinstance(axes, str) else axes
                key = (mesh_name, "+".join(axes))
                n = coll.size(axes)
                x = torch.as_tensor(np.random.default_rng(7).standard_normal((n, 4, 4)),
                                    dtype=torch.float64).requires_grad_(True)
                out[key + ("gradcheck",)] = {
                    name: bool(torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-9))
                    for name, fn in _functions(axes).items()}
                out[key + ("adjoint",)] = _adjoint(axes, rank)
                out[key + ("bf16",)] = _bf16_scatter(axes)
                v = torch.full((3,), float(rank), requires_grad=True)
                m = coll.all_reduce(v, axes, "max")
                out[key + ("max",)] = (m.tolist(), m.requires_grad)
                if n == 1:
                    y = coll.all_gather(v, axes, 0)
                    y.sum().backward()
                    out[key + ("identity",)] = (y is v, v.grad.tolist())
    return out
