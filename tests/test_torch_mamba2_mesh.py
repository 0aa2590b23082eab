"""The head-split Mamba2 mixer over the model axis
(``repro_torch.models.mamba2.mamba_mixer``) at the layer, and its plan.

One gloo group of 4 ranks on the CPU (``tests/torch_mamba2_mesh_worker.py``)
stores its slices of one mixer with two groups of B and C (reduced
mamba2-130m, ``ssm_ngroups=2``: 8 heads, 4 a group) on the meshes
``(data, model)`` (1, 4), where a rank's 2 heads are half a group,
(2, 2), where its 4 heads are one whole group, and (4, 1), where every
rank runs every head on weights stored split over the data axis.  On its rows of the
NumPy-seeded batch each rank runs the prefill into a cache, two decode
steps, and the gradient of ``sum(y * probe)``.  Held against the
reference ``repro.models.mamba2.mamba_mixer`` (the outputs and caches)
and the one-process port (the gradients) on the whole batch, with the
tolerance of ``tests/test_torch_mamba2.py``: relative L2 at most 1e-5,
max abs at most 2e-5 times the largest magnitude where that exceeds 1.
Each rank's cache slices and gradient slices are its placements'.

On planned ranks (``partition.activate({axis: size}, rank=r)``):
``head_split``'s rule, the group cut it refuses, and the meta-device
planner (``launch/dryrun.py:lower_cell``) on ``decode_32k`` at full
width, rank 0 of (1, 4): the all-gather bytes at most a tenth of the
mixer's before the split, which gathered its weights and caches whole
(``PARENT_ALL_GATHER``: the same planner on the parent tree), and the
dot FLOPs at most 0.35 of one process's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import torch_mamba2_mesh_worker as mw
import torch_mesh_worker as tw
from repro import configs as rconfigs
from repro.models import mamba2 as rmb
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import Model
from repro_torch.models import mamba2 as mb
from repro_torch.models.blocks import MambaBlock
from repro_torch.sharding import partition

RTOL, ATOL = 1e-5, 2e-5
#: The planner's all-gather bytes of rank 0 of (1, 4) on ``decode_32k``
#: before the head split (every mixer weight and cache gathered whole).
PARENT_ALL_GATHER = {"mamba2-130m": 2.6552e9, "zamba2-7b": 3.2266e10}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    assert err <= ATOL * max(1.0, float(np.abs(want).max())) and rel <= RTOL, (err, rel)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tw.spawn("torch_mamba2_mesh_worker:mixer", 4, tmp_path_factory.mktemp("mamba_mesh"))


@pytest.fixture(scope="module")
def whole():
    """The reference's outputs and caches, and the one-process port's
    gradients, on the whole batch."""
    cfg = mw.config()
    arr = mw.arrays(cfg)
    rcfg = dataclasses.replace(rconfigs.get_config("mamba2-130m", reduced=True), ssm_ngroups=2)
    params = {k: jnp.asarray(arr[k]) for k in mb.mamba_specs(cfg)}
    cache = {k: jnp.zeros(shape, dtype) for k, (shape, dtype)
             in rmb.mamba_cache_specs(rcfg, mw.BATCH, rcfg.dtype).items()}
    y, cache = rmb.mamba_mixer(jnp.asarray(arr["x"]), params, rcfg, cache=cache)
    ys = [np.asarray(y)]
    for i in range(mw.STEPS):
        y, cache = rmb.mamba_mixer(jnp.asarray(arr["steps"][i]), params, rcfg, cache=cache,
                                   cache_index=mw.SEQ + i)
        ys.append(np.asarray(y))
    port = mw.run(cfg, arr)
    return {"ys": ys, "cache": {k: np.asarray(v) for k, v in cache.items()},
            "grads": {k: g.numpy() for k, g in port["grads"].items()}}


def test_every_rank_finished(ranks):
    errors = [r["error"] for r in ranks if "error" in r]
    assert not errors, errors[0]


@pytest.mark.parametrize("mesh", list(mw.MESHES))
def test_outputs_and_caches_match_the_reference(ranks, whole, mesh):
    cfg = mw.config()
    data, model = mw.MESHES[mesh]
    for rank in ranks:
        got = rank[mesh]
        r0, r1 = got["rows"]
        for y, want in zip([got["prefill"]] + got["steps"], whole["ys"]):
            _close(y.numpy(), want[r0:r1])
        with partition.activate({"data": data, "model": model}):
            for k, (shape, _) in mb.mamba_cache_specs(cfg, mw.BATCH, cfg.dtype).items():
                sl = partition.local_slices(shape, mb.CACHE_AXES[k], got["coords"])
                _close(got["cache"][k].numpy(), whole["cache"][k][sl])
        per = cfg.ssm_heads // model
        m = got["coords"]["model"]
        assert got["heads"] == (m * per, (m + 1) * per, ("model",) if model > 1 else ())


@pytest.mark.parametrize("mesh", list(mw.MESHES))
def test_gradients_are_the_slices_of_the_one_process_gradients(ranks, whole, mesh):
    data, model = mw.MESHES[mesh]
    specs = mb.mamba_specs(mw.config())
    for rank in ranks:
        got = rank[mesh]
        with partition.activate({"data": data, "model": model}):
            for k, g in got["grads"].items():
                sl = partition.local_slices(specs[k].shape, specs[k].axes, got["coords"])
                _close(g.numpy(), whole["grads"][k][sl])


def _mixer_params(cfg):
    """A meta-device model's first mixer (this planned rank's slices)."""
    model = Model(cfg, device="meta")
    return next(m for m in model.modules() if isinstance(m, MambaBlock)).mixer


@pytest.mark.parametrize("model,rank,want", [(1, 0, (0, 8, ())), (3, 0, (0, 8, ())),
                                             (4, 0, (0, 2, ("model",))),
                                             (4, 3, (6, 8, ("model",))),
                                             (8, 5, (5, 6, ("model",)))])
def test_head_split_takes_the_heads_where_the_model_axis_divides_them(model, rank, want):
    """Reduced mamba2's 8 heads: every head on one rank or on 3 (the
    divisibility fallback), else each rank its block."""
    cfg = configs.get_config("mamba2-130m", reduced=True)
    with partition.activate({"data": 1, "model": model}, rank=rank):
        got = mb.head_split(_mixer_params(cfg), cfg)
    assert got == want


def test_head_split_refuses_heads_that_cut_a_group():
    """12 heads in 2 groups of 6 on 3 model ranks: 4 heads a rank cut a group."""
    cfg = dataclasses.replace(configs.get_config("mamba2-130m", reduced=True), d_model=96,
                              ssm_ngroups=2)
    with partition.activate({"data": 1, "model": 3}, rank=0):
        with pytest.raises(ValueError, match="cut the groups"):
            mb.head_split(_mixer_params(cfg), cfg)


@pytest.mark.parametrize("arch", list(PARENT_ALL_GATHER))
def test_the_planned_decode_step_gathers_a_tenth_and_computes_a_quarter(arch):
    one, _ = dryrun.lower_cell(arch, "decode_32k", mesh_override={"data": 1, "model": 1})
    split, _ = dryrun.lower_cell(arch, "decode_32k", mesh_override={"data": 1, "model": 4},
                                 rank=0)
    gathered = split["collective_bytes_per_device"]["all-gather"]
    assert gathered <= PARENT_ALL_GATHER[arch] / 10, gathered
    assert split["flops_per_device"] <= 0.35 * one["flops_per_device"], (
        split["flops_per_device"], one["flops_per_device"])
