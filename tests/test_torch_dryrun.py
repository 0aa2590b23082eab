"""``repro_torch.launch.dryrun``: one process plans one rank of a mesh on
the meta device (no card, no process group).

On an abstract (1, 1) mesh the planned rank's FLOPs and traffic are
``op_stats.analyze`` of the one-process train step; on (4, 2) its FLOPs
lie between the whole step's / 8 and the whole step's, its argument
bytes are the sum of rank 0's local shapes (parameters, the float32
optimizer state, the step, its rows of the inputs), and its collectives
move bytes.  ``main`` writes a record with the reference's keys for
every cell of qwen1.5-4b on the production (16, 16) mesh (its train
cell in seconds), and a config under ``router="lp"`` raises.
"""

import dataclasses
import json
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, op_stats
from repro_torch.models import Model
from repro_torch.sharding import partition
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_train_step

SHAPE = configs.Shape("t", 64, 8, "train")
#: The keys of the reference's record (``repro/launch/dryrun.py:lower_cell``).
REFERENCE_KEYS = {"arch", "shape", "kind", "multi_pod", "n_chips", "status", "lower_s",
                  "compile_s", "flops_per_device", "bytes_per_device",
                  "hlo_dot_flops_per_device", "hlo_traffic_bytes_per_device",
                  "collective_bytes_per_device", "memory", "param_count",
                  "active_param_count", "seq_len", "global_batch", "accum"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes", "generated_code_size_in_bytes"}


def _plan(mesh, arch="gemma2-2b", shape=SHAPE, accum=2):
    cfg = configs.get_config(arch, reduced=True)
    rec, _ = dryrun.lower_cell(arch, shape.name, accum=accum, cfg_override=cfg,
                               mesh_override=mesh, shape_override=shape)
    return rec


def _whole_step(arch="gemma2-2b", shape=SHAPE, accum=2):
    """``op_stats.analyze`` of the one-process train step on meta tensors."""
    cfg = configs.get_config(arch, reduced=True)
    model = Model(cfg, device="meta")
    ocfg = opt_mod.OptConfig()
    state = opt_mod.init(dict(model.named_parameters()), ocfg)
    inputs = {k: torch.empty(s.shape, dtype=getattr(torch, s.dtype), device="meta")
              for k, s in configs.input_specs(cfg, shape).items()}
    return op_stats.analyze(make_train_step(model, ocfg, accum=accum, remat=True), state, inputs)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-lite-16b", "mamba2-130m"])
def test_a_one_rank_mesh_plans_the_one_process_step(arch):
    rec = _plan({"data": 1, "model": 1}, arch)
    whole = _whole_step(arch)
    assert rec["flops_per_device"] == whole["dot_flops"] > 0
    assert rec["bytes_per_device"] == whole["traffic_bytes"]
    assert rec["collective_bytes_per_device"]["total"] == 0.0


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-lite-16b", "mamba2-130m"])
def test_a_rank_of_4x2_holds_its_share(arch):
    mesh = {"data": 4, "model": 2}
    rec = _plan(mesh, arch)
    whole = _whole_step(arch)["dot_flops"]
    assert whole / 8 <= rec["flops_per_device"] <= whole
    assert rec["collective_bytes_per_device"]["total"] > 0
    cfg = configs.get_config(arch, reduced=True)
    with partition.activate(mesh, rank=0):
        model = Model(cfg, device="meta")
        params = sum(p.numel() * p.element_size() for p in model.parameters())
        state = 3 * 4 * sum(p.numel() for p in model.parameters()) + 4
        inputs = sum(math.prod(partition.local_shape(s.shape, s.axes))
                     * torch.empty((), dtype=getattr(torch, s.dtype)).element_size()
                     for s in configs.input_specs(cfg, SHAPE).values())
    assert rec["memory"]["argument_size_in_bytes"] == params + state + inputs
    assert rec["memory"]["alias_size_in_bytes"] == params + state


def test_ranks_of_one_mesh_plan_their_own_slices():
    """Rank 0 and rank 7 of (4, 2) hold the same shares of an even split."""
    cfg = configs.get_config("gemma2-2b", reduced=True)
    recs = [dryrun.lower_cell("gemma2-2b", "t", accum=2, cfg_override=cfg, rank=r,
                              mesh_override={"data": 4, "model": 2}, shape_override=SHAPE)[0]
            for r in (0, 7)]
    assert recs[0]["flops_per_device"] == recs[1]["flops_per_device"]
    assert recs[0]["memory"] == recs[1]["memory"]
    assert recs[1]["rank"] == 7


def test_the_lp_router_cannot_be_planned():
    cfg = dataclasses.replace(configs.get_config("deepseek-v2-lite-16b", reduced=True),
                              router="lp")
    with pytest.raises(ValueError, match="router='lp'"):
        dryrun.lower_cell("deepseek-v2-lite-16b", "t", cfg_override=cfg, shape_override=SHAPE,
                          mesh_override={"data": 2, "model": 1})


def test_main_plans_every_cell_of_qwen_on_the_production_mesh(tmp_path):
    """qwen1.5-4b at full width on (16, 16), rank 0: train_4k, prefill_32k,
    decode_32k and the skipped long_500k, each in seconds."""
    dryrun.main(["--arch", "qwen1.5-4b", "--out", str(tmp_path)])
    recs = {}
    for shape in configs.SHAPES:
        with open(dryrun.cell_path("qwen1.5-4b", shape, False, str(tmp_path))) as f:
            recs[shape] = json.load(f)
    assert recs["long_500k"]["status"] == "skip(full-attn)"
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = recs[shape]
        assert rec["status"] == "ok" and REFERENCE_KEYS <= rec.keys(), shape
        assert set(rec["memory"]) == MEMORY_KEYS
        assert rec["memory"]["temp_size_in_bytes"] is None
        assert rec["n_chips"] == 256 and rec["mesh"] == {"data": 16, "model": 16}
        assert rec["flops_per_device"] > 0 and rec["collective_bytes_per_device"]["total"] > 0
        assert rec["lower_s"] < 120
    # 3.6e9 parameters: a rank's share of them, its optimizer state and its rows
    assert 1e9 / 16 < recs["train_4k"]["memory"]["argument_size_in_bytes"] < 2e9
