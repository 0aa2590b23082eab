"""A CPU rehearsal of ``chip_smoke.py``'s slice-15 phase
(``lm_train_mesh_phase``) on reduced configs, with the card's clock and
memory calls stubbed: (a) the one-rank (1, 1) mesh's train steps
bit-identical to the meshless steps (gloo here, NCCL on the card); (b) 4
gloo ranks on (2, 2) held against the one-process run under the abstract
mesh and against the fixture tool's reduced mesh training fixture
(``--train --mesh 2,2``, the reference's sharded step under an
``Auto``-typed mesh of 4 host devices, built in a JAX subprocess),
mamba2's preempted run resumed bit-equal and its checkpoint restored
onto (4, 1) and onto one process, and deepseek's eval step under ``lp``
(every rank's router LPs the same bits, each replayed bit-identical on
``simplex_plain``).  Then the ``gpu`` tier's MoE training case
(``lm_train_mesh_moe_case``: deepseek on the ranks held step by step
against the float64 witness, with its routing flips), the gates against
planted faults, and the committed mesh fixture's shape."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lm_serve import ROOT, _module, _ReducedConfigs, _stub_the_card

MESH_FIXTURE = ROOT / "tests" / "data" / "lm_train_gemma2_2b_mesh_reference.npz"
BUILD = '''
import sys, jax, numpy as np
jax.config.update("jax_enable_x64", True)
from jax.sharding import AxisType
import lm_reference_fixture as tool
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
fx = tool.build_train_fixture("gemma2-2b", reduced=True, layers=0, seq=32, mesh=mesh)
np.savez(sys.argv[1], **fx)
'''


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_mesh") / "train_mesh.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tools")])}
    out = subprocess.run([sys.executable, "-c", BUILD, str(path)], env=env, capture_output=True,
                         text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def phase(fixture, tmp_path_factory):
    """The phase on the CPU; its JSON lines by phase name."""
    import json

    from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda

    mp = pytest.MonkeyPatch()
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = smoke  # the spawned ranks import it by name
    mp.syspath_prepend(str(ROOT))
    _stub_the_card(mp, smoke)
    for name, value in (("LM_TRAIN_MESH_FIXTURE", Path(fixture)), ("LM_TRAIN_SEQ", 32),
                        ("LM_TRAIN_MESH_NCCL_BACKEND", "gloo")):
        mp.setattr(smoke, name, value)
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}

    def reset():
        for mod in counters.values():
            mod.launches = 0

    lines = []
    mp.setattr(smoke, "emit", lambda phase, **fields: lines.append((phase, fields)))
    try:
        out = smoke.lm_train_mesh_phase(_ReducedConfigs(), torch.device("cpu"), seed=0,
                                        counters=counters, reset=reset,
                                        tmp_root=tmp_path_factory.mktemp("phase"))
    finally:
        mp.undo()
    by_name = {}
    for name, fields in lines:
        by_name.setdefault(name, []).append(json.loads(json.dumps(fields, default=str)))
    return out, by_name


@pytest.fixture(scope="module")
def moe(fixture, tmp_path_factory):
    """``lm_train_mesh_moe_case`` on the CPU (reduced deepseek): its line."""
    mp = pytest.MonkeyPatch()
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = smoke  # the spawned ranks import it by name
    mp.syspath_prepend(str(ROOT))
    _stub_the_card(mp, smoke)
    mp.setattr(smoke, "LM_TRAIN_MESH_FIXTURE", Path(fixture))
    mp.setattr(smoke, "emit", lambda phase, **fields: None)
    try:
        return smoke.lm_train_mesh_moe_case(_ReducedConfigs(), torch.device("cpu"), seed=0,
                                            out_dir=str(tmp_path_factory.mktemp("moe")))
    finally:
        mp.undo()


def test_nccl_one_rank_steps_are_the_bits_of_no_mesh(phase):
    row = phase[1]["lm_train_mesh"][0]
    assert row["part"] == "nccl_1rank" and row["mesh"] == [1, 1]
    assert row["state_bit_identical_after_each_step"] == [True, True]
    assert all(np.isfinite(row["loss"]))


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-lite-16b"])
def test_gloo_ranks_hold_the_one_process_run(request, arch):
    """gemma2 in the phase: the ranks against the one-process run and the
    fixture.  deepseek in the MoE case: every step's ranks and router
    logits within the gates of the float64 witness replaying their
    routing, and within the one-process gate, replaying and free (no
    routing flips at this size)."""
    if arch == "gemma2-2b":
        row = request.getfixturevalue("phase")[1]["lm_train_mesh"][1]
        assert row["arch"].startswith("gemma2") and row["ranks_agree"]
        gates = row["against_one_process"]
        assert gates["ok"] and gates["lr_equal"] and gates["worst_ratio"] <= 1.0, gates
        assert row["against_fixture"]["ranks"]["ok"]
        assert row["against_fixture"]["one_process"]["ok"]
    else:
        row = request.getfixturevalue("moe")
        assert row["arch"].startswith("deepseek") and row["lr_equal"]
        assert [s["step"] for s in row["steps"]] == [0, 1, 2]
        for step in row["steps"]:
            assert step["ok"] and step["witness_worst_ratio"] <= 1.0, step
            assert step["logits"]["ratio"] <= 1.0 and step["logits"]["ranks"] > 0, step
            assert step["one_process_worst_ratio"] <= 1.0, step
            assert step["free"]["witness_worst_ratio"] <= 1.0, step
            assert step["free"]["one_process_worst_ratio"] <= 1.0, step
            flips = step["flips"]["ranks"]
            assert flips["chosen"] == flips["kept"] == 0, step["flips"]
            assert step["flips"]["tokens_routed_a_step"] > 0
            assert step["router"]  # the router's change is read at every step
    for rank in row["ranks"]:
        assert rank["stored_bytes"] == rank["spec_bytes"]
        assert rank["share_of_one_process"] < 0.5  # (2, 2) splits every large leaf


def test_checkpoints_resume_and_restore_on_other_meshes(phase):
    row = phase[1]["lm_train_mesh_checkpoint"][0]
    assert row["preempted_at"] == 3 and row["resumed_from"] == 2 and row["resumed_steps"] == [2, 3]
    assert row["resumed_bit_equal"] == [True] * 4
    assert row["restored_onto_4x1_bit_equal"] == [True] * 4
    assert row["restored_onto_one_process_bit_equal"]


def test_eval_step_under_lp_on_every_rank(phase):
    row = phase[1]["lm_train_mesh_eval_lp"][0]
    assert row["lps_bit_identical_across_ranks"]
    assert row["lps"] == [row["moe_layers"]] * 4 and row["moe_layers"] > 0
    assert row["replayed_bit_identical_on_simplex_plain"] == [row["moe_layers"]] * 4
    assert row["loss_rel_err"] <= row["loss_tol"]


def test_main_path_summary(phase):
    out, lines = phase
    assert lines["main_path_summary"][0]["path"] == "slice15_lm_train_mesh"
    assert len(out["per_rank"]) == 4 and not any(out["nccl"].values())


def test_mesh_gates_reject_planted_faults(phase):
    """A rank's run with its first loss moved by 1e-3, or with one leaf's
    change scaled by 1 + 1e-1, fails ``lm_train_mesh_gates``; the one
    process's own run passes them."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    rng = np.random.default_rng(0)
    n = 64
    samples = dict(leaf_paths=np.asarray(["a", "b"]), sample_sizes=np.asarray([n, n]),
                   sample_idx=np.arange(2 * n))
    start = rng.standard_normal(2 * n)
    one = dict(loss=[2.0, 1.9], grad_norm=[3.0, 2.5], lr=[1e-3, 1e-3], start=start,
               after=start + 1e-3 * rng.standard_normal(2 * n), samples=samples)
    noise = dict(loss=[1e-6, 0.0], grad_norm=[0.0, 0.0], delta=np.asarray([1e-5, 1e-5]))
    assert smoke.lm_train_mesh_gates(one, one, noise)["ok"]
    bad = dict(one, loss=[2.0 * (1 + 1e-3), 1.9])
    assert not smoke.lm_train_mesh_gates(bad, one, noise)["ok"]
    after = one["after"].copy()
    after[:n] = start[:n] + (after[:n] - start[:n]) * 1.1
    assert not smoke.lm_train_mesh_gates(dict(one, after=after), one, noise)["ok"]


def test_committed_mesh_training_fixture():
    """The fixture ``chip_smoke.py`` reads: gemma2-2b at full width cut to 4
    layers, three steps under the reference's (2, 2) mesh, a sample of
    every leaf's change."""
    fx = np.load(MESH_FIXTURE)
    assert str(fx["kind"]) == "train" and str(fx["arch"]) == "gemma2-2b"
    assert tuple(fx["mesh"]) == (2, 2) and int(fx["layers"]) == 4 and int(fx["steps"]) == 3
    assert fx["delta"].shape == fx["f64_delta"].shape == fx["sample_idx"].shape
    assert int(fx["sample_sizes"].sum()) == fx["sample_idx"].size
    assert np.all(np.isfinite(fx["loss"])) and np.all(fx["noise_delta"] >= 0)


def test_route_spy_replays_another_routing():
    """``RouteSpy(forced=)``, which replays the ranks' routing in the
    witness runs: every call takes the experts it is given (here each
    token's free choices shifted by one expert), and the layer's output
    changes with them."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model

    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    cfg = dataclasses.replace(configs.get_config("deepseek-v2-lite-16b", reduced=True),
                              router="topk")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = configs.make_inputs(cfg, configs.Shape("t", 16, 2, "train"), seed=0, device="cpu")
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad(), smoke.RouteSpy() as free:
        h_free = model.forward(inputs)
    forced = [(e + 1) % cfg.num_experts for e, _, _ in free.calls]
    with torch.no_grad(), smoke.RouteSpy(forced=forced) as replay:
        h_replay = model.forward(inputs)
    assert len(replay.calls) == len(forced) > 0
    assert all(np.array_equal(e, f) for (e, _, _), f in zip(replay.calls, forced))
    assert not torch.equal(h_free, h_replay)


def test_witness_gate_rejects_planted_faults():
    """``lm_train_mesh_witness``: runs as close to the float64 witness as
    the float32 runs pass; a rank's second loss moved by 1e-3, or one
    leaf's change after the last step scaled by 1 + 1e-1, fails its step."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    rng = np.random.default_rng(1)
    n = 64
    samples = dict(leaf_paths=np.asarray(["a", "g1/ffn/router"]),
                   sample_sizes=np.asarray([n, n]), sample_idx=np.arange(2 * n))
    start = rng.standard_normal(2 * n)
    f64 = dict(loss=[2.0, 1.9], grad_norm=[3.0, 2.5], start=start,
               afters=[start + 1e-3 * rng.standard_normal(2 * n) for _ in range(2)])

    def near(scale, seed):
        r = np.random.default_rng(seed)
        return dict(loss=[x * (1 + scale * r.standard_normal()) for x in f64["loss"]],
                    grad_norm=[x * (1 + scale * r.standard_normal()) for x in f64["grad_norm"]],
                    afters=[a + 1e-3 * scale * r.standard_normal(2 * n) for a in f64["afters"]])

    one = dict(near(1e-4, 2), start=start, samples=samples)
    nudges = [dict(near(1e-4, 3 + k), start=start) for k in range(2)]
    good = dict(near(1e-4, 9), start=start)
    steps = smoke.lm_train_mesh_witness(good, one, nudges, f64)
    assert [s["ok"] for s in steps] == [True, True], steps
    assert "g1/ffn/router" in steps[1]["router"]
    bad = dict(good, loss=[good["loss"][0], good["loss"][1] * (1 + 1e-3)])
    assert [s["ok"] for s in smoke.lm_train_mesh_witness(bad, one, nudges, f64)] == [True, False]
    afters = [a.copy() for a in good["afters"]]
    afters[1][:n] = start[:n] + (afters[1][:n] - start[:n]) * 1.1
    steps = smoke.lm_train_mesh_witness(dict(good, afters=afters), one, nudges, f64)
    assert [s["ok"] for s in steps] == [True, False] and steps[1]["witness_worst"] == "delta/a"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_device_digest_sees_one_bit(dtype):
    """The (1, 1) check's digest: equal tensors agree, one flipped bit does not."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    a = torch.randn(1000, generator=torch.Generator().manual_seed(0)).to(dtype)
    b = a.clone()
    ints = b.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[b.element_size()])
    ints[517] ^= 1
    assert not torch.equal(a, b)
    assert smoke.device_digest([a]) == smoke.device_digest([a.clone()])
    assert smoke.device_digest([a]) != smoke.device_digest([b])
