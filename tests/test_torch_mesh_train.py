"""The port's train step over a device mesh, and the backward of its collectives.

Gloo groups of 4 and 3 ranks are spawned on the CPU, side by side
(``tests/torch_train_mesh_worker.py``, each group with its own
``FileStore`` and timeout).  Every rank builds each reduced family
(gemma2-2b, deepseek-v2-lite-16b under ``topk`` with MLA, mamba2-130m,
zamba2-7b, seamless-m4t-large-v2, qwen2-vl-72b) under the mesh from the
same NumPy weights, storing only its slices, and runs one train step
(``accum=2``, remat) on the whole batch.  Meshes ``(data, model)``:
(2, 2), which splits the heads, the vocabulary, the experts and the
fsdp dimensions, and (1, 3), where the model axis divides neither the 4
heads (attention takes the ``seq_tp`` case) nor d_model = 64 (the
divisibility fallback replicates those weights, whose gradients are then
summed over the axis).  On (2, 2) also ``accum=2`` with the int8
error-feedback compressor over two steps, and ``accum=1``.

Held against the one-process port under the abstract mesh of the same
shape (the same MoE token groups), run here: every step's loss and
``grad_norm`` within ``SCALAR_TOL`` (float32 rounding: the split sums in
another order), ``lr`` equal, and each parameter leaf's change within
``trimmed_rel``'s gate, the largest of ``LEAF_FLOOR`` and
``NOISE_FACTOR`` times the one-process run's own change when every
weight moves one ulp (``NUDGE``); every rank gathers the same bits.  The
negative controls, a step seeded with 1 instead of ``1 / ranks``, one
without the sum over the axes a parameter is stored whole on, and one
whose reduce-scatters do not sum, fail them.

The head-split mixer (``models/mamba2.py:mamba_mixer``) in training:
on (2, 2) every SSD scan of mamba2 and zamba2 (the forward, and remat's
recompute in the backward) runs ``ssm_heads / 2`` heads and no
model-axis all-gather inside a mixer has ``in_proj``'s or ``out_proj``'s
input shape from before the split; on (1, 3), which does not divide the
8 heads, every scan runs all of them, on the same layout.

The sequence-parallel residual stream: at every block boundary of each
family's step (the forward and remat's recompute) on (2, 2) and (1, 3)
each rank holds its rows and positions of the reference's
``resolve_spec((B, S, D), ("batch", "seq_tp", None))`` (laid out by a
JAX subprocess started beside the groups); the bytes remat keeps at the
layer inputs (``saved_tensors_hooks``, ``tools/mixer_spy.py:
SavedLayerInputs``) are 1 / (data x model) of one process's; a third
negative control, the reduce-scatter replaced by a cut of the rank's
block without the sum, fails the gates by more than 10x.

The collectives' backward: ``torch.autograd.gradcheck`` in float64 of
each collective (the reduce-scatter along dimensions 0 and 1 too) as a
function of the group's whole (replicated) input, on groups of 2 (each
axis of (2, 2)), 4 (both) and 1 (the model axis of (4, 1): the identity
both ways); and the adjoint identity, the sum over the group of
``<C(x), y>`` equal to that of ``<x, C*(y)>``.  A bfloat16
reduce-scatter sums in float32 and rounds once.
"""

import concurrent.futures
import os

import pytest
import torch

import torch_lm_mesh_worker as lw
import torch_mesh_worker as tw
import torch_train_mesh_worker as w
from repro_torch.models.convert import reference_weights, trimmed_rel
from repro_torch.sharding import partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALAR_TOL = 1e-5
LEAF_FLOOR = 1e-5
NOISE_FACTOR = 4.0
NUDGE = 11
FLIP_SHARE = 1e-3
CASES = ([("2x2", a, "step") for a in w.ARCHS] + [("1x3", a, "step") for a in w.ARCHS]
         + [("2x2", "gemma2-2b", "ef"), ("2x2", "gemma2-2b", "accum1")])
KW = {"ef": dict(steps=2, with_ef=True), "accum1": dict(accum=1)}


def _id(case):
    return "-".join(case)


#: The (data, model) meshes and microbatch of the stream checks: 2 rows of 24
#: positions (the encoder's 24 frames too) a microbatch.
STREAM_MESHES = ("2x2", "1x3")
STREAM_CASES = [(m, a) for m in STREAM_MESHES for a in w.ARCHS]


@pytest.fixture(scope="module")
def reference_streams_started(tmp_path_factory):
    """The reference's layout of each case's residual stream
    (``resolve_spec`` under the same mesh), in a JAX subprocess started
    before the groups are spawned."""
    tmp = tmp_path_factory.mktemp("train_mesh_streams")
    keys = sorted({lw.stream_key(m, w.BATCH // w.ACCUM, w.SEQ, w.config(a).d_model)
                   for m, a in STREAM_CASES})
    return tmp, lw.reference_process(tmp, "streams.npz", keys, ROOT)


@pytest.fixture(scope="module")
def reference_streams(ranks, reference_streams_started):
    import numpy as np

    tmp, proc = reference_streams_started
    _, err = proc.communicate(timeout=lw.REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, err
    return dict(np.load(tmp / "streams.npz"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference_streams_started):
    """Each group's ranks' results, by group size (the two groups run at once)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    jobs = {4: "train4", 3: "train3"}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {}
        for n, fn in jobs.items():
            sub = tmp / f"group{n}"
            sub.mkdir()
            futures[n] = pool.submit(tw.spawn, f"torch_train_mesh_worker:{fn}", n, sub)
        return {n: f.result() for n, f in futures.items()}


@pytest.fixture(scope="module")
def single():
    """The one-process runs under each case's abstract mesh, and each
    case's one-ulp noise."""
    out = {}
    for case in CASES + [("2x2", "gemma2-2b", c) for c in w.CONTROLS]:
        mesh, arch, kind = case
        data, model = w.MESHES[mesh]
        kw = KW.get(kind, {})
        with partition.activate({"data": data, "model": model}):
            with lw.mixer_spy().SavedLayerInputs() as saved:
                one = w.train_case(w.config(arch), **kw)
            one["saved_bytes"], one["layers_saved"] = saved.bytes, saved.layers
            if kind not in w.CONTROLS:
                one["noise"] = w.train_case(w.config(arch), nudge=NUDGE, **kw)
        out[case] = one
    return out


def _group(ranks, mesh):
    return ranks[3 if mesh == "1x3" else 4]


def test_every_rank_finished(ranks):
    errors = [r["error"] for group in ranks.values() for r in group if "error" in r]
    assert not errors, errors[0]


def _gates(got, one, cfg):
    """Each quantity's error over its gate (the module's docstring)."""
    start = w.flat_tree(reference_weights(cfg, w.SEED))
    nudged = w.flat_tree(w.nudged(reference_weights(cfg, w.SEED), NUDGE))
    noise = one.get("noise")
    ratios = {}
    for k in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(got[k], one[k])):
            ratios[f"{k}[{i}]"] = abs(a / b - 1.0) / SCALAR_TOL
    for path, p0 in start.items():
        d_one = one["params"][path] - p0
        err = trimmed_rel(got["params"][path] - p0, d_one, FLIP_SHARE)
        tol = LEAF_FLOOR
        if noise is not None:
            tol = max(tol, NOISE_FACTOR * trimmed_rel(noise["params"][path] - nudged[path], d_one,
                                                      FLIP_SHARE))
        ratios[f"delta/{path}"] = err / tol
    return ratios


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_train_step_matches_the_one_process_port(ranks, single, case):
    group = _group(ranks, case[0])
    got, one = group[0][case], single[case]
    assert got["lr"] == one["lr"]
    ratios = _gates(got, one, w.config(case[1]))
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1.0, (worst, ratios[worst])
    # every rank gathers the same parameters and reports the same metrics
    for r in group:
        assert r[case]["digest"] == got["digest"]
        assert r[case]["loss"] == got["loss"] and r[case]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("control", list(w.CONTROLS))
def test_negative_controls_fail_the_gates(ranks, single, control):
    """Seeded with 1, ``grad_norm`` is 4x the one-process run's (Adam's
    update does not see the scale); without the sum over replicated axes
    the norms' and replicated weights' changes miss."""
    case = ("2x2", "gemma2-2b", control)
    got = ranks[4][0][case]
    ratios = _gates(got, single[("2x2", "gemma2-2b", "step")], w.config("gemma2-2b"))
    assert max(ratios.values()) > 10.0
    if control == "control_seed":
        assert abs(got["grad_norm"][0] / single[("2x2", "gemma2-2b", "step")]["grad_norm"][0]
                   - 4.0) < 1e-4


def test_the_1x3_mesh_takes_the_seq_tp_case_and_replicates_by_the_fallback():
    """What (1, 3) exercises, as rank 0 of it sees the plan: attention's
    ``seq_tp`` split of the 24 tokens, and d_model-wide weights whole."""
    from repro_torch.models import Model, attention
    from repro_torch.sharding import collectives as coll

    with partition.activate({"data": 1, "model": 3}, rank=0):
        assert not attention._head_tp(4)
        assert coll.dim_range(w.SEQ, "seq_tp") == (0, w.SEQ // 3, ("model",))
        model = Model(w.config("gemma2-2b"), device="meta")
        assert coll.replicated_axes(model.get_parameter("embed.embedding")) == ("model",)


def test_a_checkpoint_of_2x2_restores_onto_4x1_by_param_shardings(ranks):
    """``save`` on (2, 2) gathers every parameter whole (rank 0 writes one
    step); ``restore(..., shardings=Model.param_shardings())`` on (4, 1)
    gives each rank its slice of every leaf, bit for bit."""
    for rank in ranks[4]:
        got = rank["checkpoint"]
        assert got["files"] == ["LATEST", "step_00000001"]
        assert got["shapes_equal"] and got["bits_equal"] and got["split"] > 0


SSM_CASES = [(m, a) for m in ("2x2", "1x3") for a in w.ARCHS
             if w.config(a).supports_long_context]


@pytest.mark.parametrize("mesh,arch", SSM_CASES, ids=["-".join(c) for c in SSM_CASES])
def test_the_mixer_splits_its_heads_where_the_model_axis_divides_them(ranks, mesh, arch):
    heads, model = w.config(arch).ssm_heads, w.MESHES[mesh][1]
    want = heads // model if heads % model == 0 else heads
    assert (want == heads) == (mesh == "1x3")
    for r, rank in enumerate(_group(ranks, mesh)):
        mixer = rank[(mesh, arch, "mixer")]
        assert mixer["scan_heads"] == [want] and mixer["decode_heads"] == [], (r, mixer)
        assert mixer["whole_leaf_gathers"] == [], (r, mixer)


@pytest.mark.parametrize("mesh,arch", STREAM_CASES, ids=["-".join(c) for c in STREAM_CASES])
def test_the_residual_stream_is_the_reference_s_block(ranks, reference_streams, mesh, arch):
    """At every block boundary of the step (each microbatch's forward and
    remat's recompute) each rank holds its rows and positions of the
    reference's ``resolve_spec((B, S, D), ("batch", "seq_tp", None))``
    under the same mesh, and the step reduce-scatters."""
    data, model = w.MESHES[mesh]
    width = w.config(arch).d_model
    for r, rank in enumerate(_group(ranks, mesh)):
        got = rank[(mesh, arch, "stream")]
        d, m = divmod(r, model)
        assert got["records"] and got["scatters"] > 0, (r, got["scatters"])
        for rec in got["records"]:
            key = lw.stream_key(mesh, w.BATCH // w.ACCUM, rec["positions"], width)
            r0, r1, lo, hi = (int(v) for v in reference_streams[key][d, m])
            assert (rec["rows"], rec["seq"]) == ((r0, r1), (lo, hi)), (r, rec)
            assert rec["shape"][:2] == (r1 - r0, hi - lo), (r, rec)


@pytest.mark.parametrize("mesh,arch", STREAM_CASES, ids=["-".join(c) for c in STREAM_CASES])
def test_the_layer_inputs_saved_are_a_rank_s_block(ranks, single, mesh, arch):
    """The bytes remat keeps at the layer inputs (``saved_tensors_hooks``) are
    1 / (data x model) of one process's: a rank's rows and positions (the
    stream kept whole on the model axis would give 1 / data)."""
    data, model = w.MESHES[mesh]
    one = single[(mesh, arch, "step")]
    assert one["saved_bytes"] > 0 and one["layers_saved"] > 0
    for r, rank in enumerate(_group(ranks, mesh)):
        got = rank[(mesh, arch, "stream")]
        assert got["layers_saved"] == one["layers_saved"], r
        assert got["saved_bytes"] * data * model == one["saved_bytes"], (r, got["saved_bytes"])


def test_a_bf16_reduce_scatter_sums_in_float32(ranks):
    """Each group's bfloat16 reduce-scatter is the float32 sum rounded once;
    on the 4-rank group that differs from the bfloat16 sum in rank order."""
    for r, rank in enumerate(ranks[4]):
        for group in COLLECTIVE_GROUPS:
            got, once, _ = rank["collectives"][group + ("bf16",)]
            assert {v for row in got for v in row} == {once}, (r, group, got)
        _, once, seq = rank["collectives"][("2x2", "data+model", "bf16")]
        assert once != seq, (once, seq)


COLLECTIVE_GROUPS = [("2x2", "model"), ("2x2", "data"), ("2x2", "data+model"), ("4x1", "model")]


@pytest.mark.parametrize("group", COLLECTIVE_GROUPS, ids=["-".join(g) for g in COLLECTIVE_GROUPS])
def test_collectives_backward_passes_gradcheck(ranks, group):
    for r, rank in enumerate(ranks[4]):
        got = rank["collectives"][group + ("gradcheck",)]
        assert got and all(got.values()), (r, got)


@pytest.mark.parametrize("group", COLLECTIVE_GROUPS, ids=["-".join(g) for g in COLLECTIVE_GROUPS])
def test_collectives_backward_is_the_adjoint(ranks, group):
    for rank in ranks[4]:
        for name, (lhs, rhs) in rank["collectives"][group + ("adjoint",)].items():
            assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs)), (name, lhs, rhs)


def test_max_takes_no_gradient_and_one_rank_is_the_identity(ranks):
    for r, rank in enumerate(ranks[4]):
        col = rank["collectives"]
        for group in COLLECTIVE_GROUPS[:3]:
            values, requires_grad = col[group + ("max",)]
            assert not requires_grad
        assert col[("2x2", "data+model", "max")][0] == [3.0] * 3
        same, grad = col[("4x1", "model", "identity")]
        assert same and grad == [1.0] * 3


def _loss_and_grads_off_thread(arch, mesh, rank=None, device="cpu"):
    """The train step's loss built under ``mesh`` on this thread, its
    gradients taken on another thread while the mesh is active (the
    autograd engine runs a CUDA backward on a thread of its own): remat's
    recomputation and the collectives' backward must see the mesh there."""
    import threading

    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params
    from repro_torch.train.train_step import make_loss_fn

    cfg = w.config(arch)
    batch = w.batch_of(cfg, 0, device=device)
    box = {}

    def backward():
        try:
            box["grads"] = torch.autograd.grad(loss, params)
        except Exception as exc:  # the test reads it
            box["error"] = exc

    with partition.activate(mesh, rank=rank):
        model = Model(cfg, device=device)
        if device == "cpu":
            load_reference_params(model, reference_weights(cfg, w.SEED))
        params = list(model.parameters())
        loss = make_loss_fn(model, remat=True)(batch)
        here = torch.autograd.grad(loss, params, retain_graph=True) if device == "cpu" else None
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    assert "error" not in box, repr(box.get("error"))
    return here, box["grads"]


def test_the_backward_runs_under_the_forward_mesh_context_on_another_thread():
    """deepseek (MoE: its token groups follow the mesh's batch axes) under
    the abstract (2, 2) mesh: gradients taken on another thread are the
    bits of those taken on the forward's thread."""
    here, there = _loss_and_grads_off_thread("deepseek-v2-lite-16b", {"data": 2, "model": 2})
    assert all(torch.equal(a, b) for a, b in zip(here, there))


def test_a_planned_rank_s_backward_runs_on_another_thread():
    """Rank 0 of a planned (2, 2) mesh on the meta device: the collectives'
    backward (reduce-scatters, all-reduces) runs on another thread."""
    _, there = _loss_and_grads_off_thread("gemma2-2b", {"data": 2, "model": 2}, rank=0,
                                          device="meta")
    assert all(g.device.type == "meta" for g in there)
