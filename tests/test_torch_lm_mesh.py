"""The port's LM serve path over a device mesh: the dense and MoE families.

Gloo groups of 8 and 4 ranks are spawned on the CPU
(``tests/torch_lm_mesh_worker.py``, each group with its own
``FileStore`` and timeout); every rank builds reduced gemma2-2b,
qwen1.5-4b, deepseek-v2-lite-16b (``topk`` and ``lp``) and dbrx-132b
under each mesh from the same NumPy weights, storing only its slice of
every parameter and cache leaf, and runs the prefill and two fed decode
steps on the whole batch (8 prompts of 32 tokens) and
``Engine.generate``.  Meshes ``(data, model)``: (4, 2), (2, 4), (8, 1)
and (1, 8) on 8 ranks, (2, 2) and (4, 1) on 4, the latter also with 6
prompts (the batch axis does not divide them: the batch is replicated
and the MoE token groups straddle sequences).  On (1, 8) the 4 heads
do not split, and attention takes the reference's ``seq_tp`` case.

Held against:

* the reference (``repro.models.Model``) under the same mesh, jitted, in
  JAX subprocesses with 8 forced host devices and ``Auto``-typed axes
  (its MoE token groups follow the mesh's batch axes, so its function
  changes with the mesh): the batch's logits, put together from the
  ranks' rows (ranks that run the same rows hold the same bits), within
  the LM CPU gates (relative L2 <= 1e-5, max abs <= 2e-5 x the largest
  magnitude, ``tests/test_torch_models.py``);
* the one-process port under the abstract mesh of the same shape (which
  runs the same token groups): the same gates, and ``Engine``'s greedy
  tokens equal on every rank;
* ``partition.local_slices``: every parameter and cache leaf a rank
  stores has the shape of its placements' slice.

Under ``router="lp"`` every rank solves the same router LPs, bit for bit
(a digest of each LP and its solution).  Reduced gemma2-2b and deepseek
(``lp``) also run in bfloat16 on (2, 2), where the split's sums round
otherwise than one process's: their logits lie within
``chip_smoke.py``'s bfloat16 gate (``LM_BF16_FACTOR`` times the
one-process bfloat16 run's own gap from the float32 run).  The
negative control: the one-process port forced to one token group misses
the reference under (4, 2) by far more than the gate.  The collectives themselves run on
the 4-rank group.

The residual stream (``tools/mixer_spy.py:ResidualSpy``): at every
block boundary of the prefill each rank holds its rows and positions of
the reference's ``resolve_spec((B, S, D), ("batch", "seq_tp", None))``
under the same mesh (laid out by the JAX subprocess), with the
one-process run's values there (float64 sums over the width within
``STREAM_TOL``); every decode step's stream is whole and makes no
reduce-scatter; on (2, 2) a prompt of 31 tokens, which the model axis
does not divide, keeps the stream whole.
"""

import os

import pytest
import torch

import torch_lm_mesh_worker as lw
import torch_mesh_worker as tw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHICH = "core"
MESH8 = ["4x2", "2x4", "8x1", "1x8"]
MESH4 = ["2x2", "4x1"]
CASES = ([(m, a, r, lw.BATCH) for m in MESH8 + MESH4 for a, r in lw.ARCHS[WHICH]]
         + [("4x1", a, r, lw.ODD_BATCH) for a, r in lw.ARCHS[WHICH]])
#: The cases the reference also runs: every case on the 8-rank meshes,
#: the odd batch of the MoE configs and gemma2, and deepseek under lp on (2, 2).
REFERENCE_CASES = ([(m, a, r, lw.BATCH) for m in MESH8 for a, r in lw.ARCHS[WHICH]]
                   + [("4x1", a, r, lw.ODD_BATCH) for a, r in lw.ARCHS[WHICH]
                      if a != "qwen1.5-4b"]
                   + [("2x2", "deepseek-v2-lite-16b", "lp", lw.BATCH)])
#: The fixture tool's mesh mode on reduced deepseek under lp, (2, 2).
FIXTURE_KEY = f"fixture|deepseek-v2-lite-16b|lp|{lw.BATCH}"


def _key(case):
    return lw.case_key(*case)


def _ids(cases):
    return [_key(c).replace("|", "-") for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    arr, ranks, ref = lw.run_all(tmp, WHICH, (8, 4),
                                 [FIXTURE_KEY] + [_key(c) for c in REFERENCE_CASES]
                                 + lw.stream_keys(MESH8 + MESH4, CASES), ROOT)
    return arr, ranks, ref


def _ranks(runs, mesh):
    return runs[1][8 if mesh in MESH8 else 4]


def test_every_rank_finished(runs):
    errors = [r["error"] for group in runs[1].values() for r in group if "error" in r]
    assert not errors, errors[0]


@pytest.fixture(scope="module")
def single(runs):
    """The one-process port under each case's abstract mesh, by key."""
    return {_key(c): lw.one_process(runs[0], _key(c)) for c in CASES}


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=_ids(REFERENCE_CASES))
def test_logits_match_the_reference_under_the_same_mesh(runs, case):
    ok, err, bound, rel = lw.gate(lw.whole_logits(_ranks(runs, case[0]), case), runs[2][_key(case)])
    assert ok, (err, bound, rel)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_logits_and_tokens_match_the_one_process_port(runs, single, case):
    one = single[_key(case)]
    ok, err, bound, rel = lw.gate(lw.whole_logits(_ranks(runs, case[0]), case), one["logits"].numpy())
    assert ok, (err, bound, rel)
    for r, rank in enumerate(_ranks(runs, case[0])):
        got = rank[_key(case)]
        assert torch.equal(got["tokens"], one["tokens"]), r
        assert got["tokens"].shape == (case[3], lw.GEN_STEPS)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_each_rank_stores_its_placements_slice(runs, case):
    lw.check_local_shapes(_ranks(runs, case[0]), case)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_the_residual_stream_is_the_reference_s_block(runs, single, case):
    """At every block boundary of the prefill each rank holds its rows and
    positions of the reference's ``resolve_spec((B, S, D), ("batch",
    "seq_tp", None))`` under the same mesh (from the JAX subprocess), with
    the one-process run's values there; every decode step's stream is
    whole and makes no reduce-scatter; the prefill reduce-scatters where
    the model axis cuts the stream."""
    mesh = case[0]
    ranks = _ranks(runs, mesh)
    errors = lw.stream_errors(ranks, mesh, _key(case), runs[2], lw.config(*case[1:3]).d_model,
                              single[_key(case)])
    assert not errors, errors[:3]
    for r, rank in enumerate(ranks):
        assert bool(rank[_key(case)]["stream"][0]["scatters"]) == (lw.MESHES[mesh][1] > 1), r


def test_a_prompt_the_model_axis_does_not_divide_keeps_the_stream_whole(runs):
    """gemma2's prefill of 31 tokens on (2, 2): every rank holds every
    position (the reference's ``resolve_spec`` drops the model axis), no
    sum is reduce-scattered, and the logits meet the one-process run's."""
    from repro_torch.sharding import partition

    mesh, key = lw.ODD_PROMPT_MESH, lw.odd_prompt_key()
    ranks = _ranks(runs, mesh)
    tokens, _ = lw.inputs_of(runs[0], lw.ODD_PROMPT_ARCH, "topk", lw.BATCH)
    cfg = lw.config(lw.ODD_PROMPT_ARCH, "topk")
    data, model = lw.MESHES[mesh]
    with partition.activate({"data": data, "model": model}):
        one = lw.stream_case(cfg, tokens, lw.ODD_PROMPT)
    assert not lw.stream_errors(ranks, mesh, key, runs[2], cfg.d_model, one)
    for rank in ranks:
        prefill = rank[key]["stream"][0]
        assert {rec["seq"] for rec in prefill["records"]} == {(0, lw.ODD_PROMPT)}
        assert prefill["scatters"] == []
    case = (mesh, lw.ODD_PROMPT_ARCH, "topk", lw.BATCH)
    ok, err, bound, rel = lw.gate(lw.whole_logits(ranks, case, key=key), one["logits"].numpy())
    assert ok, (err, bound, rel)


@pytest.mark.parametrize("mesh", MESH8 + MESH4)
def test_router_lps_are_the_same_bits_on_every_rank(runs, mesh):
    key = lw.case_key(mesh, "deepseek-v2-lite-16b", "lp")
    calls = [rank[key]["lps"] for rank in _ranks(runs, mesh)]
    # one LP a MoE layer a call: the prefill and two decode steps
    assert len(calls[0]) == 3 * (lw.config("deepseek-v2-lite-16b", "lp").num_layers - 1)
    assert all(c == calls[0] for c in calls)


@pytest.fixture(scope="module")
def smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch, router", lw.BF16_ARCHS)
def test_bf16_split_stays_within_the_bf16_gap(runs, single, smoke, arch, router):
    """bfloat16 on (2, 2): the ranks' fed logits (the model ranks of a row
    block holding the same bits) against the one-process float32 run are
    within ``LM_BF16_FACTOR`` times the one-process bfloat16 run's own
    relative L2 from it; tokens are not compared (near ties flip)."""
    import numpy as np

    key = lw.case_key(lw.BF16_MESH, arch, router)
    f32 = single[key]["logits"].numpy().astype(np.float64)
    one16 = lw.one_process(runs[0], key, dtype="bfloat16")["logits"].numpy()
    split16 = lw.whole_logits(_ranks(runs, lw.BF16_MESH), (lw.BF16_MESH, arch, router, lw.BATCH),
                              key=lw.bf16_key(arch, router))

    def rel(x):
        return float(np.linalg.norm(x - f32) / np.linalg.norm(f32))

    own, got = rel(one16), rel(split16)
    # the one-process bfloat16 run itself stays near float32 (about 6% on
    # these reduced configs), so a gate against it cannot pass vacuously
    assert 0 < own < 0.1, own
    assert got <= smoke.LM_BF16_FACTOR * own, (got, own)


def test_one_token_group_misses_the_reference(runs):
    """The negative control: under (4, 2) the reference's MoE layers cut the
    batch into 4 token groups, which drop other tokens than one group."""
    arr, _, ref = runs
    key = lw.case_key("4x2", "deepseek-v2-lite-16b", "topk")
    forced = lw.one_process(arr, key, g_one=True)
    ok, err, bound, rel = lw.gate(forced["logits"].numpy(), ref[key])
    assert not ok and rel > 100 * lw.RTOL, (err, bound, rel)
    right = lw.one_process(arr, key)
    assert lw.gate(right["logits"].numpy(), ref[key])[0]


def test_collectives_over_named_axes(tmp_path):
    """``sharding/collectives.py`` on a (2, 2) mesh: sums and maxima over each
    axis and both, gathers in rank order, the all-to-all."""
    outs = tw.spawn("torch_lm_mesh_worker:collectives", 4, tmp_path)
    assert all("error" not in o for o in outs), [o.get("error") for o in outs]
    for r, o in enumerate(outs):
        d, m = divmod(r, 2)
        assert o["sum_model"].tolist() == [float(2 * d) * 2 + 1] * 3
        assert o["sum_data"].tolist() == [float(m) * 2 + 2] * 3
        assert o["max_all"].tolist() == [3.0] * 3
        assert o["gather_model"].tolist() == [[2 * d, 2 * d + 1]]
        assert o["gather_all"].tolist() == [0, 1, 2, 3]
        # rank (d, m) sent block j of its row [4r .. 4r+3] to model rank j
        assert o["to_all"].tolist() == [4 * (2 * d) + 2 * m, 4 * (2 * d) + 2 * m + 1,
                                        4 * (2 * d + 1) + 2 * m, 4 * (2 * d + 1) + 2 * m + 1]


def test_the_mesh_fixture_holds_the_one_process_port(runs, smoke):
    """``tools/lm_reference_fixture.py --mesh 2,2`` on reduced deepseek under
    ``lp``: the port under the abstract (2, 2) mesh meets the fixture by
    ``chip_smoke.py``'s own checks (the logits within ``lm_tolerances``,
    its router LPs against the fixture's, which the tool captures by
    unordered callbacks, in order), and the port with one token group
    does not (the fixture's groups drop tokens)."""
    import dataclasses

    from repro_torch.kernels import simplex_cuda
    from repro_torch.models import Model, moe
    from repro_torch.models.convert import (fixture_view, load_reference_params,
                                            reference_weights)
    from repro_torch.sharding import partition

    prefix = FIXTURE_KEY + "|"
    view = fixture_view({k[len(prefix):]: v for k, v in runs[2].items()
                         if k.startswith(prefix)}, "lp")
    cfg = dataclasses.replace(lw.config("deepseek-v2-lite-16b", "lp"), dtype="float32")
    model = load_reference_params(Model(cfg, device="cpu"),
                                  reference_weights(cfg, int(view["seed"])))
    with partition.activate({"data": 2, "model": 2}):
        with smoke.SimplexSpy(simplex_cuda) as spy:
            logits = smoke.lm_fixture_logits(model, view)
        assert smoke.lm_mesh_fixture_check(logits, view)["ok"]
        lps = smoke.router_lp_checks(view, spy.records, torch.device("cpu"), cfg.router_groups)
        assert lps["ok"] and lps["port_basis_equal"] == lps["port_lps"], lps
        moe.partition = lw._OneGroup(partition)
        try:
            one_group = smoke.lm_fixture_logits(model, view)
        finally:
            moe.partition = partition
    assert not smoke.lm_mesh_fixture_check(one_group, view)["ok"]
