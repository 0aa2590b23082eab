"""The port's LM serve path over a device mesh: the SSM, hybrid,
encoder-decoder and M-RoPE families (reduced mamba2-130m, zamba2-7b,
seamless-m4t-large-v2 and qwen2-vl-72b).

One gloo group of 8 ranks on the CPU runs each family under the meshes
``(data, model)`` (4, 2), (2, 4), (8, 1) and (1, 8), as
``tests/test_torch_lm_mesh.py`` runs the dense and MoE families (the
same worker, inputs and gates): 8 prompts of 32 tokens with the
encoder's 16 frames, the vision prefix's patch embeddings and M-RoPE
positions whose coordinates differ; the prefill and two fed decode
steps against the reference under the same mesh and the one-process
port under the abstract mesh (for reduced zamba2 and seamless within
the noise rule of ``tests/test_torch_models.py:_gate``: 4 times the
meshless reference's own one-ulp noise on the case, where that is the
larger); ``Engine.generate``'s greedy tokens equal
on every rank; every parameter and cache leaf (the mamba ``conv`` leaf
split over channels, its ``state`` over heads, the decoder's cross
caches over encoder positions) of its placements' shape.

The head-split mixer (``models/mamba2.py:mamba_mixer``): on every rank
of every mesh, each SSD scan and decode step of mamba2 and zamba2 runs
``ssm_heads / model`` heads (``tools/mixer_spy.py:MixerSpy``), and no
model-axis all-gather inside a mixer has the input shape of
``in_proj``'s, ``out_proj``'s or the state cache's gather before the
split (``mixer_spy.mixer_parent_gathers``).  The negative control, mamba2 on
(2, 4) with the gated RMSNorm's sum of squares left to each rank's
heads, misses the reference under the same mesh by the same gate.

The residual stream, as ``tests/test_torch_lm_mesh.py`` holds it: every
block boundary of the prefill (seamless's encoder over its 16 frames
too) is the rank's block of the reference's ``resolve_spec`` with the
one-process run's values; every decode step's stream is whole.
"""

import os

import pytest
import torch

import torch_lm_mesh_worker as lw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHICH = "families"
MESHES = ["4x2", "2x4", "8x1", "1x8"]
CASES = [(m, a, r, lw.BATCH) for m in MESHES for a, r in lw.ARCHS[WHICH]]
NOISE_KEYS = [f"noise|{a}|{r}|{lw.BATCH}" for a, r in lw.ARCHS[WHICH] if a in lw.NOISY]


def _key(case):
    return lw.case_key(*case)


def _ids(cases):
    return [_key(c).replace("|", "-") for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh_families")
    return lw.run_all(tmp, WHICH, (8,), NOISE_KEYS + [_key(c) for c in CASES]
                      + lw.stream_keys(MESHES, CASES), ROOT)


def _noise(runs, case):
    """The case's gate noise: the reference's own, for the ill-conditioned
    reduced zamba2 and seamless (``lw.NOISY``)."""
    key = f"noise|{case[1]}|{case[2]}|{case[3]}"
    return tuple(runs[2][key]) if key in runs[2] else (0.0, 0.0)


@pytest.fixture(scope="module")
def single(runs):
    return {_key(c): lw.one_process(runs[0], _key(c)) for c in CASES}


def test_every_rank_finished(runs):
    errors = [r["error"] for r in runs[1][8] if "error" in r]
    assert not errors, errors[0]


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_logits_match_the_reference_under_the_same_mesh(runs, case):
    ok, err, bound, rel = lw.gate(lw.whole_logits(runs[1][8], case), runs[2][_key(case)],
                                  _noise(runs, case))
    assert ok, (err, bound, rel)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_logits_and_tokens_match_the_one_process_port(runs, single, case):
    one = single[_key(case)]
    ok, err, bound, rel = lw.gate(lw.whole_logits(runs[1][8], case), one["logits"].numpy(),
                                  _noise(runs, case))
    assert ok, (err, bound, rel)
    for r, rank in enumerate(runs[1][8]):
        assert torch.equal(rank[_key(case)]["tokens"], one["tokens"]), r


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_each_rank_stores_its_placements_slice(runs, case):
    lw.check_local_shapes(runs[1][8], case, enc_len=16)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_the_residual_stream_is_the_reference_s_block(runs, single, case):
    """As ``tests/test_torch_lm_mesh.py`` holds it: every block boundary of
    the prefill (seamless's encoder over its 16 frames too) is the rank's
    block of the reference's ``resolve_spec``, with the one-process run's
    values there; every decode step's stream is whole and makes no
    reduce-scatter."""
    mesh = case[0]
    errors = lw.stream_errors(runs[1][8], mesh, _key(case), runs[2],
                              lw.config(*case[1:3]).d_model, single[_key(case)])
    assert not errors, errors[:3]
    for r, rank in enumerate(runs[1][8]):
        assert bool(rank[_key(case)]["stream"][0]["scatters"]) == (lw.MESHES[mesh][1] > 1), r


SSM_CASES = [c for c in CASES if lw.config(c[1], c[2]).supports_long_context]


@pytest.mark.parametrize("case", SSM_CASES, ids=_ids(SSM_CASES))
def test_each_rank_scans_its_heads_and_gathers_no_whole_leaf(runs, case):
    model = lw.MESHES[case[0]][1]
    heads = lw.config(case[1], case[2]).ssm_heads // model
    for r, rank in enumerate(runs[1][8]):
        mixer = rank[_key(case)]["mixer"]
        step = mixer["step"]  # mixer_spy.lm_mesh_mixer_step: a prefill, one decode step
        for got in (mixer, step):
            assert got["scan_heads"] == [heads] and got["decode_heads"] == [heads], (r, got)
            assert got["whole_leaf_gathers"] == [], (r, got)
        mine, parent = (step["decode_mixer_model_gather_bytes"],
                        step["parent_decode_mixer_model_gather_bytes"])
        assert (0 < mine < parent) if model > 1 else (mine == parent == 0), (r, step)


def test_the_mixer_without_the_norm_s_sum_misses_the_reference(runs):
    case = (lw.CONTROL_MESH, lw.CONTROL_ARCH, "topk", lw.BATCH)
    control = lw.whole_logits(runs[1][8], case, key=lw.control_key())
    ok, err, bound, rel = lw.gate(control, runs[2][_key(case)])
    assert not ok and err > 10 * bound, (err, bound, rel)
