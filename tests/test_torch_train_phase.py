"""A CPU rehearsal of ``chip_smoke.py``'s slice-12 phase (``lm_train_phase``)
on reduced configs, with the card's clock and memory calls stubbed: the
fixture tool's reduced training and eval fixtures (``--train``,
``--eval``) through ``lm_train_reference``, ``lm_train``,
``lm_train_ssm`` and ``lm_eval_lp``; the simplex kernel's wrapper counts
its calls as launches (off the card it runs the plain version, which
counts none).  Then the
training gates against runs with faults planted, and the committed
fixtures' shapes."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lm_serve import ROOT, _module, _ReducedConfigs, _stub_the_card

TRAIN_FIXTURE = ROOT / "tests" / "data" / "lm_train_gemma2_2b_reference.npz"
EVAL_FIXTURE = ROOT / "tests" / "data" / "lm_eval_deepseek_v2_lite_reference.npz"


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    tool = _module("lm_reference_fixture", ROOT / "tools" / "lm_reference_fixture.py")
    out = tmp_path_factory.mktemp("fixtures")
    train = tool.build_train_fixture("gemma2-2b", reduced=True, layers=0, seq=32)
    evl = tool.build_eval_fixture("deepseek-v2-lite-16b", reduced=True, layers=0, seq=24)
    np.savez(out / "train.npz", **train)
    np.savez(out / "eval.npz", **evl)
    return out / "train.npz", out / "eval.npz"


def _counters(monkeypatch):
    from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda

    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}
    wrapper = simplex_cuda.simplex

    def counted(*args, **kw):  # the wrapper's calls, not the replays on the plain version
        simplex_cuda.launches += 1
        simplex_cuda.variant_launches["cluster"] += 1
        return wrapper(*args, **kw)

    monkeypatch.setattr(simplex_cuda, "simplex", counted)

    def reset():
        for mod in counters.values():
            mod.launches = 0
            for v in getattr(mod, "variant_launches", {}):
                mod.variant_launches[v] = 0

    return counters, reset


def test_chip_smoke_train_phase_on_reduced_fixtures(monkeypatch, fixtures, capsys):
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    _stub_the_card(monkeypatch, smoke)
    train, evl = fixtures
    for name, value in (("LM_TRAIN_FIXTURE", Path(train)), ("LM_EVAL_FIXTURE", Path(evl)),
                        ("LM_TRAIN_SEQ", 32), ("LM_TRAIN_TIMED", 2), ("LM_SSM_TRAIN_BATCH", 2),
                        ("LM_SSM_TRAIN_STEPS", 4)):
        monkeypatch.setattr(smoke, name, value)
    counters, reset = _counters(monkeypatch)
    out = smoke.lm_train_phase(_ReducedConfigs(), torch.device("cpu"), seed=0,
                               counters=counters, reset=reset)
    assert out["reference"]["ok"] and out["reference"]["lr_equal"]
    assert out["reference"]["worst_ratio"] <= 1.0
    res = out["train"]
    assert len(res["loss"]) == 3 and all(np.isfinite(res["loss"]))
    assert res["bound_ms"] > 0 and res["flops_f32"] > 0 and res["update_bytes"] > 0
    ssm = out["ssm"]
    assert ssm["resumed_from"] == 2 and ssm["resumed_steps"] == [2, 3]
    assert ssm["params_bit_equal"] == ssm["params"] and ssm["opt_state_bit_equal"]
    assert ssm["resumed_loss"] == ssm["loss"][2:]
    assert [w["step"] for w in ssm["checkpoint_writes"]] == [2, 4, 4]  # the end saves again
    assert all(w["bytes"] > 0 for w in ssm["checkpoint_writes"])
    ev = out["eval"]
    assert ev["ok"] and ev["router_lps"] == ev["simplex_launches"] == 2
    assert ev["captured_bit_identical"] == 2
    assert out["launches"]["simplex"] == 2 and not out["launches"]["pdhg"]
    lines = capsys.readouterr().out
    for phase in ("lm_train_reference", "lm_train_setup", '"lm_train"', "lm_train_ssm",
                  "lm_eval_lp", "slice12_train"):
        assert phase in lines, phase


def test_train_gates_reject_planted_faults(monkeypatch, fixtures):
    """The fixture's own run passes its gates; the same run with each
    leaf's change scaled by 1 + 1e-2, with the first step's loss moved by
    1e-4, or with another lr, fails them."""
    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    fx = dict(np.load(fixtures[0]))
    run = dict(loss=list(fx["loss"]), grad_norm=list(fx["grad_norm"]), lr=list(fx["lr_steps"]),
               delta=fx["delta"].copy())
    assert smoke.lm_train_gates(run, fx)["ok"]
    assert not smoke.lm_train_gates(dict(run, delta=run["delta"] * (1 + 1e-2)), fx)["ok"]
    loss = list(run["loss"])
    loss[0] *= 1 + 1e-4
    assert not smoke.lm_train_gates(dict(run, loss=loss), fx)["ok"]
    assert not smoke.lm_train_gates(dict(run, lr=[2 * x for x in run["lr"]]), fx)["ok"]


def test_train_run_with_a_wrong_gold_logit_fails_the_gates(monkeypatch, fixtures):
    """A fault in the port's loss (the gold logit taken one id off) fails
    ``lm_train_reference``."""
    from repro_torch.train import train_step

    smoke = _module("chip_smoke", ROOT / "chip_smoke.py")
    _stub_the_card(monkeypatch, smoke)
    monkeypatch.setattr(smoke, "LM_TRAIN_FIXTURE", Path(fixtures[0]))
    orig = train_step._chunk_ce

    def off_by_one(model, h, labels):
        return orig(model, h, torch.where(labels >= 0, (labels + 1) % model.cfg.vocab_size, labels))

    monkeypatch.setattr(train_step, "_chunk_ce", off_by_one)
    with pytest.raises(SystemExit, match="lm_train_reference"):
        smoke.lm_train_reference_case(_ReducedConfigs(), torch.device("cpu"))


def test_committed_training_fixtures():
    """The fixtures ``chip_smoke.py`` reads: gemma2-2b at full width cut to
    2 layers, three steps, a sample of every leaf's change; deepseek's eval
    loss with its two router LPs."""
    fx = np.load(TRAIN_FIXTURE)
    assert str(fx["kind"]) == "train" and str(fx["arch"]) == "gemma2-2b"
    assert int(fx["layers"]) == 2 and int(fx["steps"]) == 3 and fx["loss"].shape == (3,)
    assert fx["delta"].shape == fx["f64_delta"].shape == fx["sample_idx"].shape
    assert int(fx["sample_sizes"].sum()) == fx["sample_idx"].size
    assert np.all(np.isfinite(fx["loss"])) and np.all(fx["noise_delta"] >= 0)
    ev = np.load(EVAL_FIXTURE)
    assert str(ev["kind"]) == "eval" and str(ev["router"]) == "lp" and int(ev["layers"]) == 3
    assert int(ev["router_lps"]) == 2 and np.isfinite(float(ev["loss"]))
