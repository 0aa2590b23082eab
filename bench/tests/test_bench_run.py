"""A whole run rehearsed on the CPU, and the same run with its timed path broken.

The harness's look for a card is skipped (``execute(..., device="cpu")``
runs the port's plain versions); the configurations are cut to a size
a test holds.  Each fault that a one-card LP cell can have must make
``correct`` come out false: a solve that leaves its state unchanged
(no pivots), half of the batch left out (the other half's answers in
its place), and an answer altered where it is produced.  An exchange
between cards does not exist on one card.
"""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from bench import harness

SEED = 2**31 + 77


def tiny(name):
    cell = harness.load_cell(name)
    m = 2 * 12 if cell.config["generator"] == "paper_type2" else 12
    return dataclasses.replace(
        cell, config=dict(cell.config, m=m, n=12),
        file=dict(cell.file, params=dict(cell.file["params"], lps_per_call=8, pool=2), sample=12))


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", ["type1.batch50k", "type2.batch10k", "type1.shared50k"])
def test_a_sound_run_is_correct(name, trace):
    cell = tiny(name)
    result = harness.execute(cell, SEED, 0.2, trace, device="cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(cell.file["limits"])
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    json.dumps(result, allow_nan=False)


def test_the_keeper_grows_past_its_estimate():
    from repro_torch import LPSolution

    sols = [LPSolution(objective=torch.full((3,), float(k)), x=torch.full((3, 2), float(k)),
                       status=torch.ones(3, dtype=torch.int32),
                       iterations=torch.full((3,), k, dtype=torch.int32)) for k in range(5)]
    keeper = harness.Keeper(sols[0], 2)
    kept = [keeper.keep(s) for s in sols]
    assert keeper.capacity >= 5 and len(keeper.slabs) > 1
    assert all(t.untyped_storage().data_ptr() != sols[0].x.untyped_storage().data_ptr()
               for t in keeper.tensors())
    for k, answers in enumerate(kept):
        assert torch.equal(answers.x, sols[k].x) and int(answers.iterations[0]) == k


def _half(out):
    obj, x, status, iters = (t.clone() for t in out)
    half = obj.shape[0] // 2
    for t in (obj, x, status, iters):
        t[half:2 * half] = t[:half].clone()
    return obj, x, status, iters


def _altered(out):
    obj, x, status, iters = (t.clone() for t in out)
    x[0] = x[0] * 1.01 + 0.01
    return obj, x, status, iters


def broken(real, fault, cap_at):
    def kernel(*args, **kw):
        if fault == "unchanged":
            args = args[:cap_at] + (0,) + args[cap_at + 1:]
            return real(*args, **kw)
        out = real(*args, **kw)
        return _half(out) if fault == "half" else _altered(out)
    return kernel


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["type1.batch50k", "type2.batch10k", "type1.shared50k"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from repro_torch.kernels import revised_cuda, simplex_cuda

    if name == "type1.shared50k":
        monkeypatch.setattr(revised_cuda, "revised", broken(revised_cuda.revised, fault, 8))
    else:
        monkeypatch.setattr(simplex_cuda, "simplex", broken(simplex_cuda.simplex, fault, 5))
    result = harness.execute(tiny(name), SEED, 0.2, False, device="cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                          "type2.batch10k", "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
