"""The port's training launcher (``python -m repro_torch.launch.train``)
and ``examples/torch_train_lm.py`` on the CPU: a reduced mamba2 run with
checkpoints, a run preempted and resumed that ends on the same bits as
the uninterrupted one, and ``--model-axis 2`` on 4 gloo ranks under
``torchrun`` (a (2, 2) mesh), whose checkpoints hold whole leaves that
the reference's ``restore`` reads as the port's does."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import train
from repro_torch.runtime.fault import Preemption

ROOT = Path(__file__).resolve().parent.parent
ARGS = ["--device", "cpu", "--arch", "mamba2-130m", "--reduced", "--seq", "64", "--batch", "4",
        "--steps", "6", "--ckpt-every", "2"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _arrays(ckpt_dir, step):
    with np.load(Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def test_launcher_trains_and_resumes_to_the_same_bits(tmp_path):
    full = tmp_path / "full"
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *ARGS,
                          "--ckpt", str(full)], capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: final loss" in out.stdout and "step     0 loss" in out.stdout
    assert (full / "LATEST").read_text() == "step_00000006"

    part = tmp_path / "part"
    with pytest.raises(Preemption):
        train.main([*ARGS, "--ckpt", str(part), "--preempt-at", "3"])
    assert (part / "LATEST").read_text() == "step_00000002"
    hist = train.main([*ARGS, "--ckpt", str(part)])  # the identical command resumes
    assert hist[0][0] == 2
    want, got = _arrays(full, 6), _arrays(part, 6)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_model_axis_two_trains_on_four_gloo_ranks_and_writes_whole_leaves(tmp_path):
    """``--model-axis 2`` on 4 gloo ranks (torchrun, ``--device cpu``): the
    ranks train on a (2, 2) mesh, rank 0 logs, and the checkpoints hold
    whole leaves, in the reference's layout: the reference's ``restore``
    and the port's read the same bits, and the first step's loss is the
    meshless run's within float32 rounding."""
    import jax
    import jax.numpy as jnp

    from repro.ckpt import checkpoint as rckpt
    from repro_torch.ckpt import checkpoint as ckpt

    ranks = tmp_path / "ranks"
    env = {**_env(), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *ARGS,
                          "--ckpt", str(ranks), "--model-axis", "2"],
                         capture_output=True, text=True, env=env, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("done: final loss") == 1  # rank 0 alone logs
    assert (ranks / "LATEST").read_text() == "step_00000006"
    alone = train.main([*ARGS, "--ckpt", str(tmp_path / "alone"), "--steps", "1"])
    first = float(next(line.split()[3] for line in out.stdout.splitlines()
                       if line.startswith("step     0")))
    assert abs(first / alone[0][1]["loss"] - 1.0) < 1e-5
    got = _arrays(ranks, 6)
    like = {f"a{i}": np.zeros(a.shape, a.dtype) for i, a in enumerate(got.values())}
    mine = ckpt.restore(str(ranks), [like[k] for k in sorted(like, key=lambda k: int(k[1:]))])
    theirs = rckpt.restore(str(ranks), [jax.ShapeDtypeStruct(a.shape, jnp.dtype(a.dtype))
                                         for a in got.values()])
    for a, t, r in zip(got.values(), mine, theirs):
        np.testing.assert_array_equal(t.numpy(), a)
        np.testing.assert_array_equal(np.asarray(r), a)


def test_example_trains_on_the_cpu(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
                          "--device", "cpu", "--steps", "12", "--seq", "32", "--batch", "4",
                          "--ckpt", str(tmp_path)], capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))  # steps 0 and 9
    assert losses[1] < losses[0]
    assert (tmp_path / "LATEST").read_text() == "step_00000012"
