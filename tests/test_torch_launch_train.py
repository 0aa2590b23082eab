"""The port's training launcher (``python -m repro_torch.launch.train``)
and ``examples/torch_train_lm.py`` on the CPU: a reduced mamba2 run with
checkpoints, a run preempted and resumed that ends on the same bits as
the uninterrupted one, and the multi-device flag that waits for its
slice."""

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


def test_model_axis_above_one_waits_for_the_multi_device_slice(tmp_path):
    with pytest.raises(NotImplementedError, match="6.5"):
        train.main([*ARGS, "--ckpt", str(tmp_path), "--model-axis", "2"])


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
