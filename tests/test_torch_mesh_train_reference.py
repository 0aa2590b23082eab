"""The counterpart of the reference's own
``tests/test_distributed.py::test_sharded_train_step_matches_single_device``:
reduced qwen1.5-4b, one train step of 8 x 32 tokens (``accum=2``, remat)
on a (data, model) = (2, 4) mesh, the port on 8 spawned gloo ranks
against the reference's jitted step under an ``Auto``-typed (2, 4) mesh
of 8 forced host devices, in a JAX subprocess that runs beside them,
from the same NumPy weights and batch.

The loss and ``grad_norm`` within ``SCALAR_TOL`` of the reference's,
``lr`` equal, and each parameter leaf's change within ``trimmed_rel``'s
gate (the largest of ``LEAF_FLOOR`` and ``NOISE_FACTOR`` times the
one-process port's change when every weight moves one ulp); the
reference's own test asks 1e-3 and 5e-3.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_worker as tw
import torch_train_mesh_worker as w
from repro_torch.models.convert import reference_weights, trimmed_rel
from repro_torch.sharding import partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALAR_TOL = 1e-5
LEAF_FLOOR = 1e-5
NOISE_FACTOR = 4.0
NUDGE = 11


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qwen_mesh")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"), here])}
    ref_path = tmp / "reference.npz"
    proc = subprocess.Popen([sys.executable, "-c", w.REFERENCE, str(ref_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        sub = tmp / "group8"
        sub.mkdir()
        ranks = tw.spawn("torch_train_mesh_worker:qwen8", 8, sub)
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return ranks, dict(np.load(ref_path))


def test_every_rank_finished(runs):
    errors = [r["error"] for r in runs[0] if "error" in r]
    assert not errors, errors[0]


def test_sharded_train_step_matches_the_reference_on_2x4(runs):
    ranks, ref = runs
    got = ranks[0]
    cfg = w.config(w.QWEN["arch"])
    kw = dict(seq=w.QWEN["seq"], batch=w.QWEN["batch"])
    with partition.activate({"data": 2, "model": 4}):
        one = w.train_case(cfg, **kw)
        noise = w.train_case(cfg, nudge=NUDGE, **kw)
    assert got["lr"] == [float(ref["lr"])]
    for k in ("loss", "grad_norm"):
        assert abs(got[k][0] / float(ref[k]) - 1.0) <= SCALAR_TOL, (k, got[k], float(ref[k]))
    start = w.flat_tree(reference_weights(cfg, w.SEED))
    nudged = w.flat_tree(w.nudged(reference_weights(cfg, w.SEED), NUDGE))
    worst = {}
    for path, p0 in start.items():
        d_ref = ref["params/" + path] - p0
        tol = max(LEAF_FLOOR, NOISE_FACTOR * trimmed_rel(noise["params"][path] - nudged[path],
                                                         one["params"][path] - p0, 1e-3))
        worst[path] = trimmed_rel(got["params"][path] - p0, d_ref, 1e-3) / tol
    top = max(worst, key=worst.get)
    assert worst[top] <= 1.0, (top, worst[top])
    assert all(r["digest"] == got["digest"] for r in ranks)
