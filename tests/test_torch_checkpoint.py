"""The port's checkpoints (``repro_torch.ckpt.checkpoint``): the twins of
the reference's checkpoint tests in ``tests/test_substrate.py``, bfloat16
leaves kept bit for bit, and checkpoints crossing the two packages.

The on-disk format is the reference's, and the port flattens a tree in
``jax.tree_util``'s order, so a checkpoint of ``{"params", "opt"}`` in
the reference's layout (``models/convert.py``) restores in either
package.  Across packages, both ways: the reference trains two steps of
reduced gemma2 (float32, ``accum=2``) and saves; the port restores the
same bits and takes a third step, which matches the reference's third
step (the loss within ``SCALAR_RTOL``; ``grad_norm``, ``m`` and ``v``
within ``STATE_RTOL``; the step's parameter change per leaf within
``CHANGE_RTOL``, relative L2: from equal states one step of Adam carries
the gradients' float32 rounding, about 5e-5 relative on this case, and
the moments damp it); then the port saves its state and the reference
restores the same bits and steps on.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models.convert import (load_reference_opt_state, load_reference_params,
                                        reference_opt_state, reference_params)
from repro_torch.runtime.fault import DriverConfig, TrainDriver
from repro_torch.train import optimizer
from repro_torch.train import train_step as ts

import test_torch_train_step as tts

SCALAR_RTOL = 2e-6
STATE_RTOL = 1e-4
CHANGE_RTOL = 1e-3


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16), "step": torch.tensor(7)}}
    ckpt.save(str(tmp_path), 3, tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore(str(tmp_path), tree)
    assert out.keys() == tree.keys() and out["b"].keys() == tree["b"].keys()
    for a, b in zip(ckpt._flatten(tree), ckpt._flatten(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_and_gc(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        w.submit(s, tree)
    w.wait()
    w.close()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) <= 2
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_checkpoint_submit_copies_the_tree_before_it_returns(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    x = torch.zeros(4)
    w.submit(1, {"x": x})
    x.add_(1.0)  # the trainer overwrites its tensor while the write is pending
    w.close()
    assert torch.equal(ckpt.restore(str(tmp_path), {"x": x})["x"], torch.zeros(4))


def test_checkpoint_torn_write_is_ignored(tmp_path):
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 3, tree)
    os.makedirs(tmp_path / "step_00000007.tmp", exist_ok=True)
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_checkpoint_latest_pointer_stale_falls_back_to_scan(tmp_path):
    tree = {"x": torch.zeros(2)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    os.makedirs(tmp_path / "step_00000005")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_00000009")
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert torch.equal(ckpt.restore(str(tmp_path), tree)["x"], torch.zeros(2))
    os.remove(tmp_path / "LATEST")
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_checkpoint_close_is_idempotent(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    w.submit(1, {"x": torch.zeros(2)})
    w.wait()
    w.close()
    w.close()
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_restore_rejects_another_structure_and_places_on_the_device(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(2), "y": torch.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(2), "y": torch.ones(4)})
    out = ckpt.restore(str(tmp_path), {"x": torch.zeros(2), "y": torch.ones(3)}, device="cpu")
    assert out["y"].device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {})


def test_leaf_order_is_the_reference_tree_order():
    """Sorted dict keys (``g10`` before ``g2``), NamedTuple fields in order,
    ``None`` with no leaf: the reference's ``tree_flatten`` order."""
    state = optimizer.OptState(torch.tensor(1), {"b": torch.tensor(2.0), "a": torch.tensor(3.0)},
                               {"z": torch.tensor(4.0)}, None)
    tree = {"params": {"g2": torch.tensor(5.0), "g10": torch.tensor(6.0)}, "opt": state}
    rtree = {"params": {"g2": 5.0, "g10": 6.0},
             "opt": ropt.OptState(1, {"b": 2.0, "a": 3.0}, {"z": 4.0}, None)}
    assert [float(x) for x in ckpt._flatten(tree)] == [float(x) for x in _leaves(rtree)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_special_dtypes_keep_their_bits_in_both_packages(tmp_path, dtype):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(64).astype(np.float32)
    t = torch.as_tensor(vals).to(getattr(torch, dtype))
    ckpt.save(str(tmp_path / "port"), 1, {"w": t})
    back = ckpt.restore(str(tmp_path / "port"), {"w": t})["w"]
    assert back.dtype == t.dtype
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))
    # the reference reads the port's bits under its own dtype, and back
    ref = rckpt.restore(str(tmp_path / "port"), {"w": np.zeros(64, getattr(ml_dtypes, dtype))})
    ref_arr = np.asarray(ref["w"])
    assert ref_arr.dtype == np.dtype(getattr(ml_dtypes, dtype))
    np.testing.assert_array_equal(ref_arr.view(np.uint8).reshape(64, -1),
                                  t.view(torch.uint8).numpy().reshape(64, -1))
    rckpt.save(str(tmp_path / "ref"), 2, {"w": ref["w"]})
    again = ckpt.restore(str(tmp_path / "ref"), {"w": t})["w"]
    assert torch.equal(again.view(torch.uint8), t.view(torch.uint8))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def test_checkpoints_cross_the_packages_both_ways(tmp_path):
    arch = "gemma2-2b"
    cfg, rcfg = tts._cfgs(arch)
    tree = tts.reference_weights(cfg, 3)
    ocfg = ropt.OptConfig(**tts.OPT)
    rstep = jax.jit(rts.make_train_step(tts.RModel(rcfg), ocfg, accum=tts.ACCUM, remat=True))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = ropt.init(params, ocfg)
    batches = [tts._inputs(rcfg, s) for s in range(4)]
    for s in range(2):
        params, opt, _ = rstep(params, opt, {k: jnp.asarray(v) for k, v in batches[s].items()})
    rckpt.save(str(tmp_path / "ref"), 2, {"params": params, "opt": opt})
    p2 = jax.tree_util.tree_map(np.asarray, params)
    params, opt, rm = rstep(params, opt, {k: jnp.asarray(v) for k, v in batches[2].items()})

    # the port restores the reference's step 2, bit for bit
    model = tts._port_model(cfg, tts.reference_weights(cfg, 4))  # other weights, overwritten
    pocfg = optimizer.OptConfig(**tts.OPT)
    state = optimizer.init(dict(model.named_parameters()), pocfg)
    driver = TrainDriver(DriverConfig(str(tmp_path / "ref")), model, None, None)
    start, state = driver.resume_or_init(state)
    assert start == 2 and int(state.step) == 2
    restored = driver.state(state)
    for a, b in zip(ckpt._flatten(restored), _leaves(rckpt.restore(
            str(tmp_path / "ref"), {"params": p2, "opt": opt}))):
        np.testing.assert_array_equal(_bits(a), _bits(b))

    # the port's third step against the reference's
    step = ts.make_train_step(model, pocfg, accum=tts.ACCUM, remat=True)
    state, m = step(state, {k: torch.as_tensor(v) for k, v in batches[2].items()})
    assert abs(float(m["loss"]) / float(rm["loss"]) - 1) <= SCALAR_RTOL
    assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) <= STATE_RTOL
    assert float(m["lr"]) == float(rm["lr"])
    got_p, want_p = tts._np_tree(reference_params(model)), tts._np_tree(
        jax.tree_util.tree_map(np.asarray, params))
    start_p = tts._np_tree(p2)
    for path in got_p:
        assert _rel(got_p[path] - start_p[path], want_p[path] - start_p[path]) <= CHANGE_RTOL, path
    ref_state = reference_opt_state(model, state)
    for field in ("m", "v", "master"):
        got = tts._np_tree(jax.tree_util.tree_map(lambda t: t.numpy(), getattr(ref_state, field)))
        want = tts._np_tree(jax.tree_util.tree_map(np.asarray, getattr(opt, field)))
        for path in got:
            assert _rel(got[path], want[path]) <= STATE_RTOL, (field, path)

    # the port saves; the reference restores the same bits and steps on
    ckpt.save(str(tmp_path / "port"), 3, driver.state(state))
    back = rckpt.restore(str(tmp_path / "port"), {"params": params, "opt": opt})
    for a, b in zip(ckpt._flatten(driver.state(state)), _leaves(back)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(back["opt"].step) == 3
    _, o4, m4 = rstep(back["params"], back["opt"],
                      {k: jnp.asarray(v) for k, v in batches[3].items()})
    assert np.isfinite(float(m4["loss"])) and int(o4.step) == 4


def test_exact_reference_params_keep_bfloat16_bits_and_load_back():
    cfg, _ = tts._cfgs("mamba2-130m", dtype="bfloat16")
    model = tts._port_model(cfg, tts.reference_weights(cfg, 3))
    tree = reference_params(model, exact=True)
    dtypes = {t.dtype for t in _leaves(jax.tree_util.tree_map(lambda t: t, tree))}
    assert torch.bfloat16 in dtypes
    other = tts._port_model(cfg, tts.reference_weights(cfg, 4))
    load_reference_params(other, tree)
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    state = optimizer.init(dict(model.named_parameters()), optimizer.OptConfig())
    back = load_reference_opt_state(other, reference_opt_state(model, state))
    for k in state.master:
        assert torch.equal(back.master[k], state.master[k])
    assert back.step.dtype == torch.int32 and back.master[k].dtype == torch.float32
