"""The port's restartable training driver (``repro_torch.runtime.fault``):
the twin of ``tests/test_substrate.py::test_driver_checkpoint_restart``
on the toy problem, and on reduced LMs through the port's train step:
a run preempted after a checkpoint and resumed ends with the same bits
as an uninterrupted run (the CPU is deterministic)."""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.models import Model
from repro_torch.runtime.fault import DriverConfig, Preemption, TrainDriver
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4))


def _toy_setup():
    model = _Toy()
    ocfg = opt.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
    state = opt.init(dict(model.named_parameters()), ocfg)

    def data_fn(step):
        return {"t": np.full((4,), float(step), np.float32)}

    def train_step(opt_state, batch):
        with torch.enable_grad():
            loss = torch.mean((model.w - torch.as_tensor(batch["t"])) ** 2)
            (g,) = torch.autograd.grad(loss, [model.w])
        opt_state, m = opt.update({"w": g}, opt_state, dict(model.named_parameters()), ocfg)
        return opt_state, {**m, "loss": loss.detach()}

    return model, state, train_step, data_fn


def test_driver_checkpoint_restart(tmp_path):
    model, state, step_fn, data_fn = _toy_setup()
    cfg = DriverConfig(str(tmp_path), ckpt_every=5, log_every=100)
    driver = TrainDriver(cfg, model, step_fn, data_fn)
    with pytest.raises(Preemption):
        driver.run(state, 20, preempt_at=12)
    assert ckpt.latest_step(str(tmp_path)) == 10
    # restart: resumes from 10 and completes; the data replays
    state_resumed, hist = driver.run(state, 20)
    assert hist[0][0] == 10
    w_resumed = model.w.detach().clone()
    ref_model, ref_state, ref_step, _ = _toy_setup()
    TrainDriver(DriverConfig(str(tmp_path) + "_ref", ckpt_every=100, log_every=100),
                ref_model, ref_step, data_fn).run(ref_state, 20)
    assert torch.equal(w_resumed, ref_model.w.detach())
    assert int(state_resumed.step) == 20


def _lm_run(arch, ckpt_dir, steps, preempt_at=None, every=2):
    cfg = configs.get_config(arch, reduced=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2)
    state = opt.init(dict(model.named_parameters()), ocfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=1))
    driver = TrainDriver(DriverConfig(str(ckpt_dir), ckpt_every=every, log_every=1), model,
                         make_train_step(model, ocfg, accum=2, remat=True), data.batch,
                         put_fn=lambda b: to_device(b, "cpu"))
    return model, driver, state


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-2b", "deepseek-v2-lite-16b"])
def test_preempted_and_resumed_lm_is_bit_equal_to_uninterrupted(tmp_path, arch):
    model, driver, state = _lm_run(arch, tmp_path / "a", 6)
    with pytest.raises(Preemption):
        driver.run(state, 6, preempt_at=3)
    assert ckpt.latest_step(str(tmp_path / "a")) == 2
    # a new process would build everything anew: so do we (other weights)
    model, driver, state = _lm_run(arch, tmp_path / "a", 6)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    state, hist = driver.run(state, 6)
    assert [s for s, _ in hist] == [2, 3, 4, 5]
    ref_model, ref_driver, ref_state = _lm_run(arch, tmp_path / "b", 6)
    ref_state, ref_hist = ref_driver.run(ref_state, 6)
    assert [m["loss"] for _, m in hist] == [m["loss"] for s, m in ref_hist if s >= 2]
    for (n, a), b in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(a, b), n
    for k in state.m:
        assert torch.equal(state.m[k], ref_state.m[k]) and torch.equal(state.v[k], ref_state.v[k])
        assert torch.equal(state.master[k], ref_state.master[k])
    assert int(state.step) == int(ref_state.step) == 6


def test_driver_without_a_checkpoint_directory_writes_nothing(tmp_path, monkeypatch):
    model, state, step_fn, data_fn = _toy_setup()
    monkeypatch.chdir(tmp_path)
    driver = TrainDriver(DriverConfig(None, log_every=1), model, step_fn, data_fn)
    state, hist = driver.run(state, 3)
    assert [s for s, _ in hist] == [0, 1, 2] and int(state.step) == 3
    assert not list(tmp_path.iterdir())
