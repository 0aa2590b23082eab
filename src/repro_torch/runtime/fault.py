"""Fault-tolerant training driver: checkpoint / restart / preemption-safe.

Follows ``repro/runtime/fault.py``.  ``TrainDriver.run`` executes steps
with periodic async checkpoints and resumes from the newest valid
checkpoint after a crash; the data pipeline is deterministic in the step
number, so the replayed stream is identical.  A ``preempt_at`` hook
simulates a node failure for tests.

The model holds its parameters, so the driver takes the model, and the
train step is ``(opt_state, batch) -> (opt_state, metrics)``
(``train/train_step.py``).  Checkpoints hold ``{"params", "opt"}``: for a
``models.Model`` in the reference's layout (``models/convert.py``), so
either package restores the other's; for any other module, its
parameters and the optimizer state keyed by parameter name.

Under a ``DeviceMesh`` (the model built and the driver run under
``partition.activate(mesh)``, every rank calling ``run``) a checkpoint
still holds whole leaves: ``state`` gathers them on every rank
(``models/convert.py:reference_params``), each write is the collective
``ckpt.save`` (rank 0 writes; a collective on the writer thread would
race the step's, so the write is synchronous), and a resume restores
each rank's slices (``restore(..., shardings=)`` with
``convert.reference_shardings``): a checkpoint of one mesh resumes on
another, on no mesh, or in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..ckpt import checkpoint as ckpt
from ..models.convert import (load_reference_opt_state, load_reference_params,
                              reference_opt_state, reference_params, reference_shardings,
                              reference_specs)
from ..models.model import Model


class Preemption(RuntimeError):
    pass


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: Optional[str]  # None: no checkpoints (nothing restored, nothing written)
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10


def _map(state, fn):
    """``fn`` on every tensor of an ``OptState`` (dicts of tensors, or None)."""
    def each(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: fn(v) for k, v in x.items()}
        return fn(x)

    return type(state)(*[each(x) for x in state])


class TrainDriver:
    def __init__(
        self,
        cfg: DriverConfig,
        model,
        train_step: Callable,  # (opt_state, batch) -> (opt_state, metrics)
        data_fn: Callable[[int], Dict[str, Any]],  # step -> host batch
        put_fn: Callable[[Dict[str, Any]], Dict[str, Any]] = lambda x: x,
        log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.train_step = train_step
        self.data_fn = data_fn
        self.put_fn = put_fn
        self.log_fn = log_fn or (lambda step, m: None)

    def state(self, opt_state) -> Dict[str, Any]:
        """What a checkpoint holds: the parameters and the optimizer state
        (in the reference's layout for a ``Model``, whole leaves), on the
        host."""
        if isinstance(self.model, Model):
            return {"params": reference_params(self.model, exact=True),
                    "opt": reference_opt_state(self.model, opt_state)}
        return {"params": {n: p.detach().cpu() for n, p in self.model.named_parameters()},
                "opt": _map(opt_state, lambda t: t.detach().cpu())}

    def _load(self, state):
        """Copy a restored ``state`` into the model; returns the optimizer state."""
        if isinstance(self.model, Model):
            load_reference_params(self.model, state["params"])
            return load_reference_opt_state(self.model, state["opt"])
        dev = None
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(state["params"][n])
                dev = p.device
        return _map(state["opt"], lambda t: t.to(dev))

    def resume_or_init(self, opt_state, step: Optional[int] = None):
        """Restore the newest checkpoint (or that of ``step``) into the model
        and the optimizer state if there is one; returns ``(start step,
        opt_state)``."""
        if step is None and self.cfg.ckpt_dir:
            step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0, opt_state
        if not isinstance(self.model, Model):
            return step, self._load(ckpt.restore(self.cfg.ckpt_dir, self.state(opt_state), step))
        # the tree's whole shapes from the specs (nothing gathered), each
        # rank's slices by the placements under a mesh
        ref = reference_specs(self.model)
        master = ref if opt_state.master is not None else None
        like = {"params": ref, "opt": type(opt_state)(opt_state.step, ref, ref, master)}
        places = None
        if ckpt.meshed():
            sh = reference_shardings(self.model)
            places = {"params": sh, "opt": type(opt_state)(None, sh, sh, sh)}
        return step, self._load(ckpt.restore(self.cfg.ckpt_dir, like, step, shardings=places))

    def _save(self, writer, step: int, opt_state) -> None:
        """A checkpoint of ``step``: on the writer thread, or under a
        ``DeviceMesh`` the collective ``ckpt.save`` (the module's docstring)."""
        if writer is not None:
            writer.submit(step, self.state(opt_state))
            return
        ckpt.save(self.cfg.ckpt_dir, step, self.state(opt_state))
        if dist.get_rank() == 0:
            ckpt.prune(self.cfg.ckpt_dir, self.cfg.keep)

    def run(self, opt_state, num_steps: int, preempt_at: Optional[int] = None):
        """Steps from the newest checkpoint (or 0) to ``num_steps``; returns
        ``(opt_state, metrics_hist)``, the logged steps' metrics as floats."""
        start, opt_state = self.resume_or_init(opt_state)
        writer = (ckpt.AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
                  if self.cfg.ckpt_dir and not ckpt.meshed() else None)
        saving = self.cfg.ckpt_dir is not None
        metrics_hist = []
        try:
            t0 = time.perf_counter()
            for step in range(start, num_steps):
                if preempt_at is not None and step == preempt_at:
                    raise Preemption(f"simulated preemption at step {step}")
                batch = self.put_fn(self.data_fn(step))
                opt_state, metrics = self.train_step(opt_state, batch)
                if (step + 1) % self.cfg.log_every == 0 or step == start:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["steps_per_s"] = (step - start + 1) / (time.perf_counter() - t0)
                    metrics_hist.append((step, m))
                    self.log_fn(step, m)
                if saving and (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(writer, step + 1, opt_state)
            if saving:
                self._save(writer, num_steps, opt_state)
            if writer is not None:
                writer.wait()
        finally:
            if writer is not None:
                writer.close()
        return opt_state, metrics_hist
