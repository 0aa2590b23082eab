"""Deterministic synthetic LM data pipeline, host-sharded, prefetching.

Follows ``repro/data/pipeline.py``, copied rather than imported (the
port imports nothing of ``repro``).  Sequences follow a seeded
affine-recurrence language (x_{t+1} = (a*x_t + b) mod V with
per-sequence (a, b) drawn from a small seeded table, plus uniform noise
tokens) so models can actually reduce loss.

Host batches stay NumPy and are bit-equal to the reference's for every
``(seed, step, host_index)``: ``batch(step)`` depends on nothing else,
so a restarted job replays the exact stream.  ``Prefetcher``'s
``put_fn`` moves a batch to the trainer's device on the background
thread (``to_device``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    n_rules: int = 64  # distinct (a, b) recurrence rules


class SyntheticLM:
    def __init__(self, cfg: DataConfig, host_index: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(
                f"global batch {cfg.global_batch} does not split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        r = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.rules_a = r.integers(2, min(v, 1 << 15), size=cfg.n_rules)
        self.rules_b = r.integers(1, min(v, 1 << 15), size=cfg.n_rules)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """This host's rows of step ``step``: int32 ``tokens`` and ``labels``
        (the tokens shifted by one), each (local_batch, seq_len)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, self.host_index))
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        rule = rng.integers(0, cfg.n_rules, size=b)
        a = self.rules_a[rule]
        bb = self.rules_b[rule]
        x = np.empty((b, s + 1), np.int64)
        x[:, 0] = rng.integers(0, v, size=b)
        for t in range(s):
            x[:, t + 1] = (a * x[:, t] + bb) % v
        noise = rng.random((b, s + 1)) < cfg.noise
        x = np.where(noise, rng.integers(0, v, size=(b, s + 1)), x)
        return {
            "tokens": x[:, :s].astype(np.int32),
            "labels": x[:, 1:s + 1].astype(np.int32),
        }


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of host batches (overlaps with the
    device's step).  ``next()`` returns ``(step, put_fn(batch))`` in step
    order from ``start_step``; ``close()`` stops and joins the thread."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2,
                 put_fn=None):
        self.source = source
        self.put_fn = put_fn or (lambda x: x)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        item = None
        while not self._stop.is_set():
            if item is None:
                item = (step, self.put_fn(self.source.batch(step)))
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                continue
            item = None
            step += 1

    def next(self):
        return self._q.get()

    def close(self, timeout: float = 10.0):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("the prefetch thread did not stop")
