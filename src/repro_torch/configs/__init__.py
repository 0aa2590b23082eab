"""Architecture + workload registry.

Follows ``repro/configs/__init__.py``.  ``get_config(arch_id, reduced=False)``
returns a ModelConfig for any of the ten assigned architectures; ``SHAPES``
defines the assigned input-shape set; ``input_specs(cfg, shape)`` gives one
``InputSpec(shape, dtype, axes)`` record for every model input of a cell
(the reference returns ``ShapeDtypeStruct`` stand-ins); ``make_inputs`` makes
the same NumPy draws in the same order as the reference, so the inputs are
bit-equal to its own.  LP workloads (the paper's own benchmark set) are
registered alongside under ``lp_*``.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.lp import resolve_device
from ..models.config import ModelConfig

_ARCH_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-130m": "mamba2_130m",
    "gemma2-2b": "gemma2_2b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen1.5-4b": "qwen15_4b",
    "internlm2-20b": "internlm2_20b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

SHAPE_IDS = tuple(SHAPES)


class InputSpec(NamedTuple):
    """One model input: its shape, dtype name and logical axes."""

    shape: Tuple[int, ...]
    dtype: str
    axes: Tuple[Optional[str], ...]


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return (mod.reduced() if reduced else mod.config()).validate()


def cell_is_applicable(cfg: ModelConfig, shape: Shape) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "skip(full-attn)"
    return None


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, InputSpec]:
    """An ``InputSpec`` for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, InputSpec] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            specs["frames"] = InputSpec((b, s, cfg.d_model), cfg.dtype, ("batch", None, None))
        specs["tokens"] = InputSpec((b, s), "int32", ("batch", None))
        if shape.kind == "train":
            specs["labels"] = InputSpec((b, s), "int32", ("batch", None))
        if cfg.family != "encdec" and cfg.frontend == "vision":
            specs["patch_embeds"] = InputSpec(
                (b, cfg.num_patches, cfg.d_model), cfg.dtype, ("batch", None, None)
            )
            specs["positions"] = InputSpec((b, s, 3), "int32", ("batch", None, None))
    elif shape.kind == "decode":
        specs["tokens"] = InputSpec((b, 1), "int32", ("batch", None))
        if cfg.mrope_sections:
            specs["positions"] = InputSpec((b, 1, 3), "int32", ("batch", None, None))
    return specs


def make_inputs(cfg: ModelConfig, shape: Shape, seed: int = 0, device=None):
    """Concrete random inputs matching ``input_specs``, on ``device``.

    The draws are the reference's, in its order: integer inputs from
    ``rng.integers(0, vocab_size)`` (positions are ``arange``), float
    inputs from ``rng.normal`` cast to the input's dtype.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if spec.dtype == "int32":
            if k == "positions":
                base = np.arange(spec.shape[1])[None, :, None]
                arr = np.broadcast_to(base, spec.shape).astype(np.int32)
            else:
                arr = rng.integers(0, cfg.vocab_size, size=spec.shape, dtype=np.int32)
            out[k] = torch.as_tensor(arr, device=device)
        else:
            arr = rng.normal(size=spec.shape)
            out[k] = torch.as_tensor(arr).to(device=device, dtype=getattr(torch, spec.dtype))
    return out


def mrope_positions(batch: int, seq: int, patches: int, seed: int) -> np.ndarray:
    """(batch, seq, 3) int32 M-RoPE positions (t, h, w) whose coordinates differ.

    ``make_inputs`` gives every coordinate ``arange``, under which M-RoPE is
    plain RoPE; these do not.  Each row's ``patches`` patch embeddings lie
    on a grid of gh x gw (gh the largest divisor of ``patches`` not above
    its square root) at one t, the grid's (t, h, w) offset by seeded draws
    in [0, 4); the text that follows sits at equal coordinates, its index in
    the sequence, past the grid (as decode steps continue it at
    ``cache_index``).
    """
    rng = np.random.default_rng(seed)
    gh = max(d for d in range(1, math.isqrt(patches) + 1) if patches % d == 0)
    gw = patches // gh
    out = np.broadcast_to(np.arange(seq, dtype=np.int32)[None, :, None], (batch, seq, 3)).copy()
    k = np.arange(min(patches, seq))
    for row in range(batch):
        t0, h0, w0 = rng.integers(0, 4, size=3)
        out[row, k] = np.stack([np.full_like(k, t0), h0 + k // gw, w0 + k % gw], axis=-1)
    return out


# --- LP workloads (the paper's own benchmark set) ---------------------------

LP_WORKLOADS = {
    # name: (batch, m, n, feasible_start)
    "lp_small_feasible": (10000, 28, 28, True),
    "lp_100_feasible": (20000, 100, 100, True),
    "lp_200_infeasible": (10000, 40, 20, False),
    "lp_hyperbox_5d": (4_001_000, 5, 5, True),
    "lp_hyperbox_28d": (6_003_000, 28, 28, True),
}
