"""Gradient compression: int8 quantization with error feedback.

Follows ``repro/train/compression.py``: each gradient leaf is quantized
to int8 with a per-leaf scale, and the quantization residual is kept as
*error feedback*, added back on the next step (EF-SGD, Karimireddy et
al., 2019).  ``torch.round`` rounds half to even, as ``jnp.round`` does.

The reference's ``dp_allreduce_int8`` (the int8 all-reduce over a data
axis) comes with the multi-device slice (``ROADMAP.md``, item 6.5).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    return _quantize_with(g, scale), scale


def _quantize_with(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_ef_compressor(leaf_of: Optional[Dict[str, str]] = None):
    """Returns ``(init_fn, compress_fn)`` over name -> tensor dicts.

    ``compress_fn(grads, ef) -> (decompressed_grads, new_ef)``:
    ``g' = Q(g + e)``, ``e_new = (g + e) - g'``, in float32.  The scale is
    per leaf: ``leaf_of`` maps each parameter name to the leaf it belongs
    to, and parameters of one leaf share a scale (the reference's leaves
    stack a group's layers: ``models/convert.py:reference_leaf_of(model)``
    gives that map); by default each parameter is a leaf of its own.
    """

    def init_fn(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    def compress_fn(grads: Dict[str, torch.Tensor], ef: Dict[str, torch.Tensor]):
        tot = {k: g.to(torch.float32) + ef[k] for k, g in grads.items()}
        leaves: Dict[str, list] = {}
        for k in tot:
            leaves.setdefault(leaf_of[k] if leaf_of else k, []).append(k)
        new_g, new_e = {}, {}
        for names in leaves.values():
            amax = torch.stack([torch.max(torch.abs(tot[k])) for k in names]).max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            for k in names:
                deq = _dequantize(_quantize_with(tot[k], scale), scale)
                new_g[k], new_e[k] = deq, tot[k] - deq
        return new_g, new_e

    return init_fn, compress_fn
