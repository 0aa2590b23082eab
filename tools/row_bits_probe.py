#!/usr/bin/env python3
"""Does a row's reduction depend on the rows around it?  Library calls against the port's.

    python3 tools/row_bits_probe.py

Needs one CUDA device.  For k rows taken from a batch of 2048 (300 for
the products), counts the entries whose bits differ between the k rows
computed alone and the same rows computed inside the whole batch: for
``Tensor.sum`` over the last axis and for the matvecs ``einsum("bmn,bn->bm")``
and ``einsum("bmn,bm->bn")`` (the library calls), and for
``core/lp.py:row_sum`` and ``core/pdhg.py:step_sizes`` (the port's
row-local versions, which must count 0).  Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _diff(part: torch.Tensor, full: torch.Tensor) -> int:
    return int((_bits(part) != _bits(full[: part.shape[0]])).sum())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("row_bits_probe: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import pdhg
    from repro_torch.core.lp import row_sum

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(0)
    ks = (1, 2, 3, 5, 8, 15, 16, 64)
    out = {}
    for n in (28, 100, 128, 500):
        v = (torch.randn(2048, n, generator=gen) * torch.randn(2048, n, generator=gen)).cuda()
        full, tree = v.sum(-1), row_sum(v)
        out[f"sum_n{n}"] = {k: _diff(v[:k].sum(-1), full) for k in ks}
        out[f"row_sum_n{n}"] = {k: _diff(row_sum(v[:k]), tree) for k in ks}
    for m in (100, 500):
        a = torch.randn(300, m, m, generator=gen).cuda()
        x = torch.randn(300, m, generator=gen).cuda()
        b = torch.rand(300, m, generator=gen).cuda() + 0.5
        mv, rmv = torch.einsum("bmn,bn->bm", a, x), torch.einsum("bmn,bm->bn", a, x)
        tau, sigma, _ = pdhg.step_sizes(a, b, x.abs())
        out[f"einsum_{m}"] = {k: [_diff(torch.einsum("bmn,bn->bm", a[:k], x[:k]), mv),
                                  _diff(torch.einsum("bmn,bm->bn", a[:k], x[:k]), rmv)]
                              for k in ks}
        out[f"step_sizes_{m}"] = {
            k: [_diff(t, ref) for t, ref in zip(pdhg.step_sizes(a[:k], b[:k], x[:k].abs())[:2],
                                                (tau, sigma))]
            for k in ks}
    print(json.dumps(dict(case="row_bits_probe", device=torch.cuda.get_device_name(0),
                          differing_entries=out)), flush=True)
    local = [v for key, row in out.items() if key.startswith(("row_sum", "step_sizes"))
             for v in row.values()]
    return 0 if all((sum(v) if isinstance(v, list) else v) == 0 for v in local) else 1


if __name__ == "__main__":
    sys.exit(main())
