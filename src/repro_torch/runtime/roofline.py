"""Analytic per-iteration roofline for the batched LP backends on one H100.

Follows ``repro/runtime/roofline.py``: the same per-iteration FLOP and
byte formulas for each storage layout, under the machine constants of
the card the port runs on, an NVIDIA H100 SXM (NVIDIA's data sheet, at
its full 700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32
and 34 TFLOP/s in float64 outside the tensor cores.  The kernels do
their arithmetic on the CUDA cores (no tensor-core path, no TF32), so
those are the peaks that bound them, picked by the element size.

* **dense / compact tableau** (``core/tableau.py``): the pivot update
  rewrites the whole (m+1, q) tableau every iteration.  FLOPs and bytes
  are both O(m q), so intensity is a small constant (~0.4 flop/byte in
  float32), far below the card's balance of ~20: memory-bound wherever
  the tableau lives in device memory.
* **pdhg** (``core/pdhg.py``): two matvecs against a per-LP ``A`` each
  step, the same constant-intensity regime.
* **shared revised simplex** (``core/revised.py``): pricing reads the
  one shared ``A`` once per tile of LPs, so its O(m n) bytes amortize
  over ``tile_b`` LPs and the per-LP traffic is the O(m^2) basis state.

This model is the static feature source of the cost-model autotuner
(``runtime/autotune.py``), which ranks candidate configurations by these
numbers before anything is timed.
"""

from __future__ import annotations

from typing import Dict

#: HBM bandwidth of one H100 SXM (bytes/s).
HBM_BW = 3.35e12
#: Float32 peak outside the tensor cores (FLOP/s).
PEAK_FLOPS = 67e12
#: Float64 peak outside the tensor cores (FLOP/s).
PEAK_FLOPS_FP64 = 34e12
#: Float32 machine balance (flop/byte).
MACHINE_BALANCE = PEAK_FLOPS / HBM_BW

SIZES = (5, 28, 100, 200, 500)

KINDS = ("dense", "compact", "pdhg", "shared")


def peak_flops(dtype_bytes: int) -> float:
    """The card's peak for an element size: float64 at 8 bytes, else float32."""
    return PEAK_FLOPS_FP64 if dtype_bytes >= 8 else PEAK_FLOPS


def iteration_profile(
    kind: str, m: int, n: int, tile_b: int = 1, dtype_bytes: int = 4
) -> Dict[str, float]:
    """FLOPs / HBM bytes / intensity for ONE lockstep iteration of one LP.

    ``tile_b`` only matters for ``kind="shared"``: the shared ``A`` is
    fetched once per tile, so its bytes are divided by the tile size.
    Byte counts are steady-state device-memory traffic (state read and
    written each iteration); FLOPs count a multiply-add as 2.
    ``roofline_fraction`` is the intensity over the machine balance of
    the element size: the ceiling on attainable peak-FLOP utilization.
    """
    if kind in ("dense", "compact"):
        q = 1 + n + (2 * m if kind == "dense" else m)
        rows = m + 1
        # pricing scan (1 pass), ratio column, rank-1 pivot update (2 ops/elem)
        flops = 3.0 * rows * q
        byts = 2.0 * rows * q * dtype_bytes  # tableau in + out
    elif kind == "pdhg":
        # x/y proximal steps: A x and A^T y matvecs + O(m + n) vector ops
        flops = 4.0 * m * n + 8.0 * (m + n)
        byts = (2.0 * m * n + 6.0 * (m + n)) * dtype_bytes  # A twice + vectors
    elif kind == "shared":
        # pricing w = c_B B^-1 (2m^2) + d = w.A (2mn) + ftran B^-1 a_e (2m^2)
        # + rank-1 binv/xb update (2m^2)
        flops = 2.0 * m * n + 6.0 * m * m
        # A once per TILE (amortized), binv read + written, O(m+n) vectors
        byts = (m * n / max(tile_b, 1) + 2.0 * m * m + 4.0 * (m + n)) * dtype_bytes
    else:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    ai = flops / byts
    return {
        "flops": flops,
        "bytes": byts,
        "intensity": ai,
        "roofline_fraction": ai / (peak_flops(dtype_bytes) / HBM_BW),
    }


def arithmetic_intensity(
    kind: str, m: int, n: int, tile_b: int = 1, dtype_bytes: int = 4
) -> float:
    """Just the flop/byte number."""
    return iteration_profile(kind, m, n, tile_b, dtype_bytes)["intensity"]
