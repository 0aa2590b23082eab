"""repro_torch — the PyTorch and CUDA port of the batched-LP library ``repro``.

The public surface follows ``repro/__init__.py``: ``solve``,
``solve_hyperbox``, ``LPProblem``, ``LPBatch``, ``SharedLPBatch``,
``canonicalize_shared``, ``SolveOptions``, ``SolveStats``,
``SolveSession``, ``TableauSpec``, the status codes and ``autotune``
(the cost-model autotuner: ``repro_torch.autotune.warm(...)``).  The default
backend is ``"cuda"``: hand-written kernels for NVIDIA Hopper (``kernels/csrc``), built with
``nvcc`` at first use.  ``"pdhg"`` is the first-order backend for large
LPs (restarted PDHG on its own kernel; ``crossover=True`` polishes its
answers into exact vertices), and ``"auto"`` routes each batch by
shape: the simplex kernel below ``max(m, n) = 500``, ``pdhg`` from
there on.  Entry points put their tensors on the card unless
the caller passes ``device="cpu"``; on CPU tensors the kernels' plain
PyTorch versions run instead.  This package imports torch, numpy and the
standard library only — never JAX or ``repro``.
"""

from .api import solve, solve_hyperbox
from .core.backends import (
    Backend,
    SolveOptions,
    SolveStats,
    available_backends,
    get_backend,
    register_backend,
)
from .core.lp import (
    INFEASIBLE,
    ITER_LIMIT,
    NUMERICAL,
    OPTIMAL,
    RUNNING,
    STATUS_NAMES,
    UNBOUNDED,
    LPBatch,
    LPSolution,
    ResumeState,
    SharedLPBatch,
)
from .core.problem import LPProblem, canonicalize_shared
from .core.session import SolveSession
from .core.tableau import TableauSpec
from .runtime import autotune

__all__ = [
    "solve", "solve_hyperbox", "LPProblem", "LPBatch", "SharedLPBatch", "canonicalize_shared",
    "LPSolution", "ResumeState", "SolveSession", "TableauSpec",
    "SolveOptions", "SolveStats", "Backend", "available_backends", "get_backend",
    "register_backend", "RUNNING", "OPTIMAL", "UNBOUNDED", "INFEASIBLE", "ITER_LIMIT",
    "NUMERICAL", "STATUS_NAMES", "autotune",
]
