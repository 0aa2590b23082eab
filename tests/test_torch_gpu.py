"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside itself whether a card is
present and skips without one, so every worker collects the same tests.
Run them on a machine with an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The simplex kernel must be bit-identical to its plain version in every
output and in the terminal state; the hyperbox kernel agrees to rtol
1e-6 (float32) or 1e-12 (float64) relative to the sum of |terms|.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine
from repro_torch.core import lp as tlp
from repro_torch.core.simplex import phase2_costs
from repro_torch.core.tableau import TableauSpec, build_tableau
from repro_torch.kernels import hyperbox_cuda, simplex_cuda

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _run_both(batch, spec, rule, seed, cap):
    tab, basis, phase = build_tableau(batch.a, batch.b, batch.c, spec=spec)
    c_ext = phase2_costs(batch.c, spec)
    feas = engine.phase1_feasibility_tol(batch.b).contiguous()
    tol = engine.default_tolerance(tab.dtype)
    states = [(tab.clone(), basis.clone(), phase.clone()) for _ in range(2)]
    outs = []
    for fn, (t, b, p) in zip((simplex_cuda.simplex, simplex_cuda.simplex_plain), states):
        outs.append(fn(t, b, p, c_ext, feas, cap, spec=spec, rule=rule, seed=seed, tol=tol))
    torch.cuda.synchronize()
    return outs, states


@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,feasible,layout", [(28, 28, True, "compact"),
                                                 (40, 20, False, "dense")])
def test_simplex_kernel_bit_identical_to_plain(rule, dtype, m, n, feasible, layout):
    _need_card()
    batch = tlp.random_lp_batch(np.random.default_rng(m), 64, m, n, feasible, dtype=dtype)
    spec = TableauSpec(m, n, layout)
    before = simplex_cuda.launches
    (kern, plain), (sk, sp) = _run_both(batch, spec, rule, 7, 50 * (m + n))
    assert simplex_cuda.launches == before + 1
    for k, p in zip(kern + sk, plain + sp):
        assert torch.equal(_bits(k) if k.is_floating_point() else k,
                           _bits(p) if p.is_floating_point() else p)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 5, 28, 100])
def test_hyperbox_kernel_matches_plain(dtype, n):
    _need_card()
    lo, hi, d = tlp.random_hyperbox_batch(np.random.default_rng(n), 10007, n, dtype=dtype)
    before = hyperbox_cuda.launches
    for box in ((lo, hi), (lo[0].contiguous(), hi[0].contiguous())):
        got = hyperbox_cuda.hyperbox(*box, d)
        ref = hyperbox_cuda.hyperbox_plain(*box, d)
        scale = (d * torch.where(d < 0, box[0], box[1])).abs().sum(dim=-1)
        rtol = 1e-6 if dtype == np.float32 else 1e-12
        assert bool(((got - ref).abs() <= rtol * scale).all())
    assert hyperbox_cuda.launches == before + 2


def test_main_path_goes_through_the_kernels():
    _need_card()
    rng = np.random.default_rng(0)
    batch = tlp.random_lp_batch(rng, 256, 30, 30)
    simplex_cuda.launches = hyperbox_cuda.launches = 0
    sol = repro_torch.solve(repro_torch.LPProblem.make(batch.c, batch.a, bu=batch.b))
    lo, hi, d = tlp.random_hyperbox_batch(rng, 1000, 5)
    box = repro_torch.solve(repro_torch.LPProblem.make(d, lo=lo, hi=hi))
    torch.cuda.synchronize()
    assert simplex_cuda.launches == 1 and hyperbox_cuda.launches == 1
    plain = repro_torch.solve(batch, repro_torch.SolveOptions(backend="torch"))
    assert torch.equal(sol.status, plain.status)
    assert torch.equal(sol.iterations, plain.iterations)
    assert (box.status == tlp.OPTIMAL).all()
