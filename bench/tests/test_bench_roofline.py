"""The roofline work counts against hand counts, and the share a reader makes of them."""

from types import SimpleNamespace

import pytest

from bench import harness
from bench.roofline import share

SIMPLEX = harness.load_module("roofline", "simplex")
REVISED = harness.load_module("roofline", "revised")


def test_a_pivot_of_the_condensed_tableau():
    # m = 2, n = 3: 3 x 4 entries, a multiply and a subtract each, 2 ratio
    # divides and 4 divides of the pivot row.
    assert SIMPLEX.pivot_flops(2, 3) == 2 * 3 * 4 + 2 + 4
    assert SIMPLEX.phase1_flops(2, 3) == 2 * 2 * 2 * 4


def test_simplex_work_at_the_paper_size():
    flops, nbytes = SIMPLEX.work(100, 100, 4, lps=1, pivots=1, phase1_lps=0, calls=1)
    assert flops == 2 * 101 * 101 + 100 + 101
    # A, b, c read once; x and the objective (float32), status and iterations (int32).
    assert nbytes == 4 * (100 * 100 + 100 + 100) + 4 * 101 + 8
    flops2, bytes2 = SIMPLEX.work(200, 100, 4, lps=10, pivots=2000, phase1_lps=10, calls=3)
    assert flops2 == 2000 * (2 * 201 * 101 + 200 + 101) + 10 * 4 * 200 * 101
    assert bytes2 == 10 * (4 * (200 * 100 + 300) + 4 * 101 + 8)


def test_revised_work_reads_the_shared_matrix_once_a_call():
    flops, nbytes = REVISED.work(100, 100, 4, lps=2, pivots=5, phase1_lps=0, calls=3)
    assert flops == 5 * SIMPLEX.pivot_flops(100, 100)
    assert nbytes == 3 * 4 * 100 * 100 + 2 * (4 * 200 + 4 * 101 + 8)


def fake_run(kernel_s, name="NVIDIA H100 80GB HBM3"):
    trace = SimpleNamespace(seconds=lambda pattern: kernel_s)
    cell = SimpleNamespace(config={"m": 100, "n": 100, "dtype": "float32"})
    run = harness.Run(cell=cell, calls=[None], lps=50_000, pivots=50_000 * 250, phase1_lps=0,
                      trace=trace, card={"name": name})
    return run


def test_the_share_is_the_least_time_over_the_kernel_time():
    flops, nbytes = SIMPLEX.work(100, 100, 4, 50_000, 50_000 * 250, 0, 1)
    least = max(flops / 67e12, nbytes / 3.35e12)
    assert share(fake_run(0.4), "simplex") == pytest.approx(100 * least / 0.4)


def test_no_share_without_kernel_time_or_a_known_card():
    assert share(fake_run(0.0), "simplex") is None
    assert share(fake_run(0.4, name="some other card"), "simplex") is None
