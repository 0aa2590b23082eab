"""The control fails the check: the reference computed in TF32 in the program's place.

At each cell's own LP shape, on a few LPs drawn by the cell's
generator and traffic (the chip runs the control at the cell's size:
``bench/readings.py``), the control's numbers go through the cell's
limits and must come out not correct.
"""

import pytest
import torch

from bench import harness, judge, readings
from bench.reference import simplex64


@pytest.mark.parametrize("name", ["type1.batch50k", "type2.batch10k", "type1.shared50k"])
def test_the_control_is_not_correct(name):
    cell = harness.load_cell(name)
    config = dict(cell.config, torch_dtype=torch.float32)
    generator = harness.load_module("generators", config["generator"])
    traffic = harness.load_module("traffic", cell.file["traffic"])
    g = torch.Generator().manual_seed(2**31 + 3)
    pool = traffic.make_pool(generator, config, dict(cell.params, lps_per_call=12, pool=1), g,
                             torch.device("cpu"))
    a, b, c = traffic.rows(pool[0], slice(None))
    sample = dict(a=a, b=b, c=c)
    ref = simplex64.solve(a, b, c)
    correct, checks = judge.verdict(readings.control_numbers(sample, ref), cell.file["limits"])
    assert not correct, checks
