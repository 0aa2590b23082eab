"""BENCHMARK.json against the contract, and every cell's files found by name."""

import json
import math
import re

import pytest
import torch

from bench import harness, judge

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_the_file_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in METRICS:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                         "moves"}


def test_names_units_and_lines():
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_the_run_length_fit_the_check():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    seconds = BENCH["run_seconds"]
    assert 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.file["config"] == c.spec["config"] and c.file["traffic"] == c.spec["traffic"]
    assert c.file["why"] == c.spec["why"]
    traffic = harness.load_module("traffic", c.file["traffic"])
    for fn in ("make_pool", "call", "lps", "rows"):
        assert callable(getattr(traffic, fn))
    generator = harness.load_module("generators", c.config["generator"])
    assert callable(generator.dense) and callable(generator.shared)
    for m in c.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])
    assert set(c.file["limits"]) == {"status_mismatch", "answer_gap", "x_gap", "pivot_mismatch",
                                     "infeasibility", "objective_mismatch"}
    assert c.file["limits"]["status_mismatch"] == 0
    assert all(math.isfinite(v) and v >= 0 for v in c.file["limits"].values())
    assert c.file["sample"] > 0


def test_every_config_file_names_its_source_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert cfg["dtype"] in ("float32", "float64")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_metric_lists_name_cells_that_exist():
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        harness.load_module("metrics", m["name"])
    for kernel in ("simplex", "revised"):
        assert callable(harness.load_module("roofline", kernel).work)


def test_the_judge_compares_what_the_limits_name():
    limits = {"answer_gap": 1e-3, "x_gap": 1e-3}
    ok, checks = judge.verdict({"answer_gap": 1e-4, "x_gap": float("inf")}, limits)
    assert not ok and checks["answer_gap"]["ok"] and not checks["x_gap"]["ok"]
    ok, _ = judge.verdict({"answer_gap": float("nan"), "x_gap": 0.0}, limits)
    assert not ok


def test_a_status_that_differs_is_counted_and_left_out_of_the_gaps():
    from bench.reference import simplex64

    a = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[-1.0, 1.0], [0.0, 1.0]]], dtype=torch.float64)
    b = torch.tensor([[2.0, 3.0], [1.0, 1.0]], dtype=torch.float64)
    c = torch.tensor([[1.0, 1.0], [1.0, 0.0]], dtype=torch.float64)
    ref = simplex64.solve(a, b, c)
    assert ref.status.tolist() == [simplex64.OPTIMAL, simplex64.UNBOUNDED]
    status = ref.status.clone()
    out = judge.compare(ref.objective, ref.x, status, ref.iterations, ref)
    assert out["status_mismatch"] == 0 and out["answer_gap"] == 0 and out["x_gap"] == 0
    status[0] = simplex64.UNBOUNDED  # a false UNBOUNDED: no certificate reads it
    out = judge.compare(ref.objective, ref.x, status, ref.iterations, ref)
    assert out["status_mismatch"] == 1 and out["answer_gap"] == 0
    ok, checks = judge.verdict(out, {"status_mismatch": 0, "answer_gap": 1e-3})
    assert not ok and not checks["status_mismatch"]["ok"] and checks["answer_gap"]["ok"]


def test_the_harness_owns_each_storage_once_in_allocator_blocks():
    pool = torch.zeros(1000)  # 4,000 bytes: eight 512-byte blocks
    assert harness.owned_bytes([pool, pool[10:], pool.view(10, 100)]) == 4096
    assert harness.owned_bytes([pool, torch.zeros(1)]) == 4096 + 512
