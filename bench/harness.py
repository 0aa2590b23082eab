"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell, configuration, traffic mix or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``bench/workloads/<cell>.json``: the configuration, the traffic kind
  and its parameters, the sample the check draws, the check's limits;
* ``bench/configs/<config>.json``: the LP class (shape, dtype, options)
  and the generator that draws it (``bench/generators/<name>.py``);
* ``bench/traffic/<kind>.py``: the pool of inputs and one call;
* ``bench/metrics/<metric>.py``: a per-layer reader, ``read(run)``,
  returning a number or None when it finds nothing to read;
* ``bench/roofline/<kernel>.py``: a kernel's operations and bytes.

End-to-end metrics are taken here, by the host's clock around calls
that end in ``torch.cuda.synchronize()``; per-layer ones in the
``--trace 1`` run, from the profiler's trace and the program's counters.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
BUILD = BENCH / "build"

#: Top-level modules a run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: Fixed cache directories inside the checkout, so that only a checkout's
#: first run builds the port's kernels.
CACHE_ENV = {
    "REPRO_TORCH_BUILD_DIR": BUILD / "kernels",
    "REPRO_TORCH_AUTOTUNE_CACHE": BUILD / "autotune.json",
    "TRITON_CACHE_DIR": BUILD / "triton",
    "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
    "CUDA_CACHE_PATH": BUILD / "cuda_cache",
}


class SetupError(RuntimeError):
    """The run cannot start: no card, too few cards, or an unknown cell."""


def set_cache_env() -> None:
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SetupError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules (or of ``names``) that the benchmark may not
    load, compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


@dataclass
class Cell:
    """One entry of ``workloads`` with its files."""

    name: str
    chips: int
    spec: dict  # BENCHMARK.json's entry
    file: dict  # bench/workloads/<name>.json
    config: dict  # bench/configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def params(self) -> dict:
        return self.file["params"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Optional[dict] = None) -> Cell:
    bench = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise SetupError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(specs)}")
    spec = specs[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[spec["config"]]["file"])
    return Cell(name=name, chips=int(spec["chips"]), spec=spec,
                file=load_json(BENCH / "workloads" / f"{name}.json"), config=config,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


#: The answer fields the check reads.
FIELDS = ("objective", "x", "status", "iterations")


@dataclass
class Answers:
    """A call's answers, as the check reads them."""

    objective: object
    x: object
    status: object
    iterations: object


class Keeper:
    """The window's answers, copied on the device into storage reserved in set-up.

    Kept in the program's own tensors, the answers would make the
    allocator grow, with a ``cudaMalloc`` in every call (0.53 s of idle
    in 5 s of calls of 2,048 type-1 LPs on an H100); read back to the
    host, each call would wait on four copies (such calls' rate 15%
    lower).  A copy on the device, ordered after the call on its stream,
    costs microseconds.
    """

    def __init__(self, like, capacity: int):
        # Empty templates: the warm call's own answers are not held.
        self.like = {k: getattr(like, k).new_empty((0, *getattr(like, k).shape)) for k in FIELDS}
        self.slabs: List[dict] = []
        self.capacity = self.count = 0
        self._grow(capacity)

    def _grow(self, n: int) -> None:
        self.slabs.append({k: t.new_empty((n, *t.shape[1:])) for k, t in self.like.items()})
        self.capacity += n

    def keep(self, sol) -> Answers:
        if self.count == self.capacity:
            self._grow(max(self.capacity // 2, 1))
        i = self.count
        for slab in self.slabs:
            n = slab["x"].shape[0]
            if i < n:
                break
            i -= n
        for k in FIELDS:
            slab[k][i].copy_(getattr(sol, k))
        self.count += 1
        return Answers(*(slab[k][i] for k in FIELDS))

    def tensors(self) -> List[object]:
        return [t for slab in self.slabs for t in slab.values()]


def owned_bytes(tensors) -> int:
    """Device bytes under ``tensors``: each distinct storage once, rounded up to the
    caching allocator's 512-byte blocks as ``torch.cuda.memory_allocated`` counts it."""
    sizes = {}
    for t in tensors:
        storage = t.untyped_storage()
        sizes[storage.data_ptr()] = storage.nbytes()
    return sum(-(-n // 512) * 512 for n in sizes.values())


@dataclass
class Call:
    entry: int  # pool index
    lps: int
    start: float
    end: float
    peak_bytes: int  # the process's allocated device bytes at the call's peak
    owned: int  # of which the harness's own: the input pool and the kept answers
    sol: Optional[Answers] = None


@dataclass
class Run:
    """What the per-layer readers see: the cell, the window's calls, the trace, the counters."""

    cell: Cell
    calls: List[Call]
    lps: int = 0
    pivots: int = 0
    phase1_lps: int = 0
    trace: object = None  # bench/trace.py:Trace
    stats: object = None  # repro_torch.SolveStats of one call of each pool entry (traced run)
    card: dict = field(default_factory=dict)

    def peak(self) -> Optional[dict]:
        """The card's published peaks (``bench/peaks.json``), None for a card not listed."""
        return load_json(BENCH / "peaks.json").get(self.card.get("name", ""))


def card_info(torch) -> dict:
    """The card's name and power limit (``nvidia-smi``), as the run saw them."""
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        info["power_limit"] = out.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


class Device:
    """The card's clock and memory calls; on the CPU (rehearsals only) they do nothing."""

    def __init__(self, torch, on_card: bool):
        self.cuda = torch.cuda if on_card else None

    def sync(self) -> None:
        if self.cuda:
            self.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            self.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.cuda.max_memory_allocated() if self.cuda else 0

    def owned(self, tensors) -> int:
        return owned_bytes(tensors) if self.cuda else 0

    def release(self) -> None:
        if self.cuda:
            self.cuda.empty_cache()


def warm(device: Device, rt, traffic, pool, seconds: float) -> Keeper:
    """Two calls before the window: the first builds or loads the kernels and
    every specialisation the cell's calls use; the second, timed, sizes the
    storage of the window's answers."""
    traffic.call(rt, pool[0], None)
    device.sync()
    t = time.perf_counter()
    sol = traffic.call(rt, pool[1 % len(pool)], None)
    device.sync()
    return Keeper(sol, int(seconds / max(time.perf_counter() - t, 1e-3) * 1.25) + 4)


def window(device: Device, rt, traffic, pool, seconds, keeper: Keeper, *, annotate=None):
    """Calls back to back, each waited for, until ``seconds`` have passed.

    Returns ``(start, calls)``.  The last call is the first to end past
    ``seconds``: the window's time runs from its start to that end.
    After a call is timed, ``keeper`` copies its answers on the device.
    Each call records the allocator's peak in it and the bytes the
    harness owned meanwhile (the pool, the keeper's storage).
    """
    calls: List[Call] = []
    pool_bytes = device.owned(t for entry in pool for t in entry)
    start = time.perf_counter()
    k = 0
    while True:
        ix = k % len(pool)
        device.reset_peak()
        owned = pool_bytes + device.owned(keeper.tensors())
        t0 = time.perf_counter()
        if annotate is None:
            sol = traffic.call(rt, pool[ix])
        else:
            with annotate("bench.call"):
                sol = traffic.call(rt, pool[ix])
        device.sync()
        t1 = time.perf_counter()
        calls.append(Call(entry=ix, lps=traffic.lps(pool[ix]), start=t0, end=t1,
                          peak_bytes=device.peak(), owned=owned, sol=keeper.keep(sol)))
        del sol
        k += 1
        if t1 - start >= seconds:
            return start, calls


def end_to_end(cell: Cell, start: float, calls: List[Call], setup_s: float) -> dict:
    """``peak_mem_gib`` is the window's allocator peak less the bytes the harness
    owned: what the program holds, between its calls as well as in them."""
    values = {
        "setup_s": setup_s,
        "lps_per_s": sum(c.lps for c in calls) / (calls[-1].end - start),
        "peak_mem_gib": max(c.peak_bytes - c.owned for c in calls) / 2**30,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _plain(v):
    """A number for the result line: JSON has no infinities."""
    return v if v is None or math.isfinite(v) else str(v)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            t_process: Optional[float] = None, log=sys.stderr) -> dict:
    """Run ``cell`` once and return the result line (a dict)."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    torch.set_num_threads(2)
    dev = torch.device(device)
    import repro_torch as rt

    phases = {"imports_s": time.perf_counter() - t_process}

    config = dict(cell.config, torch_dtype=getattr(torch, cell.config["dtype"]))
    generator = load_module("generators", config["generator"])
    traffic = load_module("traffic", cell.file["traffic"])
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 64))
    on_card = dev.type == "cuda"
    device = Device(torch, on_card)
    t = time.perf_counter()
    pool = traffic.make_pool(generator, config, cell.params, g, dev)
    device.sync()
    phases["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    keeper = warm(device, rt, traffic, pool, seconds)
    phases["warm_s"] = time.perf_counter() - t
    setup_peak = device.peak()
    gc.collect()
    card = card_info(torch) if on_card else {"name": "cpu", "power_limit": "none"}

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        region = torch.profiler.record_function("bench.window")
        region.__enter__()
    setup_s = time.perf_counter() - t_process
    phases["other_s"] = setup_s - sum(phases.values())
    start, calls = window(device, rt, traffic, pool, seconds, keeper,
                          annotate=torch.profiler.record_function if trace else None)
    run = Run(cell=cell, calls=calls, card=card)
    if trace:
        region.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        # The program's counters cost a sync a dispatch round, so they are
        # read outside the profiled window: one call of each pool entry,
        # the calls the window repeats.
        run.stats = rt.SolveStats()
        for entry in pool:
            traffic.call(rt, entry, run.stats)
        device.sync()
    memory_peak = max([setup_peak, device.peak()] + [c.peak_bytes for c in calls])

    # The window has closed: read the counters, then the check.
    run.lps = sum(c.lps for c in calls)
    run.pivots = sum(int(c.sol.iterations.to(torch.int64).sum()) for c in calls)
    phase1 = [int((traffic.rows(e, slice(None))[1] < 0).any(dim=1).sum()) for e in pool]
    run.phase1_lps = sum(phase1[c.entry] for c in calls)
    if trace:
        from bench import trace as trace_mod

        BUILD.mkdir(parents=True, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="trace-", suffix=".json", dir=BUILD)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            run.trace = trace_mod.read(path)
        finally:
            os.unlink(path)
        del prof
        metrics = per_layer(run)
    else:
        metrics = end_to_end(cell, start, calls, setup_s)

    from bench import judge

    numbers, sample, unresolved = judge.window(
        traffic, pool, [(c.entry, c.sol) for c in calls], seed, cell.file["sample"])
    for c in calls:
        c.sol = None
    del pool, keeper
    gc.collect()
    device.release()
    numbers.update(judge.against_reference(sample))
    correct, checks = judge.verdict(numbers, cell.file["limits"])

    result = {
        "correct": bool(correct),
        "attempted": run.lps,
        "failed": unresolved,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": card["name"],
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)},
        "card": card,
        "calls": len(calls),
        "setup_phases": phases,
    }
    if trace and run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=log)
    result["checks"] = {name: {"value": _plain(c["value"]), "limit": c["limit"]}
                        for name, c in checks.items()}
    return result

