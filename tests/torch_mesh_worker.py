"""Rank processes for the port's mesh tests (gloo on the CPU).

Imported by spawned children, so it imports torch and ``repro_torch``
only.  :func:`spawn` starts ``nprocs`` ranks of one gloo group, each with
the ``FileStore`` under the test's temporary directory (a fixed
``MASTER_PORT`` would collide between the suite's parallel workers), and
fails by its own timeout instead of hanging.  Each rank runs one
scenario and writes ``rank<r>.pt`` with what the test compares.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds a spawned group may take, start to finish.
GROUP_TIMEOUT_S = 240.0


def spawn(scenario: str, nprocs: int, tmp, timeout: float = GROUP_TIMEOUT_S):
    """Run ``scenario`` on ``nprocs`` gloo ranks; returns each rank's saved dict."""
    tmp = str(tmp)
    store = os.path.join(tmp, "store")
    ctx = mp.start_processes(_rank_main, args=(nprocs, store, tmp, scenario), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {nprocs}-rank group of {scenario!r} passed {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def _rank_main(rank: int, world: int, store: str, tmp: str, scenario: str) -> None:
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    backend, device = CARD_BACKENDS.get(scenario, ("gloo", "cpu"))
    mesh_lib.init_distributed(backend, device=device, timeout_s=120.0, rank=rank,
                              world_size=world, store=dist.FileStore(store, world))
    try:
        if ":" in scenario:  # "module:function" of another worker file
            import importlib

            mod, _, fn = scenario.partition(":")
            out = getattr(importlib.import_module(mod), fn)(rank, world, tmp)
        else:
            out = SCENARIOS[scenario](rank, world, tmp)
    except Exception:  # the test reads the traceback
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _meshes(world: int):
    from repro_torch.launch import mesh as mesh_lib

    return {"data4": mesh_lib.make_local_mesh(device="cpu"),
            "data2_model2": mesh_lib.make_local_mesh(model=2, device="cpu")}


def sol_dict(sol) -> dict:
    return {f: getattr(sol, f).clone() for f in ("objective", "x", "status", "iterations",
                                                 "basis", "y") if getattr(sol, f) is not None}


def stats_dict(stats) -> dict:
    return {k: v for k, v in vars(stats).items() if k != "autotune_log"}


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a tensor (NaNs and signed zeros compare exactly)."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(bits(a[k]), bits(b[k])) for k in a)


def _load(tmp):
    return dict(np.load(os.path.join(tmp, "inputs.npz")))


def _problems(arr, prefix):
    """The single-LP requests of the engine trace (LPProblem a row)."""
    from repro_torch.core.problem import LPProblem

    out = []
    for key in sorted(k for k in arr if k.startswith(prefix) and k.endswith("_a")):
        stem = key[:-2]
        a, b, c = arr[stem + "_a"], arr[stem + "_b"], arr[stem + "_c"]
        for i in range(a.shape[0]):
            out.append(LPProblem.make(c[i:i + 1], a[i:i + 1], bu=b[i:i + 1], device="cpu"))
    for i in range(arr["engine_box_lo"].shape[0]):
        lo, hi = (arr[f"engine_box_{k}"][i:i + 1] for k in ("lo", "hi"))
        out.append(LPProblem.make(arr["engine_box_c"][i:i + 1], lo=lo, hi=hi, device="cpu"))
    return out


#: Solve cases: (name, input stem, options).
def solve_cases():
    from repro_torch import SolveOptions

    return [
        ("odd", "odd", SolveOptions()),
        ("w28", "w28", SolveOptions()),
        ("mixed_off", "mixed", SolveOptions()),
        ("mixed_every_k_basis", "mixed",
         SolveOptions(compaction="every_k", resume="basis", compact_every=4)),
        ("mixed_chunked_scratch", "mixed",
         SolveOptions(compaction="chunked", resume="scratch", compact_every=4)),
        ("mixed_every_k_chunks", "mixed",
         SolveOptions(compaction="every_k", resume="basis", compact_every=4, chunk_size=6)),
        ("mixed_guard_quarantine", "mixed",
         SolveOptions(guardrails=True, quarantine=True, max_iters=3)),
        ("shared", "shared", SolveOptions()),
        ("odd_pdhg_crossover", "odd", SolveOptions(backend="pdhg", max_iters=300,
                                                   crossover=True)),
        ("mixed_pdhg_every_k_basis", "mixed",
         SolveOptions(backend="pdhg", max_iters=200, compaction="every_k", resume="basis",
                      compact_every=50)),
    ]


def _engine_runs(problems, mesh):
    """Flush and continuous runs of one step-driven trace: per ticket a solution."""
    from repro_torch.serve.engine import LPEngine
    from repro_torch import SolveOptions

    out = {}
    eng = LPEngine(SolveOptions(), flush_every=1 << 30, device="cpu", mesh=mesh)
    tickets = [eng.submit(p) for p in problems]
    eng.flush()
    out["flush"] = [sol_dict(eng.result(t)) for t in tickets]
    out["flush_stats"] = stats_dict(eng.stats)
    eng = LPEngine(SolveOptions(), flush_every=1 << 30, max_inflight=6, step_iters=3,
                   device="cpu", mesh=mesh)
    # The box requests (the trace's last four) arrive in waves of one and
    # three, which the mesh's blocks do not divide: one alone, then two LPs
    # before every step, then the other three.
    tickets = [eng.submit(problems[-4])]
    eng.step()
    for i, p in enumerate(problems[:-4]):
        tickets.append(eng.submit(p))
        if i % 2:
            eng.step()
    tickets += [eng.submit(p) for p in problems[-3:]]
    while eng.inflight_count or eng.pending_count:
        eng.step()
    tickets = tickets[1:-3] + tickets[:1] + tickets[-3:]  # back in trace order
    out["continuous"] = [sol_dict(eng.result(t)) for t in tickets]
    out["continuous_stats"] = stats_dict(eng.stats)
    return out


def _solve_all(rank, world, tmp):
    import repro_torch
    from repro_torch import SolveStats
    from repro_torch.core import lp as tlp

    arr = _load(tmp)

    def batch(stem):
        if stem == "shared":
            return tlp.SharedLPBatch(*(torch.as_tensor(arr[f"shared_{k}"]) for k in "abc"))
        return tlp.LPBatch.from_numpy(*(arr[f"{stem}_{k}"] for k in "abc"), device="cpu")

    out = {"meshless": {}, "mesh": {}}
    meshes = _meshes(world)
    for name, stem, opts in solve_cases():
        for mname, mesh in meshes.items():
            stats = SolveStats()
            out["mesh"][(mname, name)] = (sol_dict(repro_torch.solve(batch(stem), opts,
                                                                     mesh=mesh, stats=stats)),
                                          stats_dict(stats))
        stats = SolveStats()
        out["meshless"][name] = (sol_dict(repro_torch.solve(batch(stem), opts, stats=stats)),
                                 stats_dict(stats))
    lo, hi, d = (torch.as_tensor(arr[f"box16_{k}"]) for k in ("lo", "hi", "d"))
    out["meshless"]["box16"] = (sol_dict(repro_torch.solve_hyperbox(lo, hi, d, device="cpu")),
                                {})
    # The same 13 boxes as a boxlike problem: the front door pads them.
    box13 = repro_torch.LPProblem.make(d[:13], lo=lo[:13], hi=hi[:13], device="cpu")
    out["meshless"]["box13_problem"] = (sol_dict(repro_torch.solve(box13)), {})
    for mname, mesh in meshes.items():
        out["mesh"][(mname, "box16")] = (sol_dict(repro_torch.solve_hyperbox(lo, hi, d,
                                                                             mesh=mesh)), {})
        out["mesh"][(mname, "box13_problem")] = (sol_dict(repro_torch.solve(box13, mesh=mesh)),
                                                 {})
        try:
            repro_torch.solve_hyperbox(lo[:13], hi[:13], d[:13], mesh=mesh)
            out["mesh"][(mname, "box13_raised")] = None
        except ValueError as exc:
            out["mesh"][(mname, "box13_raised")] = str(exc)
    problems = _problems(arr, "engine_lp")
    out["engine_meshless"] = _engine_runs(problems, None)
    out["engine_mesh"] = {mname: _engine_runs(problems, mesh) for mname, mesh in meshes.items()}
    out.update(_faults(rank, meshes["data4"], batch("odd")))
    out["constrain"] = _constrain(meshes["data2_model2"])
    return out


def _constrain(mesh):
    """``partition.constrain`` on a replicated ``DTensor``: its placements after."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.sharding import partition

    x = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh, [Replicate(), Replicate()])
    with partition.activate(mesh):
        y = partition.constrain(x, ("batch", None))
    return tuple(str(p) for p in y.placements)


def _faults(rank, mesh, batch):
    """A transient fault on rank 1 only, then a KernelError on rank 2 only."""
    import repro_torch
    from repro_torch import SolveOptions, SolveStats
    from repro_torch.kernels.build import KernelLaunchError
    from repro_torch.runtime import chaos

    class KernelFault(chaos.ChaosMonkey):
        def on_round(self, backend_name):
            super().on_round(backend_name)
            raise KernelLaunchError("injected: a launch failed on this rank")

    opts = SolveOptions(retry_budget=2, retry_backoff=0.0)
    out = {}
    stats = SolveStats()
    monkey = chaos.ChaosMonkey(fail_rounds=(0,)) if rank == 1 else None
    if monkey is not None:
        with chaos.inject(monkey):
            sol = repro_torch.solve(batch, opts, mesh=mesh, stats=stats)
    else:
        sol = repro_torch.solve(batch, opts, mesh=mesh, stats=stats)
    out["transient"] = (sol_dict(sol), stats_dict(stats))
    stats = SolveStats()
    try:
        if rank == 2:
            with chaos.inject(KernelFault()):
                repro_torch.solve(batch, opts, mesh=mesh, stats=stats)
        else:
            repro_torch.solve(batch, opts, mesh=mesh, stats=stats)
        out["kernel_error"] = (None, stats.retries)
    except Exception as exc:
        out["kernel_error"] = (type(exc).__name__, stats.retries)
    return out


def _int8(rank, world, tmp):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.train.compression import dp_allreduce_int8

    arr = _load(tmp)
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    per = arr["int8_g"].shape[0] // world
    mine = {k: torch.as_tensor(arr[k][rank * per:(rank + 1) * per]) for k in ("int8_g", "int8_h")}
    return {k: v.clone() for k, v in dp_allreduce_int8(mine, mesh).items()}


def _card(rank, world, tmp):
    """Ranks on the card (gloo ranks may share it): each solves its own rows
    of a dense, a shared and a box batch, and a PDHG batch with the
    crossover polish, on the kernels, bit-equal to one process's solve;
    its launches; the int8 all-reduce against the plain mean."""
    import repro_torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import lp as tlp
    from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda
    from repro_torch.train.compression import _quantize_with, dp_allreduce_int8

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(0)
    dense = tlp.random_lp_batch(rng, 4 * world + 1, 100, 100, True, device="cpu")
    shared = tlp.random_shared_lp_batch(rng, 4 * world + 1, 30, 20, True, device="cpu")
    box = tlp.random_hyperbox_batch(rng, 8 * world, 7, device="cpu")
    small = tlp.random_lp_batch(rng, 4 * world + 1, 12, 10, True, device="cpu")
    polish = repro_torch.SolveOptions(backend="pdhg", max_iters=300, crossover=True)
    out = {}
    from repro_torch.core.spmd import to_device

    for name, run, alone in (
            ("dense", lambda: repro_torch.solve(dense, mesh=mesh),
             lambda: repro_torch.solve(to_device(dense, dev))),
            ("shared", lambda: repro_torch.solve(shared, mesh=mesh),
             lambda: repro_torch.solve(to_device(shared, dev))),
            ("box", lambda: repro_torch.solve_hyperbox(*box, mesh=mesh),
             lambda: repro_torch.solve_hyperbox(*box, device=dev)),
            # PDHG, then the crossover polish of each rank's rows on its card
            # (the batch stays on the host).
            ("pdhg_crossover", lambda: repro_torch.solve(small, polish, mesh=mesh),
             lambda: repro_torch.solve(to_device(small, dev), polish))):
        for mod in (simplex_cuda, revised_cuda, hyperbox_cuda, pdhg_cuda):
            mod.launches = 0
        got = run()
        launches = (simplex_cuda.launches, revised_cuda.launches, hyperbox_cuda.launches,
                    pdhg_cuda.launches)
        want = alone()
        out[name] = (same_bits(sol_dict(got), sol_dict(want)), launches, str(got.status.device))
    g = torch.as_tensor(np.random.default_rng(1).standard_normal((world, 4096)).astype(np.float32),
                        device=dev)
    red = dp_allreduce_int8({"g": g[rank:rank + 1]}, mesh)["g"]
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    plain = (_quantize_with(g, scale).to(torch.int32).sum(0, keepdim=True).to(torch.float32)
             * scale / torch.tensor(float(world), device=dev))
    out["int8"] = torch.equal(bits(red), bits(plain))
    return out


#: Scenarios on the card: the backend and device of their process group.
CARD_BACKENDS = {"card_gloo": ("gloo", None), "card_nccl": ("nccl", None),
                 "torch_lm_mesh_worker:card_gloo": ("gloo", None),
                 "torch_lm_mesh_worker:card_nccl": ("nccl", None),
                 "torch_train_mesh_worker:card_gloo": ("gloo", None),
                 "torch_train_mesh_worker:card_nccl": ("nccl", None)}

SCENARIOS = {"solve": _solve_all, "int8": _int8, "card_gloo": _card, "card_nccl": _card}
