"""The port's LP solves over a device mesh (``mesh=``) against its own
unsplit solves and against the reference's sharded solves.

Four gloo ranks are spawned on the CPU (``tests/torch_mesh_worker.py``),
each with its own ``FileStore`` under the test's temporary directory, on
two meshes: ``(data=4, model=1)`` and ``(data=2, model=2)``.  Every rank
is given the same batches and must return, bit for bit, the port's
unsplit solution, with the same ``SolveStats`` (the kernel
specialisation split between ``compiles`` and ``cache_hits`` depends on
which solve ran first; their sum does not).  The reference's
``repro.solve(..., mesh=...)`` runs once, in one JAX subprocess with 8
forced CPU devices, on a ``(4,)`` mesh whose axes are ``Auto`` (on an
Explicit-typed mesh the reference's sharded solve raises, ROADMAP.md
queue 3); the port matches it under the parity contract: status,
iterations and basis exactly, objective and x within 1e-5 relative in
float32 and 1e-9 in float64.  Also here: the odd batch's padding, the
round modes, a ``SharedLPBatch``, the box path (B = 13 raises in both
packages), ``LPEngine`` in flush and continuous mode, and faults on one
rank (a transient one retried on every rank, a ``KernelError`` raised on
every rank).  Each group fails by its own timeout rather than hang.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import lp as jlp

import torch_mesh_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("data4", "data2_model2")
CASES = [name for name, _, _ in worker.solve_cases()] + ["box16", "box13_problem"]
#: The cases the reference also runs (on its (4,) mesh).
REFERENCE_CASES = ["odd", "w28", "mixed_every_k_basis", "mixed_chunked_scratch", "shared",
                   "box16", "box13_problem"]
REFERENCE_TIMEOUT_S = 300

_REFERENCE = textwrap.dedent('''
    import os, sys
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    from jax.sharding import AxisType
    import repro
    from repro.core import lp as jlp
    from repro.serve.engine import LPEngine

    tmp = sys.argv[1]
    arr = dict(np.load(os.path.join(tmp, "inputs.npz")))
    mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:4])
    O = repro.SolveOptions
    cases = [("odd", "odd", O()), ("w28", "w28", O()),
             ("mixed_every_k_basis", "mixed",
              O(compaction="every_k", resume="basis", compact_every=4)),
             ("mixed_chunked_scratch", "mixed",
              O(compaction="chunked", resume="scratch", compact_every=4)),
             ("shared", "shared", O())]
    out = {}

    def put(key, sol):
        for f in ("objective", "x", "status", "iterations", "basis"):
            if getattr(sol, f, None) is not None:
                out[f"{key}|{f}"] = np.asarray(getattr(sol, f))

    for name, stem, opts in cases:
        cls = jlp.SharedLPBatch if stem == "shared" else jlp.LPBatch
        put(name, repro.solve(cls(*(jax.numpy.asarray(arr[f"{stem}_{k}"]) for k in "abc")),
                              opts, mesh=mesh))
    box = [arr[f"box16_{k}"] for k in ("lo", "hi", "d")]
    put("box16", repro.solve_hyperbox(*box, mesh=mesh))
    try:
        repro.solve_hyperbox(*(v[:13] for v in box), mesh=mesh)
        out["box13_raised"] = np.asarray(0)
    except ValueError:
        out["box13_raised"] = np.asarray(1)
    put("box13_problem", repro.solve(repro.LPProblem.make(box[2][:13], lo=box[0][:13],
                                                          hi=box[1][:13]), mesh=mesh))
    probs = []
    for stem in ("engine_lp0", "engine_lp1"):
        a, b, c = (arr[f"{stem}_{k}"] for k in "abc")
        probs += [repro.LPProblem.make(c[i:i + 1], a[i:i + 1], bu=b[i:i + 1])
                  for i in range(a.shape[0])]
    probs += [repro.LPProblem.make(arr["engine_box_c"][i:i + 1], lo=arr["engine_box_lo"][i:i + 1],
                                   hi=arr["engine_box_hi"][i:i + 1]) for i in range(4)]
    eng = LPEngine(O(), flush_every=1 << 30, mesh=mesh)
    tickets = [eng.submit(p) for p in probs]
    eng.flush()
    for j, t in enumerate(tickets):
        put(f"engine_flush|{j}", eng.result(t))
    np.savez(os.path.join(tmp, "reference.npz"), **out)
''')


def _mixed(rng, dtype=np.float64):
    """``tests/test_compaction.py``'s mixed 12x6 batch (feasible and
    infeasible starts, unbounded and infeasible LPs)."""
    m, n = 12, 6
    easy = jlp.random_lp_batch(rng, 24, m, n, True, dtype=dtype)
    hard = jlp.random_lp_batch(rng, 8, m, n, False, dtype=dtype)
    a_unb = -np.abs(rng.uniform(0.1, 1.0, size=(2, m, n)))
    c_unb = np.abs(rng.uniform(0.1, 1.0, size=(2, n)))
    a_inf = np.zeros((2, m, n))
    b_inf = np.ones((2, m))
    a_inf[:, 0, 0], a_inf[:, 1, 0], b_inf[:, 1] = 1.0, -1.0, -3.0
    return tuple(np.concatenate(p).astype(dtype) for p in (
        [np.asarray(easy.a), np.asarray(hard.a), a_unb, a_inf],
        [np.asarray(easy.b), np.asarray(hard.b), np.ones((2, m)), b_inf],
        [np.asarray(easy.c), np.asarray(hard.c), c_unb, np.ones((2, n))]))


def write_inputs(path):
    """Every batch of the module, from numpy seeds, into ``path``."""
    out = {}
    for stem, (seed, bsz, m, n) in {"odd": (0, 13, 6, 5), "w28": (1, 8, 28, 28),
                                    "engine_lp0": (5, 10, 6, 4),
                                    "engine_lp1": (6, 10, 9, 5)}.items():
        b = jlp.random_lp_batch(np.random.default_rng(seed), bsz, m, n, True)
        out.update({f"{stem}_{k}": np.asarray(getattr(b, k)) for k in "abc"})
    out.update({f"mixed_{k}": v for k, v in zip("abc", _mixed(np.random.default_rng(42)))})
    sb = jlp.random_shared_lp_batch(np.random.default_rng(3), 13, 8, 6, True)
    out.update({f"shared_{k}": np.asarray(getattr(sb, k)) for k in "abc"})
    rng = np.random.default_rng(4)
    lo = rng.uniform(-2.0, 0.0, (16, 5)).astype(np.float32)
    out.update(box16_lo=lo, box16_hi=(lo + rng.uniform(0.5, 3.0, (16, 5))).astype(np.float32),
               box16_d=rng.normal(size=(16, 5)).astype(np.float32))
    rng = np.random.default_rng(7)
    lo = rng.uniform(-2.0, 0.0, (4, 3)).astype(np.float32)
    out.update(engine_box_lo=lo, engine_box_hi=(lo + 1.0).astype(np.float32),
               engine_box_c=rng.normal(size=(4, 3)).astype(np.float32))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_solve")
    write_inputs(tmp / "inputs.npz")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(ROOT, "src")}
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = worker.spawn("solve", 4, tmp)
        _, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err
    return ranks, dict(np.load(tmp / "reference.npz"))


def _sol(runs, rank, key):
    return runs[0][rank]["mesh"][key][0]


def _assert_parity(port, ref, prefix):
    """The reference's sharded solution against the port's, by the parity contract."""
    status = ref[f"{prefix}|status"]
    assert np.array_equal(port["status"].numpy(), status)
    assert np.array_equal(port["iterations"].numpy(), ref[f"{prefix}|iterations"])
    if f"{prefix}|basis" in ref and "basis" in port:
        assert np.array_equal(port["basis"].numpy(), ref[f"{prefix}|basis"])
    ok = status == jlp.OPTIMAL
    for f in ("objective", "x"):
        got, want = port[f].numpy(), ref[f"{prefix}|{f}"]
        if got.dtype == np.float64:
            np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-9)
        else:
            np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port["objective"].numpy()[~ok], ref[f"{prefix}|objective"][~ok])


def test_every_rank_finished(runs):
    errors = [r["error"] for r in runs[0] if "error" in r]
    assert not errors, errors[0]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_split_solve_is_bit_equal_to_the_unsplit_solve(runs, mesh, case):
    ranks = runs[0]
    sol, stats = ranks[0]["mesh"][(mesh, case)]
    want, want_stats = ranks[0]["meshless"][case]
    assert worker.same_bits(sol, want)
    for k in want_stats:
        if k not in ("compiles", "cache_hits"):
            assert stats[k] == want_stats[k], k
    if want_stats:
        assert (stats["compiles"] + stats["cache_hits"]
                == want_stats["compiles"] + want_stats["cache_hits"])


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_returns_the_whole_solution_and_counters(runs, mesh):
    ranks = runs[0]
    for case in CASES:
        sol, stats = ranks[0]["mesh"][(mesh, case)]
        for r in ranks[1:]:
            assert worker.same_bits(r["mesh"][(mesh, case)][0], sol), case
            assert r["mesh"][(mesh, case)][1] == stats, case


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_matches_the_reference_sharded_solve(runs, case):
    _assert_parity(_sol(runs, 0, ("data4", case)), runs[1], case)


def test_odd_batch_padding_is_trimmed(runs):
    """13 LPs on 4 and on 2 blocks: 13 rows come back, every one solved."""
    for mesh in MESHES:
        sol = _sol(runs, 0, (mesh, "odd"))
        assert sol["status"].shape == (13,) and sol["x"].shape == (13, 5)
        assert (sol["status"] == jlp.OPTIMAL).all()


@pytest.mark.parametrize("mesh", MESHES)
def test_box_batch_that_does_not_split_raises_in_both_packages(runs, mesh):
    for r in runs[0]:
        assert "do not split evenly" in r["mesh"][(mesh, "box13_raised")]
    assert runs[1]["box13_raised"] == 1


@pytest.mark.parametrize("mode", ["flush", "continuous"])
@pytest.mark.parametrize("mesh", MESHES)
def test_engine_on_a_mesh_is_bit_equal_to_the_unsplit_engine(runs, mesh, mode):
    ranks = runs[0]
    for r in ranks:
        got, want = r["engine_mesh"][mesh][mode], r["engine_meshless"][mode]
        assert len(got) == len(want) == 24
        assert all(worker.same_bits(a, b) for a, b in zip(got, want))
        assert r["engine_mesh"][mesh][f"{mode}_stats"] == r["engine_meshless"][f"{mode}_stats"]


def test_engine_flush_matches_the_reference_engine(runs):
    for j, sol in enumerate(runs[0][0]["engine_mesh"]["data4"]["flush"]):
        _assert_parity(sol, runs[1], f"engine_flush|{j}")


def test_a_transient_fault_on_one_rank_is_retried_on_every_rank(runs):
    ranks = runs[0]
    want = ranks[0]["meshless"]["odd"][0]
    for r in ranks:
        sol, stats = r["transient"]
        assert worker.same_bits(sol, want)
        assert stats["retries"] == 1
    assert ranks[1]["transient"][1]["faults_injected"] == 1


def test_a_kernel_error_on_one_rank_is_raised_on_every_rank(runs):
    for r in runs[0]:
        assert r["kernel_error"] == ("KernelLaunchError", 0)


def test_constrain_redistributes_a_dtensor(runs):
    for r in runs[0]:
        assert r["constrain"] == ("S(0)", "R")  # Shard(0) on data, Replicate() on model


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """No quiet switch to gloo: NCCL with more ranks on a host than it has
    cards raises before any group is made."""
    from repro_torch.launch import mesh as mesh_lib

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="4 ranks on this host have 1 card"):
        mesh_lib.init_distributed("nccl", rank=0, world_size=4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_distributed(rank=0, world_size=1)
