"""``kernels/build.py:compile_source`` across processes, with ``nvcc`` stubbed.

Ranks of a mesh load their kernels at once.  Two processes that miss the
same library must run one compiler between them (a file lock), and the
log and the library must each appear whole (written to temporary files
and renamed), so the second process reads the first one's log.
"""

import json
import multiprocessing
import os
import stat
import sys

from repro_torch.kernels import build

_STUB = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["STUB_COUNT"], "a") as fh:
    fh.write(f"{{os.getpid()}}\\n")
time.sleep(1.0)
with open(out, "wb") as fh:
    fh.write(b"not a library")
print("ptxas info    : Compiling entry function 'stub_kernel' for 'sm_90a'")
print("ptxas info    : Used 12 registers, 4096 bytes smem")
"""


def _compile(out_path: str) -> None:
    res = build.compile_source("simplex")
    with open(out_path, "w") as fh:
        json.dump(res, fh)


def _stub_toolkit(tmp_path):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_STUB.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return tmp_path / "cuda"


def test_two_processes_run_one_nvcc_and_read_a_whole_log(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_stub_toolkit(tmp_path)))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("STUB_COUNT", str(tmp_path / "count"))
    ctx = multiprocessing.get_context("spawn")
    outs = [str(tmp_path / f"res{i}.json") for i in range(2)]
    procs = [ctx.Process(target=_compile, args=(o,)) for o in outs]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    results = [json.load(open(o)) for o in outs]
    assert len((tmp_path / "count").read_text().split()) == 1  # one nvcc
    assert sorted(r["built"] for r in results) == [False, True]
    assert results[0]["path"] == results[1]["path"]
    assert results[0]["log"] == results[1]["log"]
    assert build.ptxas_report(results[0]["log"]) == [
        dict(kernel="stub_kernel", registers=12, smem_bytes=4096)]
    names = sorted(os.listdir(tmp_path / "build"))
    lib = os.path.basename(results[0]["path"])
    assert names == sorted([lib, lib[:-3] + ".lock", lib[:-3] + ".log"])  # no temporary left


def test_a_later_call_reuses_the_library(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_stub_toolkit(tmp_path)))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("STUB_COUNT", str(tmp_path / "count"))
    first = build.compile_source("hyperbox")
    again = build.compile_source("hyperbox")
    assert first["built"] and not again["built"]
    assert again["log"] == first["log"]
    assert len((tmp_path / "count").read_text().split()) == 1
