"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface (``csrc/*.cuh`` are
shared headers).  It is compiled by
``nvcc`` on first use into ``build/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``) and loaded with ``ctypes``; the library's
file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  A failed ``nvcc``
raises.

The flags pin the determinism contract: ``-fmad=false`` keeps every
multiply and add a separately rounded operation (as in the plain
PyTorch versions), and there is no ``--use_fast_math``.  ``-Xptxas -v``
records each kernel's registers, shared memory and spills in a ``.log``
beside the library (:func:`ptxas_report`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"

#: The kernel sources of the port, one shared library each.
SOURCES = ("simplex", "hyperbox", "revised", "pdhg")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found; the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_source(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns ``{"name", "path", "built", "seconds", "log"}``; ``log`` is the
    compiler's ``-Xptxas -v`` output of the build that made the library.
    """
    path = library_path(name)
    log = path.with_suffix(".log")
    if path.exists() and log.exists():
        return dict(name=name, path=str(path), built=False, seconds=0.0,
                    log=log.read_text())
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    text = proc.stdout + proc.stderr
    log.write_text(text)
    os.replace(tmp, path)
    return dict(name=name, path=str(path), built=True, seconds=seconds, log=text)


def compile_all(names: Iterable[str] = SOURCES) -> List[dict]:
    """Compile several sources at once, one ``nvcc`` each, started together."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(compile_source, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(compile_source(name)["path"])
            _LIBS[name] = lib
        return lib


def ptxas_report(log: str) -> List[dict]:
    """Per-kernel registers, shared memory and spill bytes from ``-Xptxas -v``."""
    out: List[dict] = []
    cur: dict = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out
