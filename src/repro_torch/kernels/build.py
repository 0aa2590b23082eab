"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface (``csrc/*.cuh`` are
shared headers).  It is compiled by
``nvcc`` on first use into ``build/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``) and loaded with ``ctypes``; the library's
file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  A missing toolkit, a
failed ``nvcc`` or a library that does not load raises
:class:`KernelBuildError`, and a launch that returns a CUDA error raises
:class:`KernelLaunchError` (:func:`launch_error`): both are
:class:`KernelError`, which the recovery layer never retries
(``runtime/chaos.py:NON_TRANSIENT``).

The flags pin the determinism contract: ``-fmad=false`` keeps every
multiply and add a separately rounded operation (as in the plain
PyTorch versions), and there is no ``--use_fast_math``.  ``-Xptxas -v``
records each kernel's registers, shared memory and spills in a ``.log``
beside the library (:func:`ptxas_report`).

Several processes may build at once (the ranks of a mesh, each loading
the kernels it launches): :func:`compile_source` holds a file lock
beside the library, so ranks that miss it run one ``nvcc`` between
them, and it writes the log and then the library through temporary
files renamed into place, so a reader never sees half of either.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Set, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"

#: The kernel sources of the port, one shared library each.
SOURCES = ("simplex", "hyperbox", "revised", "pdhg")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

class KernelError(RuntimeError):
    """A kernel that did not build, load or launch: not transient, never retried."""


class KernelBuildError(KernelError):
    """A kernel source that did not build or load."""


class KernelLaunchError(KernelError):
    """A kernel launch that returned a CUDA error (a sticky one stays for the process)."""


def launch_error(lib: ctypes.CDLL, source: str, err: int, what: str) -> KernelLaunchError:
    """The error of a launch of ``source``'s library that returned CUDA error ``err``."""
    describe = getattr(lib, f"{source}_error_string")
    describe.restype = ctypes.c_char_p
    describe.argtypes = [ctypes.c_int]
    return KernelLaunchError(f"{what} launch failed: CUDA error {err} ({describe(err).decode()})")


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: Kernel specialisations launched so far in this process: one
#: ``(source, dtype, variant)`` key per kernel variant and dtype, where a
#: wrapper's plain version on CPU tensors counts as the variant
#: ``"plain"``.  ``SolveStats.compiles``/``cache_hits`` diff its size
#: around each backend call (``core/backends.py:kernel_cache_size``).
SPECIALIZATIONS: Set[Tuple[str, str, str]] = set()


#: Held while a wrapper raises its launch counters: speculative chunks
#: launch from several threads at once (``core/dispatch.py``).
LAUNCH_LOCK = threading.Lock()


def note_specialization(source: str, dtype, variant: str) -> None:
    """Record that a launch used ``source``'s ``variant`` in ``dtype``."""
    SPECIALIZATIONS.add((source, str(dtype), variant))


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
    raise KernelBuildError("nvcc not found; the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _file_lock(path: Path):
    """An exclusive ``flock`` on ``path`` for the block (across processes)."""
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def compile_source(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns ``{"name", "path", "built", "seconds", "log"}``; ``log`` is the
    compiler's ``-Xptxas -v`` output of the build that made the library.
    Safe across processes: the build runs under a file lock, and the log
    and the library each appear whole, the log first.
    """
    path = library_path(name)
    log = path.with_suffix(".log")

    def cached():
        return dict(name=name, path=str(path), built=False, seconds=0.0,
                    log=log.read_text())

    if path.exists() and log.exists():
        return cached()
    path.parent.mkdir(parents=True, exist_ok=True)
    with _file_lock(path.with_suffix(".lock")):
        if path.exists() and log.exists():  # another process built it meanwhile
            return cached()
        stem = f".{path.name}.{os.getpid()}.{threading.get_ident()}"
        tmp = path.with_name(f"{stem}.tmp")
        tmp_log = path.with_name(f"{stem}.log.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        text = proc.stdout + proc.stderr
        tmp_log.write_text(text)
        os.replace(tmp_log, log)
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
            path = compile_source(name)["path"]
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path}: {exc}") from exc
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
