"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, the first time it is used (or when its
source or a shared ``csrc/*.cuh`` header is newer than the library), and
loaded with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds.  Libraries land in
``egonet_tpu_torch/_build/`` (listed in ``.gitignore``).

A library is named either by its source (``"<name>"``) or as ``(name,
source, prelude)``: ``csrc/<source>.cu`` compiled with the C text
``prelude`` included first (written to ``_build/<name>.inc``; a changed
prelude rebuilds the library).  That is how a wrapper lists, from Python,
the template instantiations its launch plans need.

Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
# per-library build record: {"seconds": float, "log": str} (empty when
# the library was already up to date)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "need the CUDA toolkit")
    return found


def _spec(lib):
    """(name, source, prelude or None) of a library given as a name or as
    such a tuple."""
    return (lib, lib, None) if isinstance(lib, str) else tuple(lib)


def _paths(name: str, source: str | None = None):
    return (os.path.join(CSRC, (source or name) + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _prelude_path(name: str) -> str:
    return os.path.join(BUILD_DIR, name + ".inc")


def _write_prelude(name: str, prelude: str) -> None:
    """Write ``_build/<name>.inc`` unless it already holds ``prelude`` (so
    its time stamp moves only when its text does)."""
    path = _prelude_path(name)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == prelude:
                return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(prelude)
    os.replace(tmp, path)


def _stale(name: str, source: str | None = None,
           prelude: str | None = None) -> bool:
    """The library is missing or older than its source, its prelude or any
    shared ``csrc/*.cuh`` header."""
    src, lib = _paths(name, source)
    if not os.path.exists(lib):
        return True
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    if prelude is not None:
        deps.append(_prelude_path(name))
    return os.path.getmtime(lib) < max(map(os.path.getmtime, deps))


def build(libs) -> None:
    """Compile every stale library in ``libs`` (names or (name, source,
    prelude) tuples), one ``nvcc`` each, all started together.  Raises with
    the compiler's output on failure."""
    specs = [_spec(lib) for lib in libs]
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name, _, prelude in specs:
        if prelude is not None:
            _write_prelude(name, prelude)
    todo = [s for s in specs if _stale(*s)]
    if not todo:
        return
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, source, prelude in todo:
        src, lib = _paths(name, source)
        tmp = f"{lib}.{os.getpid()}.tmp"
        pre = [] if prelude is None else ["-include", _prelude_path(name)]
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *pre, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(lib) -> ctypes.CDLL:
    """The loaded library ``lib`` (a name or a (name, source, prelude)
    tuple), built first if needed."""
    name = _spec(lib)[0]
    loaded = _LIBS.get(name)
    if loaded is None:
        build([lib])
        loaded = ctypes.CDLL(_paths(name)[1])
        _LIBS[name] = loaded
    return loaded
