"""Build and load the port's native libraries: the CUDA kernels and the
torch operators that launch them.

Each library is built the first time it is used (or when its source, a
shared header of its kind or its prelude is newer than the library) into
``egonet_tpu_torch/_build/`` (listed in ``.gitignore``):

* a kernel, ``csrc/<name>.cu``: compiled by ``nvcc`` for ``sm_90a`` into a
  shared library with a plain C interface, which the CUDA operators link
  (the port launches a kernel only through its operator).  Nothing there
  includes PyTorch's headers, so a build takes seconds.
* the operators, ``csrc/egonet_ops.cpp`` (``libegonet_ops.so``: the schemas
  of ``egonet::fused_basic_block``, ``egonet::fused_basic_block_stencil``,
  ``egonet::rigid_solve`` and ``egonet::bn_act``, their CPU and Meta
  kernels and the launch counts) and, on the card,
  ``csrc/egonet_ops_cuda.cpp`` (``libegonet_ops_cuda.so``: their CUDA
  kernels, linked against both default fused-block libraries,
  ``librigid_solve.so``, ``libbn_act.so`` and ``libegonet_ops.so``, found
  beside it through the rpath ``$ORIGIN``):
  compiled by the system C++ compiler (``c++``) against the installed
  torch's headers and libraries and loaded with ``torch.ops.load_library``
  (:func:`load_ops`).

A library is named either by its source (``"<name>"``, ``csrc/<name>.cu``)
or as ``(name, source, prelude)``: ``csrc/<source>`` (``.cu`` unless the
source names its extension) compiled with the C text ``prelude`` included
first (written to ``_build/<name>.inc``; a changed prelude rebuilds the
library).  That is how a kernel's wrapper lists, from Python, the template
instantiations its launch plans need (``library(plans)``; ``chip_smoke.py``
builds its tile sweeps' libraries so and launches them itself), and how
the CUDA operators get each width's default plan (:func:`_plans_prelude`).

Every :func:`build` holds a file lock in ``_build/`` (``fcntl``), so
processes that need a library at once (pytest-xdist workers) build it once:
the others wait, then load the first one's result.  A missing compiler or a
failed build raises with the compiler's output.  Nothing here runs at import
time: the CPU tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O2", "-std=c++20", "-fPIC"]
# the operator libraries and the kernel libraries the CUDA one links
OPS, OPS_CUDA = "egonet_ops", "egonet_ops_cuda"
_LINKS = {OPS: (), OPS_CUDA: (OPS, "fused_basic_block",
                              "fused_basic_block_stencil", "rigid_solve",
                              "bn_act")}
# the ops' numbers in the launch counts (csrc/egonet_ops.h, egonet::Op);
# TILED_MULTICAST: the tiled op's launches as clusters sharing each weight
# slab, counted besides TILED
TILED, STENCIL, RIGID, BN_ACT, TILED_MULTICAST = 0, 1, 2, 3, 4

# device types whose operator libraries are loaded
_OPS_LOADED: set = set()
_COUNTS = None
# held while the operator libraries are built and loaded: the first call
# may come from any thread (a server's dispatch thread), and two builds of
# one library would race on its files
LOCK = threading.RLock()
# per-library build record: {"seconds": float, "log": str} (empty when
# the library was already up to date)
BUILD_INFO: dict = {}


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvcc() -> str:
    path = os.path.join(_cuda_home(), "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "need the CUDA toolkit")
    return found


def _cxx() -> str:
    """The system C++ compiler (``c++`` on the PATH), whose libstdc++ is the
    one torch runs with.  ``CXX`` is not read: it may name a separately
    installed GCC of another libstdc++, and a library built with that
    crashes in its first formatted error message."""
    found = shutil.which("c++")
    if found is None:
        raise RuntimeError("no C++ compiler (c++) on the PATH: the fused "
                           "BasicBlock operators are built from csrc/"
                           "egonet_ops*.cpp at first use")
    return found


def _spec(lib):
    """(name, source, prelude or None) of a library given as a name or as
    such a tuple."""
    return (lib, lib, None) if isinstance(lib, str) else tuple(lib)


def _is_cpp(source: str) -> bool:
    return source.endswith(".cpp")


def _paths(name: str, source: str | None = None):
    source = source or name
    if "." not in source:
        source += ".cu"
    return (os.path.join(CSRC, source),
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
    shared header of its kind (``csrc/*.cuh`` for a kernel; ``csrc/*.h``
    and ``csrc/*.cuh`` for the operators, whose CPU kernels of the rigid
    solve and of bn_act are ``rigid_solve.cuh``'s and ``bn_act.cuh``'s
    routines)."""
    src, lib = _paths(name, source)
    if not os.path.exists(lib):
        return True
    ext = (".h", ".cuh") if _is_cpp(src) else ".cuh"
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(ext)]
    if prelude is not None:
        deps.append(_prelude_path(name))
    return os.path.getmtime(lib) < max(map(os.path.getmtime, deps))


@contextlib.contextmanager
def _file_lock():
    """Hold ``_build/.lock`` exclusively (across processes)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile_cmd(name, source, prelude, out):
    """The command that compiles a library: a kernel to the library ``out``,
    an operator library to the object ``out``."""
    src, _ = _paths(name, source)
    pre = [] if prelude is None else ["-include", _prelude_path(name)]
    if not _is_cpp(src):
        return [_nvcc(), *NVCC_FLAGS, *pre, "-o", out, src]
    import torch
    from torch.utils import cpp_extension
    inc = list(cpp_extension.include_paths())
    if name == OPS_CUDA:
        inc.append(os.path.join(_cuda_home(), "include"))
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return [_cxx(), *CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            *(f"-I{d}" for d in inc), *pre, "-c", "-o", out, src]


def _link_cmd(name, obj, out):
    """Link an operator library: its object, the libraries of ``_LINKS``
    (found at run time beside it), torch's c10 and torch_cpu (and c10_cuda
    for the CUDA one)."""
    from torch.utils import cpp_extension
    torch_libs = ["-lc10", "-ltorch_cpu"]
    if name == OPS_CUDA:
        torch_libs.insert(1, "-lc10_cuda")
    return [_cxx(), "-shared", "-o", out, obj, f"-Wl,-soname,lib{name}.so",
            "-Wl,-rpath,$ORIGIN", f"-L{BUILD_DIR}",
            *(f"-l{dep}" for dep in _LINKS[name]),
            *(f"-L{d}" for d in cpp_extension.library_paths()), *torch_libs]


def build(libs) -> None:
    """Build every stale library in ``libs`` (names or (name, source,
    prelude) tuples), under the build directory's file lock: every
    compiler started together, then the operator libraries linked in list
    order (list a library after those it links).  Raises with the
    compiler's output on failure."""
    specs = [_spec(lib) for lib in libs]
    with _file_lock():
        for name, _, prelude in specs:
            if prelude is not None:
                _write_prelude(name, prelude)
        todo = [s for s in specs if _stale(*s)]
        if not todo:
            return
        t0 = time.perf_counter()
        procs = []
        for name, source, prelude in todo:
            lib = _paths(name, source)[1]
            out = f"{lib}.{os.getpid()}.{'o' if _is_cpp(source) else 'tmp'}"
            procs.append((name, subprocess.Popen(
                _compile_cmd(name, source, prelude, out),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out, lib, _is_cpp(source)))
        failed = []
        for name, proc, out, lib, cpp in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: {proc.args[0]} failed "
                              f"({proc.returncode}):\n{log}")
                continue
            if cpp:
                tmp = f"{lib}.{os.getpid()}.tmp"
                linked = subprocess.run(_link_cmd(name, out, tmp),
                                        capture_output=True, text=True)
                os.remove(out)
                log += linked.stdout + linked.stderr
                if linked.returncode != 0:
                    failed.append(f"{name}: linking failed "
                                  f"({linked.returncode}):\n{log}")
                    continue
                out = tmp
            os.replace(out, lib)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "log": log}
        if failed:
            raise RuntimeError("\n".join(failed))


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def _ops_prelude() -> str:
    """Both operator libraries' prelude: what they are built against (a
    new torch rebuilds them) and the stencil's widest width."""
    import torch
    from egonet_tpu_torch.ops import fused_block_stencil as st
    return (f"// torch {torch.__version__}, CUDA {torch.version.cuda}\n"
            f"#define EGONET_STENCIL_MAX_C {st._MAX_C}\n")


def _plans_prelude() -> str:
    """The CUDA operators' plan table: X-macros of each kernel's plan
    fields (its ``_PLAN_FIELDS``, the kernel's struct) and of every width's
    default plan (``plan_for(c)`` for each ``c`` the kernel ``takes``), the
    plans the default kernel libraries hold."""
    from egonet_tpu_torch.ops import fused_block as fb
    from egonet_tpu_torch.ops import fused_block_stencil as st
    text = ""
    for macro, mod in (("TILED", fb), ("STENCIL", st)):
        fields = " ".join(f"X({f})" for f in mod._PLAN_FIELDS)
        rows = " ".join(
            f"X({p.c}, {', '.join(str(getattr(p, f)) for f in mod._PLAN_FIELDS)})"
            for p in mod._default_plans())
        text += (f"#define EGONET_{macro}_FIELDS(X) {fields}\n"
                 f"#define EGONET_{macro}_PLANS(X) {rows}\n")
    return text


def ops_libs(device_type: str = "cpu") -> list:
    """The libraries :func:`load_ops` builds for ``device_type``, as
    :func:`build` takes them (in link order): the CPU operators, and for
    ``"cuda"`` the kernel libraries (both default fused-block libraries,
    the rigid solve's and bn_act's) and the CUDA operators."""
    libs = [(OPS, OPS + ".cpp", _ops_prelude())]
    if device_type == "cuda":
        from egonet_tpu_torch.ops import fused_block as fb
        from egonet_tpu_torch.ops import fused_block_stencil as st
        libs += [fb.library(), st.library(), "rigid_solve", "bn_act",
                 (OPS_CUDA, OPS_CUDA + ".cpp",
                  _ops_prelude() + _plans_prelude())]
    return libs


def _loaded_copy(name: str):
    """The path of a ``lib<name>.so`` that ``torch.ops.load_library``
    already loaded (this build's, or an exported artifact's), else None."""
    import torch
    for path in torch.ops.loaded_libraries:
        if os.path.basename(path) == f"lib{name}.so":
            return path
    return None


def load_ops(device_type: str = "cpu") -> None:
    """Register the operators (both fused BasicBlocks, the rigid solve and
    bn_act) for ``device_type`` (the CPU and Meta kernels; with ``"cuda"``
    the CUDA ones too), building their libraries first where needed.  A library
    already loaded, from here or from an artifact directory, is kept."""
    if device_type in _OPS_LOADED:
        return
    import torch
    with LOCK:
        if device_type in _OPS_LOADED:
            return
        names = [OPS] + ([OPS_CUDA] if device_type == "cuda" else [])
        if not all(_loaded_copy(n) for n in names):
            build(ops_libs(device_type))
        for name in names:
            if _loaded_copy(name) is None:
                torch.ops.load_library(_paths(name, name + ".cpp")[1])
        _OPS_LOADED.add(device_type)


def _counts() -> ctypes.CDLL:
    """The loaded ``libegonet_ops.so`` (ctypes) with its count functions
    typed, once."""
    global _COUNTS
    if _COUNTS is None:
        load_ops("cpu")
        lib = ctypes.CDLL(_loaded_copy(OPS))
        lib.egonet_launches.restype = ctypes.c_int64
        lib.egonet_set_launches.argtypes = [ctypes.c_int, ctypes.c_int64]
        _COUNTS = lib
    return _COUNTS


def launches(op: int) -> int:
    """Kernel launches of op ``op`` (:data:`TILED`, :data:`STENCIL`,
    :data:`RIGID`, :data:`BN_ACT`, :data:`TILED_MULTICAST`) since the
    count was last set: the operator's CUDA kernel counts each launch."""
    return int(_counts().egonet_launches(op))


def set_launches(op: int, n: int) -> None:
    _counts().egonet_set_launches(op, n)


class CountedWrapper:
    """A kernel's public wrapper: calls ``fn``; its ``launches`` reads and
    sets the op's launch count in ``libegonet_ops.so``, the one count of
    the kernel's launches (``wrapper.launches = 0`` resets it)."""

    def __init__(self, fn, op: int):
        functools.update_wrapper(self, fn)
        self._fn, self._op = fn, op

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    @property
    def launches(self) -> int:
        return launches(self._op)

    @launches.setter
    def launches(self, n: int) -> None:
        set_launches(self._op, n)


def counted(op: int):
    """Decorator: :class:`CountedWrapper` of op ``op``."""
    return lambda fn: CountedWrapper(fn, op)
