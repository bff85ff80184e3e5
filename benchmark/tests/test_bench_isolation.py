"""What the benchmark runs imports neither JAX nor the JAX package
(``egonet_tpu``; ``egonet_tpu_torch`` is the port and passes: top-level
names are compared whole), and the plain reference and its keypoint
families import nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import run

_PROBE = """
import sys, tempfile, torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.tests import tiny
root = tiny.make_root(tempfile.mkdtemp())
spec = run.load_spec(root)
for cell in spec["workloads"]:
    res = run.resolve(spec, cell["name"], root)
    run.execute(res, 3, 0.5, False, "cpu")
print(sorted({m.split('.')[0] for m in sys.modules}))
"""


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "egonet_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "egonet_tpu"}


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "egonet_tpu_torch_probe", None)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", None)
    assert run.banned_modules() == ["jaxlib"]


def _imports(path):
    """Each name a file imports, ``from a import b`` as ``a.b`` (``b`` may
    be a module of package ``a``)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_reference_imports_torch_and_numpy_only():
    """The reference and its keypoint families import torch, numpy, the
    standard library's lookup and one another, and the FLOP walker of
    ``work.py``, which imports no more."""
    ref = os.path.join(run.ROOT, "benchmark", "reference")
    paths = [os.path.join(ref, name) for name in os.listdir(ref)
             if name.endswith(".py")]
    paths.append(os.path.join(run.ROOT, "benchmark", "work.py"))
    for path in paths:
        for m in _imports(path):
            assert (m.split(".")[0] in {"__future__", "importlib", "math",
                                        "os", "numpy", "torch"}
                    or m.startswith(("benchmark.reference.",
                                     "benchmark.work."))
                    or m == "benchmark.work"), (path, m)


def test_no_benchmark_file_imports_jax():
    for dirpath, _dirs, files in os.walk(os.path.join(run.ROOT, "benchmark")):
        for name in files:
            if name.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, name))}
                assert not tops & {"jax", "jaxlib", "flax", "egonet_tpu"}
