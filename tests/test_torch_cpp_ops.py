"""Both fused BasicBlock operators as C++ torch ops (``csrc/egonet_ops.cpp``,
built by ``ops/_build.py`` with the host's ``c++``), on the CPU.

The library is built once per test run (``_build.load_ops``; pytest-xdist
workers share the build through its file lock).  Held here: the two schema
strings (those the Python registration of earlier trees gave, the stencil's
with its optional plan after them, so their ``.pt2`` files still load);
each CPU kernel against
``fused_basic_block_reference`` bit for bit (same ATen ops in the same
order); ``torch.library.opcheck``; the Meta kernels against the contract;
one launch count per op; the build's file lock, its failures and its
records; and an exported bucket run from its artifact directory in a
fresh interpreter that loads no module of ``egonet_tpu_torch.ops`` or
``egonet_tpu_torch.models``, bit-equal to the live program."""

import json
import os
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from egonet_tpu_torch.io import export
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops import fused_block as fb
from egonet_tpu_torch.ops import fused_block_stencil as st
from tests.test_torch_export import CANVAS, N_IMG, _cfg, _inputs
from tests.test_torch_hrnet_routing import _plan_table

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
OPS = ("fused_basic_block", "fused_basic_block_stencil")
SCHEMA = ("egonet::{}(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2"
          "{}) -> Tensor")
PLAN_ARG = {OPS[0]: "", OPS[1]: ", int[]? plan=None"}


@pytest.fixture(scope="module", autouse=True)
def _ops():
    _build.load_ops("cpu")


def _args(rng, n, h, w, c, dtype=torch.bfloat16):
    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * scale).to(dt)
    return (t(n, h, w, c), t(c, 3, 3, c, scale=0.05), t(c, scale=0.1,
                                                         dt=torch.float32),
            t(c, 3, 3, c, scale=0.05), t(c, scale=0.1, dt=torch.float32))


@pytest.mark.parametrize("op", OPS)
def test_schema(op):
    assert str(getattr(torch.ops.egonet, op).default._schema) == \
        SCHEMA.format(op, PLAN_ARG[op])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,h,w,c", [(3, 9, 7, 16), (1, 8, 8, 32),
                                     (5, 6, 11, 48)])
def test_cpu_kernel_is_the_plain_version_bit_for_bit(op, dtype, n, h, w, c):
    """Odd batches, both dtypes (the plain version takes fp32 operands as
    the exact folded block): tolerance 0, the kernel repeats the plain
    version's ATen calls in its order."""
    args = _args(np.random.RandomState(c + n), n, h, w, c, dtype)
    y = getattr(torch.ops.egonet, op)(*args)
    want = fb.fused_basic_block_reference(*args)
    assert y.dtype == dtype and torch.equal(y, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 5, 7, 48)])
def test_opcheck(rng, op, shape):
    """Schema, Meta kernel (with symbolic shapes), CPU kernel and the
    dispatcher's autograd and AOT checks, against each other."""
    torch.library.opcheck(getattr(torch.ops.egonet, op).default,
                          _args(rng, *shape))


def _breaches():
    """{id: (op, x, w1, b1, w2, b2)} the kernels refuse: the breaches of
    test_torch_export.py::test_fake_checks_the_contract (a width no
    multiple of 16, fp32 activations, a stencil wider than 384) and the
    rest of the contract."""
    bf = torch.bfloat16

    def case(op, x_shape=(1, 4, 4, 16), x_dtype=bf, w_shape=None,
             w_dtype=bf, b_numel=None, b_dtype=torch.float32, x_t=False):
        c = x_shape[-1]
        x = torch.empty(x_shape, dtype=x_dtype, device="meta")
        if x_t:
            x = x.transpose(1, 2)
        w = torch.empty(w_shape or (c, 3, 3, c), dtype=w_dtype, device="meta")
        b = torch.empty(b_numel or c, dtype=b_dtype, device="meta")
        return op, x, w, b, w, b

    out = {}
    for op in OPS:
        out.update({
            f"{op}-width8": case(op, x_shape=(1, 4, 4, 8)),
            f"{op}-fp32_x": case(op, x_dtype=torch.float32),
            f"{op}-strided_x": case(op, x_t=True),
            f"{op}-3d_x": case(op, x_shape=(4, 4, 16)),
            f"{op}-fp32_w": case(op, w_dtype=torch.float32),
            f"{op}-w_shape": case(op, w_shape=(16, 3, 3, 32)),
            f"{op}-b_numel": case(op, b_numel=32),
            f"{op}-bf16_b": case(op, b_dtype=torch.bfloat16)})
    out["stencil-width400"] = case(OPS[1], x_shape=(1, 2, 2, 400))
    return out


BREACHES = _breaches()


@pytest.mark.parametrize("name", sorted(BREACHES))
def test_meta_kernel_refuses_every_breach(name):
    op, *args = BREACHES[name]
    with pytest.raises(ValueError):
        getattr(torch.ops.egonet, op)(*args)


@pytest.mark.parametrize("op", OPS)
def test_meta_kernel_shapes_the_output(op):
    x, w1, b1, w2, b2 = (t.to("meta") for t in _args(
        np.random.RandomState(1), 2, 4, 6, 384 if op == OPS[1] else 512))
    y = getattr(torch.ops.egonet, op)(x, w1, b1, w2, b2)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_meta


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_stencil_plan_picks_no_function_off_the_card(device):
    """A plan given to the stencil operator (its fields, as the wrapper's
    ``tile=`` passes them) changes nothing off the card: the CPU kernel is
    the plain version bit for bit, the Meta kernel the contract's shape and
    dtype (and its checks), and opcheck holds the schema with the plan."""
    args = _args(np.random.RandomState(3), 2, 5, 9, 48)
    plan = st.plan_for(48, (32, 1))
    fields = [getattr(plan, f) for f in st._PLAN_FIELDS]
    op = torch.ops.egonet.fused_basic_block_stencil.default
    args = tuple(t.to(device) for t in args)
    y = op(*args, fields)
    assert y.shape == args[0].shape and y.dtype == torch.bfloat16
    if device == "cpu":
        assert torch.equal(y, fb.fused_basic_block_reference(*args))
        torch.library.opcheck(op, args, {"plan": fields})
    else:
        assert y.is_meta
        with pytest.raises(ValueError, match="x must be"):
            op(args[0].float(), *args[1:], fields)


@pytest.mark.parametrize("wrapper,op", [(fb.fused_basic_block, _build.TILED),
                                        (st.fused_basic_block_stencil,
                                         _build.STENCIL)])
def test_one_launch_count_per_op(wrapper, op):
    """The wrapper's ``launches`` is the C++ count: set through either
    side, read through either; the two ops' counts are apart."""
    other = _build.STENCIL if op == _build.TILED else _build.TILED
    saved, saved_other = _build.launches(op), _build.launches(other)
    try:
        wrapper.launches = 7
        assert _build.launches(op) == 7
        _build.set_launches(op, 8)
        assert wrapper.launches == 8
        _build.set_launches(other, 0)
        assert _build.launches(other) == 0 and wrapper.launches == 8
        wrapper.launches = 0
        assert _build.launches(op) == 0
    finally:
        _build.set_launches(op, saved)
        _build.set_launches(other, saved_other)


def test_multicast_count_is_apart_from_the_launch_count():
    """The tiled wrapper's ``multicast_launches`` is the C++ count
    ``TILED_MULTICAST``, set and read through either side, apart from the
    op's ``launches``."""
    wrapper = fb.fused_basic_block
    saved = (_build.launches(_build.TILED),
             _build.launches(_build.TILED_MULTICAST))
    try:
        wrapper.launches = 5
        wrapper.multicast_launches = 2
        assert _build.launches(_build.TILED_MULTICAST) == 2
        _build.set_launches(_build.TILED_MULTICAST, 3)
        assert wrapper.multicast_launches == 3 and wrapper.launches == 5
    finally:
        _build.set_launches(_build.TILED, saved[0])
        _build.set_launches(_build.TILED_MULTICAST, saved[1])


@pytest.mark.parametrize("macro,mod", [("TILED", fb), ("STENCIL", st)])
def test_cuda_plan_table_is_the_default_plans(macro, mod):
    """The CUDA operators' plan table (generated into their prelude) holds
    each width the kernel takes, with its default plan's fields in the
    kernel struct's order, and no other width."""
    table = _plan_table(macro)
    assert sorted(table) == [c for c in range(16, mod._MAX_C + 1, 16)
                             if mod.takes(c)]
    for c, fields in table.items():
        plan = mod.plan_for(c)
        assert fields == [getattr(plan, f) for f in mod._PLAN_FIELDS]
    assert {48, 96, 192, 384, 32, 64, 128, 256} <= set(table)


# ---------------------------------------------------------------- the build

def _fake_compiler(path, log, fail=False):
    """An executable standing in for nvcc / c++: sleeps, records its call
    in ``log``, writes its ``-o`` output (or fails, printing 'boom')."""
    path.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        if {fail!r}:
            print("boom: no such thing"); sys.exit(3)
        time.sleep(1.0)
        with open({str(log)!r}, "a") as f:
            f.write(" ".join(sys.argv[1:2]) + "\\n")
        open(sys.argv[sys.argv.index("-o") + 1], "w").close()
        """))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _stand_in(tmp_path, monkeypatch, fail=False):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path / "csrc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(_build.CSRC)
    for src in ("k.cu", "k.cpp"):
        (tmp_path / "csrc" / src).write_text("")
    tool = _fake_compiler(tmp_path / "cc", tmp_path / "calls", fail)
    monkeypatch.setattr(_build, "_nvcc", lambda: tool)
    monkeypatch.setattr(_build, "_cxx", lambda: tool)
    return tool


def test_concurrent_builds_build_once(tmp_path, monkeypatch):
    """Three processes ask for one stale library at once: the file lock
    lets the first build it; the others wait and find it built."""
    tool = _stand_in(tmp_path, monkeypatch)
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {ROOT!r})
        from egonet_tpu_torch.ops import _build
        _build.CSRC, _build.BUILD_DIR = {_build.CSRC!r}, {_build.BUILD_DIR!r}
        _build._nvcc = lambda: {tool!r}
        _build.build(["k"])
        print(sorted(_build.BUILD_INFO))
        """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert (tmp_path / "calls").read_text().count("\n") == 1
    assert sorted(o[0].strip() for o in outs) == ["['k']", "[]", "[]"]
    assert os.path.exists(os.path.join(_build.BUILD_DIR, "libk.so"))


def test_operator_build_compiles_links_and_records(tmp_path, monkeypatch):
    """An operator library (.cpp) is compiled, then linked, and enters
    BUILD_INFO with its seconds; a fresh library is not rebuilt."""
    _stand_in(tmp_path, monkeypatch)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setitem(_build._LINKS, "k", ())
    _build.build([("k", "k.cpp", "// torch x\n")])
    assert (tmp_path / "calls").read_text().split() == ["-O2", "-shared"]
    assert _build.BUILD_INFO["k"]["seconds"] >= 1.0
    assert not _build._stale("k", "k.cpp", "// torch x\n")
    _build.build([("k", "k.cpp", "// torch x\n")])
    assert (tmp_path / "calls").read_text().count("\n") == 2


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _stand_in(tmp_path, monkeypatch, fail=True)
    monkeypatch.setitem(_build._LINKS, "k", ())
    for lib in ("k", ("k", "k.cpp", None)):
        with pytest.raises(RuntimeError, match="boom: no such thing"):
            _build.build([lib])
        assert not os.path.exists(os.path.join(_build.BUILD_DIR, "libk.so"))


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="c\\+\\+"):
        _build._cxx()


# ------------------------------------------------------- the artifacts

def _parent_schema_pt2(path):
    """A .pt2 written by a process that registers the ops as earlier trees
    did (``torch.library.custom_op`` with their annotations) and never
    loads the C++ library: one node of each op."""
    code = textwrap.dedent(f"""\
        import torch

        for name in ("fused_basic_block", "fused_basic_block_stencil"):
            @torch.library.custom_op("egonet::" + name, mutates_args=(),
                                     device_types="cuda")
            def op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
                raise AssertionError("not run")

            @op.register_fake
            def _(x, w1, b1, w2, b2):
                return torch.empty_like(x)

        class M(torch.nn.Module):
            def forward(self, x, w1, b1, w2, b2):
                y = torch.ops.egonet.fused_basic_block(x, w1, b1, w2, b2)
                return torch.ops.egonet.fused_basic_block_stencil(
                    y, w1, b1, w2, b2)

        x = torch.zeros(2, 5, 6, 16, dtype=torch.bfloat16)
        w1, w2 = (torch.zeros(16, 3, 3, 16, dtype=torch.bfloat16)
                  for _ in range(2))
        b1, b2 = torch.zeros(16), torch.zeros(16)
        torch.export.save(torch.export.export(M(), (x, w1, b1, w2, b2)),
                          {str(path)!r})
        print(torch.ops.egonet.fused_basic_block.default._schema)
        """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip()


def test_a_pt2_of_the_earlier_schema_loads(rng, tmp_path):
    path = tmp_path / "old.pt2"
    assert _parent_schema_pt2(path) == SCHEMA.format(OPS[0], "")
    program = torch.export.load(str(path))
    args = _args(rng, 2, 5, 6, 16)
    with torch.inference_mode():
        got = program.module()(*args)
    want = fb.fused_basic_block_reference(
        fb.fused_basic_block_reference(*args), *args[1:])
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A shrunk bf16 HRNet's bucket-8 program exported on the CPU, with
    its checkpoint, one input and the live output."""
    model = EgoNet(_cfg(), device="cpu")
    out = str(tmp_path_factory.mktemp("art"))
    manifest = export.export_shape_set(model, out, buckets=(8,),
                                       n_img=N_IMG, canvas_hw=CANVAS)
    images, meta = _inputs(8, seed=2)
    with torch.inference_mode():
        live = model._core(images, meta, alpha_mode="proj")
    return model, out, manifest, (images, meta), live


def test_artifact_directory_names_its_libraries(artifact):
    _, out, manifest, _, _ = artifact
    libs = manifest["op_libraries"]
    assert libs["load"] == libs["files"] == ["libegonet_ops.so"]
    assert libs["torch"] == torch.__version__
    assert libs["cuda"] == torch.version.cuda
    for f in libs["files"]:
        assert os.path.getsize(os.path.join(out, f)) > 0


def test_another_torch_version_raises(artifact, tmp_path):
    _, out, manifest, _, _ = artifact
    bad = json.loads(json.dumps(manifest))
    bad["op_libraries"]["torch"] = "1.0.0+elsewhere"
    with pytest.raises(RuntimeError, match=r"1\.0\.0\+elsewhere.*"
                       + torch.__version__.replace("+", r"\+")):
        export.load_op_libraries(out, bad)


def test_a_manifest_without_libraries_loads_none(artifact, monkeypatch):
    """An artifact directory written before the libraries were shipped:
    nothing is loaded (the caller registers the operators)."""
    _, out, manifest, _, _ = artifact
    old = {k: v for k, v in manifest.items() if k != "op_libraries"}
    monkeypatch.setattr(torch.ops, "load_library", None)   # not called
    export.load_op_libraries(out, old)


def test_fresh_interpreter_runs_the_artifact_alone(artifact, tmp_path):
    """Torch and io/export.py only: the directory's libegonet_ops.so
    registers the operators, a checkpoint binds, the output equals the
    live program's bit for bit, and no ops or models module is loaded.
    Then the wrappers, imported after, run on that library (no second
    registration) and count on it."""
    model, out, _, (images, meta), live = artifact
    data = tmp_path / "data.pt"
    torch.save({"hrnet": model.hrnet.state_dict(),
                "lifter": model.lifter.state_dict(),
                "ls": {k: v.cpu() for k, v in model.ls_stats.items()},
                "images": images, "meta": meta}, str(data))
    code = textwrap.dedent(f"""\
        import json, sys, torch
        sys.path.insert(0, {ROOT!r})
        from egonet_tpu_torch.io import export
        torch.set_num_threads(2)
        programs, manifest = export.load_exported({out!r})
        d = torch.load({str(data)!r})
        program = export.bind(programs[8], manifest, d["hrnet"],
                              d["lifter"], d["ls"])
        with torch.inference_mode():
            got = program(d["images"], d["meta"])
        torch.save(got, {str(tmp_path / "got.pt")!r})
        modules = sorted(m for m in sys.modules if m.startswith("egonet"))
        from egonet_tpu_torch.ops import fused_block as fb
        x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
        w, b = torch.zeros(16, 3, 3, 16, dtype=torch.bfloat16), torch.zeros(16)
        fb.fused_basic_block.launches = 3
        y = fb.fused_basic_block(x, w, b, w, b)
        print(json.dumps({{
            "modules": modules, "launches": fb.fused_basic_block.launches,
            "wrapper_ok": bool(torch.equal(
                y, fb.fused_basic_block_reference(x, w, b, w, b))),
            "libraries": sorted(torch.ops.loaded_libraries)}}))
        """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    seen = json.loads(res.stdout.strip().splitlines()[-1])
    assert not [m for m in seen["modules"] if m.startswith(
        ("egonet_tpu_torch.ops", "egonet_tpu_torch.models"))], seen
    assert seen["libraries"] == [
        os.path.realpath(os.path.join(out, "libegonet_ops.so"))]
    assert seen["wrapper_ok"] and seen["launches"] == 3
    assert torch.equal(torch.load(str(tmp_path / "got.pt")), live)
