"""Both fused BasicBlock kernels as torch operators, and the port's AOT
export (``egonet_tpu_torch/io/export.py``, ``tools/export_model.py``) on
the CPU.

``torch.library.opcheck`` holds each op's schema, Meta kernel and CPU
kernel (the plain version; all three C++, ``csrc/egonet_ops.cpp``) to
each other.  The exported
programs of a shrunk HRNet in bf16 (widths 16/32/64/128: the kernels'
contract takes multiples of 16) must reproduce the live ``EgoNet._core``
bit for bit on the CPU — with the model's weights and with a second seeded
weight set laid into the same artifact — and hold one custom-op node per
fusable block.  A fresh interpreter that imports only ``egonet_tpu_torch``
loads and runs an artifact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from egonet_tpu_torch.config import demo_config
from egonet_tpu_torch.io import checkpoint, export
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops import fused_block as fb
from tests import fixtures

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_IMG, CANVAS = 2, (96, 320)
BUCKETS = (8, 16)


def _cfg():
    cfg = fixtures.shrink_hrnet(demo_config())
    extra = cfg["heatmapModel"]["extra"]
    for s, ch in (("stage2", [16, 32]), ("stage3", [16, 32, 64]),
                  ("stage4", [16, 32, 64, 128])):
        extra[s]["num_channels"] = ch
    return cfg


def _ls(model):
    return {k: v.cpu().numpy() for k, v in model.ls_stats.items()}


def _inputs(bucket, seed=0):
    """Random canvases and a meta array of in-frame crops over both
    frames (the last rows padding)."""
    from egonet_tpu_torch.models.egonet import pack_meta
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randint(0, 255, (N_IMG,) + CANVAS + (3,),
                                          np.uint8))
    n = bucket - 2
    s = rng.uniform(0.3, 1.2, n)
    inv = np.zeros((n, 2, 3))
    inv[:, 0, 0] = inv[:, 1, 1] = s
    inv[:, 0, 2] = rng.uniform(0, 200, n)
    inv[:, 1, 2] = rng.uniform(0, 40, n)
    meta = np.zeros((bucket, 18), np.float32)
    meta[:n] = pack_meta(inv, rng.randint(0, N_IMG, n), np.ones(n),
                         np.full(n, 707.0), np.full(n, 160.0),
                         np.tile([CANVAS[1], CANVAS[0]], (n, 1)))
    meta[n:, 0:6] = np.eye(2, 3).reshape(6)
    meta[n:, 10:14] = 1.0
    return images, torch.from_numpy(meta)


@pytest.fixture(scope="module", autouse=True)
def _ops():
    """The operators load at first use (``_build.load_ops``), not at
    import: load them before a test calls ``torch.ops.egonet``."""
    _build.load_ops("cpu")


@pytest.fixture(scope="module")
def model():
    return EgoNet(_cfg(), device="cpu")


@pytest.fixture(scope="module")
def exported(model, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("export"))
    manifest = export.export_shape_set(model, out, buckets=BUCKETS,
                                       n_img=N_IMG, canvas_hw=CANVAS)
    programs, loaded = export.load_exported(out)
    return out, manifest, programs, loaded


def _fold_args(rng, n, h, w, c):
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).bfloat16()
    ws = [torch.from_numpy(rng.randn(c, 3, 3, c).astype(np.float32) * 0.05)
          .bfloat16() for _ in range(2)]
    bs = [torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
          for _ in range(2)]
    return x, ws[0], bs[0], ws[1], bs[1]


@pytest.mark.parametrize("op", ["fused_basic_block",
                                "fused_basic_block_stencil"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 32)])
def test_opcheck(rng, op, shape):
    """Schema, fake tensor and the CPU implementation against each other
    (and the dispatcher's autograd and AOT checks)."""
    args = _fold_args(rng, *shape)
    torch.library.opcheck(getattr(torch.ops.egonet, op).default, args)
    y = getattr(torch.ops.egonet, op)(*args)
    assert torch.equal(y, fb.fused_basic_block_reference(*args))


def test_fake_checks_the_contract(rng):
    """The Meta kernel refuses what the kernel refuses, without
    data: a width no multiple of 16, fp32 activations, a stencil wider
    than 384."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        for shape, dtype, op in (((1, 4, 4, 8), torch.bfloat16,
                                  torch.ops.egonet.fused_basic_block),
                                 ((1, 4, 4, 16), torch.float32,
                                  torch.ops.egonet.fused_basic_block),
                                 ((1, 2, 2, 400), torch.bfloat16,
                                  torch.ops.egonet.fused_basic_block_stencil)):
            c = shape[3]
            x = torch.empty(shape, dtype=dtype)
            w = torch.empty(c, 3, 3, c, dtype=torch.bfloat16)
            b = torch.empty(c)
            with pytest.raises(ValueError):
                op(x, w, b, w, b)
        x, w1, b1, w2, b2 = (mode.from_tensor(t)
                             for t in _fold_args(rng, 2, 4, 4, 16))
        y = torch.ops.egonet.fused_basic_block(x, w1, b1, w2, b2)
        assert y.shape == x.shape and y.dtype == torch.bfloat16


@pytest.mark.parametrize("bucket", BUCKETS)
def test_round_trip_bit_equal(model, exported, bucket):
    _, manifest, programs, loaded = exported
    program = export.bind(programs[bucket], loaded,
                          model.hrnet.state_dict(),
                          model.lifter.state_dict(), _ls(model))
    images, meta = _inputs(bucket, seed=bucket)
    with torch.inference_mode():
        live = model._core(images, meta, alpha_mode="proj")
        got = program(images, meta)
    assert got.shape == live.shape == (bucket, 66 + 96 + 8)
    assert torch.isfinite(got).all()
    assert torch.equal(got, live)


def test_tensor_indices_match_host_indices(model):
    """The exported form of the warp (frames gathered by device indices
    from meta) against the facade's (frames read as views by host
    ints)."""
    images, meta = _inputs(16, seed=3)
    with torch.inference_mode():
        gathered = model._core(images, meta, alpha_mode="proj")
        views = model._core(images, meta, meta[:, 8].long().tolist(),
                            alpha_mode="proj")
    torch.testing.assert_close(gathered, views, rtol=1e-5, atol=1e-4)


def test_graph_holds_one_node_per_block(model, exported):
    _, manifest, programs, _ = exported
    n_blocks = sum(1 for _ in model.hrnet._fusable_blocks())
    assert n_blocks == 9
    for b in BUCKETS:
        assert export.fused_nodes(programs[b]) == n_blocks
        assert manifest["artifacts"][str(b)]["fused_nodes"] == n_blocks
    targets = [str(n.target) for n in programs[8].graph.nodes
               if n.op == "call_function"]
    assert "egonet.fused_basic_block.default" in targets
    # the rigid stage: one node of its own operator
    assert targets.count("egonet.rigid_solve.default") == 1


def test_artifacts_hold_no_weights(model, exported):
    """The .pt2 files keep their state on the meta device: smaller than
    the weights, and the derived inference weights are inputs that
    :func:`export.weights_for` rebuilds equal to the live cache."""
    out, manifest, _, loaded = exported
    weight_bytes = sum(v.numel() * v.element_size()
                       for v in model.hrnet.state_dict().values())
    for entry in manifest["artifacts"].values():
        assert entry["bytes"] == os.path.getsize(os.path.join(out,
                                                              entry["file"]))
        assert entry["bytes"] < weight_bytes
    state = export.weights_for(loaded, model.hrnet.state_dict(),
                               model.lifter.state_dict(), _ls(model))
    cache = model.hrnet.inference_cache()
    core = export.ExportCore(model)
    live = dict(core.state_dict())
    assert set(state) == set(live)
    for k, v in live.items():
        assert torch.equal(state[k], v) and state[k].dtype == v.dtype, k
        assert state[k].stride() == v.stride(), k
    assert len(cache["folded"]) == 9


def test_graph_holds_one_bn_act_node_per_batch_norm(model, exported):
    """Each batch norm outside the fused blocks is one ``egonet::bn_act``
    node of the bf16 program (its residual add and relu inside), and the
    manifest derives each one's scale and shift."""
    _, manifest, programs, _ = exported
    n = len(model.hrnet.inference_cache()["affine"])
    targets = [str(node.target) for node in programs[8].graph.nodes]
    assert targets.count("egonet.bn_act.default") == n > 0
    assert sum("affine" in r for r in manifest["derived"]) == n


def test_second_weight_set_through_the_same_artifact(exported):
    """A second seeded weight set, written as HC.pth / L.pth / LS.npy and
    read back, laid into the artifact equals a live model built with it."""
    _, _, programs, loaded = exported
    other = EgoNet(_cfg(), device="cpu", rng_seed=7)
    program = export.bind(programs[16], loaded, other.hrnet.state_dict(),
                          other.lifter.state_dict(), _ls(other))
    images, meta = _inputs(16, seed=5)
    with torch.inference_mode():
        live = other._core(images, meta, alpha_mode="proj")
        got = program(images, meta)
    assert torch.equal(got, live)


def test_stencil_program(model):
    """With the stencil selected the graph holds its op instead, and the
    program still reproduces the live model."""
    model.hrnet.prepare_inference(stencil="1")
    try:
        program, _ = export.export_program(model, 8, N_IMG, CANVAS)
        targets = [str(n.target) for n in program.graph.nodes]
        assert targets.count("egonet.fused_basic_block_stencil.default") == 9
        assert "egonet.fused_basic_block.default" not in targets
        images, meta = _inputs(8, seed=1)
        with torch.inference_mode():
            live = model._core(images, meta, alpha_mode="proj")
            got = program.module()(images, meta)
        assert torch.equal(got, live)
    finally:
        model.hrnet.prepare_inference(stencil="0")


def test_export_cli_and_fresh_interpreter(model, tmp_path):
    """tools/export_model.py writes the manifest; a fresh interpreter
    that imports only egonet_tpu_torch loads the artifact, lays in the
    checkpoint files the port writes and runs it."""
    from egonet_tpu_torch.tools import export_model
    out = str(tmp_path / "art")
    cfg = dict(_cfg(), device="cpu")
    manifest = export_model.main(["--out", out, "--buckets", "8",
                                  "--n-img", str(N_IMG)], cfgs=cfg)
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["format"] == "torch.export/pt2"
    assert manifest["device"] == "cpu" and manifest["dtype"] == "bfloat16"
    assert manifest["canvas_hw"] == [384, 1280] and manifest["meta_cols"] == 18
    assert manifest["artifacts"]["8"]["fused_nodes"] == 9
    assert len(manifest["derived"]) > 9

    ckpt = tmp_path / "ckpt"
    checkpoint.save_torch_state_dict(str(ckpt / "HC.pth"), model.hrnet)
    checkpoint.save_torch_state_dict(str(ckpt / "L.pth"), model.lifter)
    checkpoint.save_lifter_stats(str(ckpt / "LS.npy"), _ls(model))
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randint(0, 255, (N_IMG, 384, 1280, 3),
                                          np.uint8))
    meta = _inputs(8, seed=4)[1]
    torch.save({"images": images, "meta": meta}, str(tmp_path / "in.pt"))
    code = f"""
import sys, torch
sys.path.insert(0, {ROOT!r})
from egonet_tpu_torch.io import export, weights
programs, manifest = export.load_exported({out!r})
ck = {str(ckpt)!r}
program = export.bind(programs[8], manifest,
                      weights.load_torch_state_dict(ck + "/HC.pth"),
                      weights.load_torch_state_dict(ck + "/L.pth"),
                      weights.load_lifter_stats(ck + "/LS.npy"))
inp = torch.load({str(tmp_path / "in.pt")!r})
with torch.inference_mode():
    out = program(inp["images"], inp["meta"])
torch.save(out, {str(tmp_path / "out.pt")!r})
print(sorted(m for m in sys.modules if m.startswith("egonet")))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = eval(res.stdout.strip().splitlines()[-1])
    assert loaded and all(m.startswith("egonet_tpu_torch") for m in loaded)
    got = torch.load(str(tmp_path / "out.pt"))
    with torch.inference_mode():
        live = model._core(images, meta, alpha_mode="proj")
    assert torch.equal(got, live)
