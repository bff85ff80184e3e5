"""PoseResNet (Simple Baselines) on the EgoNet facade, on the CPU: the
facade with a 'heatmap' head against the benchmark's plain reference
(``benchmark/reference/keypoint_resnet.py`` through ``egonet_ref.run``)
on the family's CPU cut (ResNet-50's depths, 64x64 crops, 16x16
heatmaps) with the benchmark's seeded weights, in fp32 and bf16; the
soft-argmax readout's convention; every batch norm of a bf16 inference
forward through ``egonet::bn_act`` (158 at ResNet-152's depth); the int8
activation transport; the harness's ``prepare_inference(stencil=...)``
on every family; and the ``readout`` span, which only a 'heatmap' head
opens."""

import copy
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness, run, traffic, weights
from benchmark.reference import egonet_ref as ref
from benchmark.tests import tiny
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.models import layers
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.models.factory import build_heatmap_model
from egonet_tpu_torch.models.resnet import PoseResNet, build_pose_resnet
from egonet_tpu_torch.ops import affine, keypoints
from egonet_tpu_torch.utils import profiling
from tests import fixtures

torch.set_num_threads(2)
CONFIG = os.path.join(run.ROOT, "benchmark", "configs",
                      "egonet_resnet152_car.json")
MIX = os.path.join(run.ROOT, "benchmark", "traffic",
                   "offline_batch64_car.json")
OP = "egonet.bn_act.default"


def _full_config():
    with open(CONFIG) as f:
        return json.load(f)


def _config():
    """The benchmark's configuration at the CPU tests' cut (the family's
    ``shrink``, a 64-wide lifter)."""
    return tiny.shrink_config(_full_config())


def _program_config(cfg):
    return {k: v for k, v in cfg.items() if k not in harness.HARNESS_KEYS}


class _Calls(TorchDispatchMode):
    """Counts the egonet operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("egonet."):
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def seeded():
    """The cut configuration, four frames of the car mix at its tiny size,
    their crops, the seeded weights (batch norms calibrated on the crops)
    and the reference's answers (seed 7)."""
    cfg = _config()
    with open(MIX) as f:
        tr = tiny.shrink_traffic(json.load(f))
    wl = traffic.make(tr, 7, "cpu")
    items = wl.items([0, 1, 2, 3])
    hs, lst, ls_stats = weights.make(cfg, 7, "cpu", wl.frames, items)
    out = ref.run(wl.frames, items, hs, lst, ls_stats, cfg)
    return cfg, wl, items, (hs, lst, ls_stats), out


def _facade_answers(cfg, wl, state, dtype):
    model = EgoNet(_program_config(cfg), dtype=dtype, device="cpu")
    model.load_state(*state)
    frames = wl.frames_host()
    recs = model.forward_annot_dict({
        "path": [f"{s}" for s in range(4)], "images": frames[:4],
        "boxes": [wl.boxes[s] for s in range(4)], "K": [wl.K] * 4})
    return harness.stack_answers([
        tuple(a[j] for a in harness.answers_of_record(recs[f"{s}"]))
        for s in range(4) for j in range(len(wl.boxes[s]))])


def _angle_gap_deg(a, b):
    return np.degrees(np.abs(np.mod(a - b + np.pi, 2 * np.pi) - np.pi))


# Largest gaps allowed against the fp32 reference, per compute dtype:
# (2D keypoints over the crop's width, 3D points in metres, ry and alpha in
# degrees); seen on seeds 1, 2, 3 and 7 (the test's), widest first.
# fp32: the facade's warp with its bf16 hat weights made fp32, so what is
# left is the convs' summation order (channels_last against NCHW), which
# the readout's sharp softmax (logit_std 8) magnifies: seen 1.6e-4 of the
# crop, 5.3e-5 m, 1.2e-4 / 9.4e-5 degrees (seed 7: 6.5e-5, 3.1e-5 m); the
# bars leave about 3x.  bf16: the program as the benchmark runs it (bf16
# warp, convs and transposed convs, every batch norm through bn_act), its
# rounding over ResNet-50's 53 convs moving a few keypoints between two
# modes of their heatmaps: seen 0.068 of the crop, 0.034 m, 0.069 / 0.125
# degrees (seed 7: 0.068, 0.016 m, 0.034 / 0.093); the 2D and 3D bars are
# the tiny cells' limits (tiny.TINY_LIMITS), which the int8 control
# crosses, the angle bars leave about 3x.
BARS = {"float32": (5e-4, 2e-4, 5e-4, 5e-4),
        "bfloat16": (0.15, 0.06, 0.2, 0.4)}


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_facade_matches_the_reference(seeded, dtype, monkeypatch):
    cfg, wl, items, state, want = seeded
    if dtype == "float32":
        interp = affine._interp_weights
        monkeypatch.setattr(affine, "_interp_weights", lambda *a, **k: interp(
            *a, **dict(k, dtype=torch.float32)))
    got = _facade_answers(cfg, wl, state, getattr(torch, dtype))
    n = len(want["alpha"])
    assert got["kpts_2d"].shape == want["kpts_2d"].shape == (n, 33, 2)
    assert n == 21
    k2, k3, ry, alpha = BARS[dtype]
    gap = np.abs(got["kpts_2d"] - want["kpts_2d"]).max(axis=(1, 2))
    assert (gap / want["crop_w"]).max() < k2
    assert np.abs(got["kpts_3d"] - want["kpts_3d"]).max() < k3
    assert _angle_gap_deg(got["euler"][:, 1], want["euler"][:, 1]).max() < ry
    assert _angle_gap_deg(got["alpha"], want["alpha"]).max() < alpha
    # the readout is not degenerate: the keypoints spread over each crop
    box = np.asarray(items["box"], np.float64)
    cx = (box[:, 0] + box[:, 2]) / 2
    spread = want["kpts_2d"][..., 0].std(axis=1) / want["crop_w"]
    assert (spread > 0.03).all()
    assert (np.abs(got["kpts_2d"][..., 0] - cx[:, None])
            <= want["crop_w"][:, None] / 2).all()


def test_soft_argmax_in_the_unit_square():
    """A heatmap peaked at row i, column j reads (j / W, i / H) in the
    crop's unit square: crop px (4j, 4i) for 64x64 maps of a 256x256
    crop."""
    maps = torch.full((2, 3, 64, 64), -60.0)
    peaks = [[(0, 0), (10, 37), (63, 5)], [(31, 62), (7, 7), (50, 20)]]
    for n, row in enumerate(peaks):
        for k, (i, j) in enumerate(row):
            maps[n, k, i, j] = 60.0
    unit = keypoints.soft_argmax_coords(maps, unit=True)
    px, maxvals = keypoints.soft_argmax(maps)
    want = torch.tensor([[[j, i] for i, j in row] for row in peaks],
                        dtype=torch.float32)
    torch.testing.assert_close(px, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(unit * 256.0, 4.0 * want, rtol=0, atol=1e-3)
    assert float(maxvals.min()) == 60.0


def test_facade_reads_a_peak_at_its_crop_pixel(monkeypatch):
    """Through the facade: a model whose heatmaps peak at row i, column j
    gives each crop's keypoint at crop px (4j, 4i) (64x64 maps, 256x256
    crops), mapped back to the frame by the crop's inverse affine."""
    cfg = _program_config(_full_config())
    cfg["heatmapModel"].update(num_layers=50)
    ij = [(3 * k % 64, (5 * k + 2) % 64) for k in range(33)]

    def peaked(self, x):
        maps = torch.full((x.shape[0], 33, 64, 64), -60.0)
        for k, (i, j) in enumerate(ij):
            maps[:, k, i, j] = 60.0
        return maps
    monkeypatch.setattr(PoseResNet, "forward", peaked)
    model = EgoNet(cfg, dtype=torch.float32, device="cpu")
    boxes = np.array([[100.0, 120, 260, 220], [500, 150, 620, 260]])
    frame = np.zeros((375, 1242, 3), np.uint8)
    K = np.array([[707.0, 0, 604], [0, 707.0, 180], [0, 0, 1]])
    rec = model.forward_annot_dict({"path": ["a"], "images": [frame],
                                    "boxes": [boxes], "K": [K]})["a"]
    got = np.stack([np.asarray(v, np.float64).reshape(-1, 2)
                    for v in rec["kpts_2d_pred"]])
    inv = affine.crop_matrices_for_boxes(boxes, (256, 256), 1.0, 1.1)["inv"]
    crop_px = np.array([[4.0 * j, 4.0 * i] for i, j in ij])
    want = crop_px[None] @ inv[:, :, :2].transpose(0, 2, 1) \
        + inv[:, None, :, 2]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# (compute dtype, mode) -> bn_act calls a forward of ResNet-152
FORWARDS = [("bfloat16", "eval", 158), ("bfloat16", "train", 0),
            ("float32", "eval", 0)]


@pytest.mark.parametrize("dtype,mode,bn_acts", FORWARDS)
def test_every_batch_norm_is_one_bn_act_call(dtype, mode, bn_acts):
    """ResNet-152 at 256x256 (fake tensors: shapes and strides only): in
    bf16 inference each of its 158 batch norms (the stem, 150 in the 50
    bottlenecks, 4 shortcuts, 3 after the deconvs) is one operator call on
    NHWC storage, the max pool's and the transposed convs' outputs
    included (the operator refuses any other layout); none in train mode
    or in fp32."""
    cfg = _full_config()
    with FakeTensorMode():
        net = build_pose_resnet(cfg, dtype=getattr(torch, dtype))
        net.train(mode == "train")
        x = torch.empty(2, 3, 256, 256)
        with torch.no_grad(), _Calls() as calls:
            maps = net(x)
    assert tuple(maps.shape) == (2, 33, 64, 64)
    assert calls.calls.get(OP, 0) == bn_acts
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 158
    if mode == "eval":
        assert list(net.inference_cache()["affine"]) == (
            bns if dtype == "bfloat16" else [])


def _shrunk_resnet(dtype, **heatmap):
    """ResNet-50 at 64x64 with the published head, batch-norm statistics
    drawn (seed 0)."""
    cfg = _program_config(_full_config())
    cfg["heatmapModel"].update(num_layers=50, input_size=[64, 64],
                               heatmap_size=[16, 16], **heatmap)
    torch.manual_seed(0)
    net = build_pose_resnet(cfg, dtype=dtype)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.randn(m.num_features) * 0.1))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, m.num_features)))
    return net.eval()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_act_quant_int8_moves_the_output_and_none_does_not(dtype,
                                                            monkeypatch):
    """``act_quant: int8`` sends each of ResNet-50's 16 block outputs and
    3 deconv stages' ReLU outputs through the uint8 transport, which moves
    the heatmaps; without it (and with 'none') the transport is the
    identity: the heatmaps are those of the model with the transport
    taken out."""
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2, 3, 64, 64).astype(np.float32))
    seen = []
    transport = layers.Ops.transport

    def counted(self, t):
        seen.append(self.act_quant)
        return transport(self, t)
    monkeypatch.setattr(layers.Ops, "transport", counted)
    with torch.no_grad():
        plain = _shrunk_resnet(getattr(torch, dtype))(x)
        none = _shrunk_resnet(getattr(torch, dtype), act_quant="none")(x)
        quant = _shrunk_resnet(getattr(torch, dtype), act_quant="int8")(x)
    assert seen == ["none"] * 38 + ["int8"] * 19
    monkeypatch.setattr(layers.Ops, "transport", lambda self, t: t)
    with torch.no_grad():
        bare = _shrunk_resnet(getattr(torch, dtype))(x)
    assert torch.equal(plain, bare) and torch.equal(none, bare)
    assert float((quant - bare).abs().max()) > 0.01 * float(
        bare.abs().max())
    with pytest.raises(NotImplementedError, match="int4"):
        _shrunk_resnet(torch.float32, act_quant="int4")


@pytest.mark.parametrize("family", ["hrnet", "resnet", "tpu_native"])
def test_every_family_takes_the_harness_stencil_keyword(family):
    """``prepare_inference(stencil="0")``, as the benchmark's harness calls
    it on any keypoint model: the HRNet keeps the tiled kernel; the
    families without fused blocks build their table and ignore it.  Every
    family's table holds batch norms' (scale, shift) for ``bn_act``."""
    cfg = {"hrnet": lambda: fixtures.shrink_hrnet(tcfg.demo_config()),
           "resnet": _config,
           "tpu_native": lambda: fixtures.shrink_tpu_native(
               tcfg.native_demo_config())}[family]()
    net = build_heatmap_model(_program_config(cfg),
                              dtype=torch.bfloat16).eval()
    assert net.prepare_inference(stencil="0") is net
    cache = net.inference_cache()
    assert cache["cast"]
    if family == "hrnet":
        assert cache["stencil"] is False and cache["folded"]
    assert cache["affine"]


@pytest.mark.parametrize("family", ["hrnet", "resnet"])
def test_only_a_heatmap_head_opens_the_readout_span(family):
    """The 'readout' span is opened once a batch by a 'heatmap' head's
    facade, after ``backbone`` and before ``inverse_affine``; an HRNet
    'coordinates' facade never opens it."""
    cfg = (fixtures.shrink_hrnet(tcfg.demo_config()) if family == "hrnet"
           else _program_config(_config()))
    model = EgoNet(cfg, device="cpu")
    assert model.readout == (family == "resnet")
    rng = np.random.RandomState(0)
    annot = {"path": ["a.png"],
             "images": [rng.randint(0, 255, (96, 320, 3), np.uint8)],
             "boxes": [np.array([[40.0, 20, 120, 80], [150, 30, 220, 90]])]}
    model.forward_annot_dict(annot)
    profiling.reset_totals()
    for _ in range(2):
        model.forward_annot_dict(copy.deepcopy(annot))
    totals = profiling.totals()
    assert totals["backbone"][0] == 2
    assert totals.get("readout", (0,))[0] == (2 if family == "resnet"
                                              else 0)


def test_facade_takes_no_other_family_heatmap_head():
    """Only PoseResNet's maps are read out (and held to a reference): the
    HRNet with a 'heatmap' head is refused when the facade is built, and
    the message names the head."""
    cfg = fixtures.shrink_hrnet(tcfg.demo_config())
    cfg["heatmapModel"]["head_type"] = "heatmap"
    with pytest.raises(ValueError, match="PoseResNet.*'heatmap'"):
        EgoNet(cfg, device="cpu")
