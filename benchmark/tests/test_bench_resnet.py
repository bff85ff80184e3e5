"""The keypoint family ``resnet`` (``reference/keypoint_resnet.py``,
PoseResNet of Simple Baselines): its names are the port's
``PoseResNet(152)`` ``state_dict`` keys and shapes, in the port's order,
and load strictly; its FLOPs are the published size's 33,898,364,928 a
crop and, at the CPU cut, what ``torch.utils.flop_counter`` counts on
the reference and on the port; its readout puts a peak at row i, column
j at (j / W, i / H)."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run, weights, work
from benchmark.reference import egonet_ref as ref
from benchmark.reference import keypoint_resnet as kr

CONFIG = os.path.join(run.ROOT, "benchmark", "configs",
                      "egonet_resnet152_car.json")
PARAMS = {"bias_std": 0.05, "bn_gamma": [0.4, 0.6],
          "bn_gamma_residual": [0.15, 0.25]}


def _config():
    with open(CONFIG) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["resnet", "pose_resnet", "ResNet"])
def test_names_reach_the_family(name):
    assert ref.keypoint_model({"heatmapModel": {"name": name}}) is kr


def test_shapes_load_strictly_into_the_port():
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.resnet import PoseResNet
    cfg = _config()
    shapes = kr.shapes(cfg)
    net = build_heatmap_model(cfg)
    assert isinstance(net, PoseResNet)
    port = net.state_dict()
    assert list(shapes) == list(port)
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(s) for k, s in shapes.items()}
    gen = torch.Generator().manual_seed(3)
    state = weights._draw(shapes, gen, "cpu", PARAMS)
    net.load_state_dict(state, strict=True)
    assert sum(k.endswith("running_var") for k in shapes) == 158


def test_flops_at_the_published_size():
    cfg = _config()
    wk = work.crop_work(cfg)
    assert kr.flops(cfg) == wk["keypoint_flops"] == 33_898_364_928
    # 159 conv weights in bf16 (the 68.6 M parameters less the batch norms'
    # and the final layer's bias)
    assert wk["weight_bytes"] == 136_973_184


def test_flops_match_the_flop_counter_at_the_cut():
    """At the CPU cut the walk's FLOPs equal ``FlopCounterMode``'s on the
    reference's forward and on the port's model (transposed convs
    included)."""
    from egonet_tpu_torch.models.factory import build_heatmap_model
    cfg = kr.shrink(_config())
    shapes = kr.shapes(cfg)
    state = weights._draw(shapes, torch.Generator().manual_seed(4), "cpu",
                          PARAMS)
    x = torch.zeros(1, 3, 64, 64)
    with FlopCounterMode(display=False) as counter:
        out = kr.forward(state, x, cfg)
    assert tuple(out.shape) == (1, 33, 2)
    assert counter.get_total_flops() == kr.flops(cfg) > 0
    net = build_heatmap_model(cfg).eval()
    net.load_state_dict(state, strict=True)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        maps = net(x)
    assert tuple(maps.shape) == (1, 33, 16, 16)
    assert counter.get_total_flops() == kr.flops(cfg)


def test_readout_puts_a_peak_at_its_pixel():
    maps = torch.full((1, 2, 16, 8), -50.0)
    maps[0, 0, 3, 5] = 50.0
    maps[0, 1, 15, 0] = 50.0
    got = kr._Compute({}).soft_argmax(maps)
    torch.testing.assert_close(
        got, torch.tensor([[[5 / 8, 3 / 16], [0.0, 15 / 16]]]), rtol=0,
        atol=1e-6)
