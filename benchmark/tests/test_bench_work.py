"""The benchmark's FLOP arithmetic, from the configurations' shapes,
equals torch's FLOP counter over the port's plain forward (the fused
blocks on their plain version) at every configuration's published
widths."""

import json
import os

import pytest
import torch

from benchmark import run, work


@pytest.mark.parametrize("conf", run.load_spec()["configs"],
                         ids=lambda conf: conf["name"])
def test_flops_equal_the_counter(conf):
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.fc_lifter import build_fc_model
    from egonet_tpu_torch.utils.summary import count_flops
    with open(os.path.join(run.ROOT, conf["file"])) as f:
        cfg = json.load(f)
    got = work.crop_work(cfg)
    hrnet = build_heatmap_model(cfg).eval()
    w, h = cfg["heatmapModel"]["input_size"]
    assert got["keypoint_flops"] == count_flops(
        hrnet, torch.zeros(1, 3, h, w), modules=(hrnet,))
    lifter = build_fc_model(cfg).eval()
    assert got["lifter_flops"] == count_flops(
        lifter, torch.zeros(1, cfg["FCModel"]["input_size"]))
    assert got["weight_bytes"] == 2 * sum(
        p.numel() for n, p in hrnet.named_parameters()
        if n.endswith("weight") and p.dim() == 4)


def test_bound_is_the_larger_of_the_two():
    with open(os.path.join(run.ROOT, "benchmark/configs/egonet_w48_car.json")) as f:
        cfg = json.load(f)
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    wk = work.crop_work(cfg)
    one = work.keypoint_bound_s(cfg, 1, peaks)
    assert one == pytest.approx(max(wk["keypoint_flops"] / 989e12,
                                    (wk["weight_bytes"] + wk["io_bytes"])
                                    / 3.35e12))
    assert work.keypoint_bound_s(cfg, 384, peaks) == pytest.approx(
        384 * wk["keypoint_flops"] / 989e12)
