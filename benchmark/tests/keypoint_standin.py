"""A stand-in keypoint family for the CPU tests (``heatmapModel.name``
'standin'), in the form every family takes: a small conv net that is not
HRNet, with two primitives the reference's walkers lack (a 2x2 max pool
and a soft-argmax readout), added by subclassing them.  It is reached
through ``egonet_ref.keypoint_model`` once a test puts this directory on
``benchmark.reference``'s search path.

The net: ``len(extra.widths)`` times (3x3 conv, batch norm, ReLU, max
pool), a 1x1 conv to K heatmaps, and the soft-argmax's expected (x, y) in
[0, 1] of each heatmap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import work
from benchmark.reference import egonet_ref as ref


class _Spec(ref._Spec):
    def maxpool(self, x):
        return (x[0], x[1], x[2] // 2, x[3] // 2)

    def soft_argmax(self, x):
        return (x[0], x[1], 2)


class _FlopSpec(work._FlopSpec, _Spec):
    pass


class _Compute(ref._Compute):
    def maxpool(self, x):
        return F.max_pool2d(x, 2)

    def soft_argmax(self, x):
        n, k, h, w = x.shape
        p = torch.softmax(x.reshape(n, k, h * w), -1).reshape(n, k, h, w)
        xs = torch.linspace(0, 1, w, device=x.device)
        ys = torch.linspace(0, 1, h, device=x.device)
        return torch.stack([(p.sum(2) * xs).sum(-1),
                            (p.sum(3) * ys).sum(-1)], -1)


def _net(o, x, hm):
    for i, c in enumerate(hm["extra"]["widths"]):
        x = o.relu(o.bn(f"features.{i}.bn",
                        o.conv(f"features.{i}.conv", x, c, 3)))
        x = o.maxpool(x)
    return o.soft_argmax(o.conv("head", x, int(hm["num_joints"]), 1, 1, 0,
                                bias=True))


def _walk(o, cfg):
    hm = cfg["heatmapModel"]
    w, h = hm["input_size"]
    _net(o, (1, 3, h, w), hm)
    return o


def shapes(cfg) -> dict:
    return _walk(_Spec(), cfg).shapes


def forward(state, x, cfg, calibrate=False):
    return _net(_Compute(state, calibrate), x, cfg["heatmapModel"])


def fit_head(state, x, cfg, params):
    """Calibrate the batch norms on ``x``, then scale the head so its
    heatmap logits have standard deviation ``logit_std``."""
    seen = []

    class _Record(_Compute):
        def soft_argmax(self, h):
            seen.append(h)
            return super().soft_argmax(h)

    _net(_Record(state, True), x, cfg["heatmapModel"])
    gain = float(params["logit_std"]) / seen[0].std().clamp_min(1e-6)
    state["head.weight"] = state["head.weight"] * gain
    state["head.bias"] = state["head.bias"] * gain


def flops(cfg) -> int:
    return _walk(_FlopSpec(), cfg).flops


def shrink(cfg) -> dict:
    hm = cfg["heatmapModel"]
    hm["extra"]["widths"] = [8, 16]
    hm["input_size"] = [64, 64]
    hm["heatmap_size"] = [16, 16]
    return cfg
