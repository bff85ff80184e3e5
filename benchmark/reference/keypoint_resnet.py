"""The keypoint family ``resnet`` (``heatmapModel.name`` 'resnet' or
'pose_resnet'): PoseResNet from Simple Baselines (Xiao et al., "Simple
Baselines for Human Pose Estimation and Tracking", ECCV 2018; its code
github.com/microsoft/human-pose-estimation.pytorch,
``lib/models/pose_resnet.py``) with a soft-argmax readout, in plain fp32
PyTorch.

The trunk: a 7x7 stride-2 conv, batch norm, ReLU and a 3x3 stride-2 max
pool (padding 1), then four stages of bottlenecks at widths 64, 128, 256
and 512 with ``num_layers``'s depths (50: 3/4/6/3, 101: 3/4/23/3, 152:
3/8/36/3).  A bottleneck is a 1x1 conv, a 3x3 conv that carries the
stage's stride and a 1x1 conv to four times the width, each followed by
a batch norm, a ReLU after the first two and after the residual sum; the
first block of a stage takes its shortcut through a strided 1x1 conv and
a batch norm.  The head: ``num_deconv_layers`` times (a stride-2
transposed conv of ``num_deconv_kernels`` taps with the code's
``_get_deconv_cfg`` padding, kernel 4: padding 1, no output padding;
batch norm; ReLU), then a ``final_conv_kernel`` conv with bias to K
heatmaps.  The readout (EgoNet's ``soft_arg_max``,
``libs/common/img_proc.py``): each heatmap's softmax over its pixels,
and the expected column over the heatmap's width and the expected row
over its height, so a crop's keypoint (x, y) in [0, 1) lands at input
pixel heatmap index x input size / heatmap size (Simple Baselines'
``transform_preds`` convention).

The net is walked once by :func:`_pose_resnet` through the reference's
walkers (``egonet_ref._Spec`` / ``_Compute`` and ``work._FlopSpec``),
with the transposed conv, the max pool and the readout added by
subclassing them, so the parameter list, the forward pass and the work
count cannot disagree.  Parameter names are the port's ``state_dict``
keys.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import work
from benchmark.reference import egonet_ref as ref

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
# transposed-conv kernel -> (padding, output padding): _get_deconv_cfg
DECONV = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


class _Spec(ref._Spec):
    def conv_transpose(self, name, x, cout, k, pad, out_pad, bias=False):
        n, cin, h, w = x
        self.shapes[name + ".weight"] = (cin, cout, k, k)
        if bias:
            self.shapes[name + ".bias"] = (cout,)
        return (n, cout, 2 * (h - 1) - 2 * pad + k + out_pad,
                2 * (w - 1) - 2 * pad + k + out_pad)

    def maxpool(self, x):
        return (x[0], x[1], (x[2] - 1) // 2 + 1, (x[3] - 1) // 2 + 1)

    def soft_argmax(self, x):
        return (x[0], x[1], 2)


class _FlopSpec(work._FlopSpec, _Spec):
    def conv_transpose(self, name, x, cout, k, pad, out_pad, bias=False):
        # every input value meets every tap of every output channel
        self.flops += 2 * math.prod(x) * cout * k * k
        return super().conv_transpose(name, x, cout, k, pad, out_pad, bias)


class _Compute(ref._Compute):
    def conv_transpose(self, name, x, cout, k, pad, out_pad, bias=False):
        b = self.p[name + ".bias"] if bias else None
        return F.conv_transpose2d(x, self.p[name + ".weight"], b, 2, pad,
                                  out_pad)

    def maxpool(self, x):
        return F.max_pool2d(x, 3, 2, 1)

    def soft_argmax(self, x):
        n, k, h, w = x.shape
        p = torch.softmax(x.reshape(n, k, h * w), -1).reshape(n, k, h, w)
        xs = torch.arange(w, dtype=x.dtype, device=x.device) / w
        ys = torch.arange(h, dtype=x.dtype, device=x.device) / h
        return torch.stack([(p.sum(2) * xs).sum(-1),
                            (p.sum(3) * ys).sum(-1)], -1)


def _bottleneck(o, name, x, planes, stride, shortcut):
    y = o.relu(o.bn(name + ".bn1", o.conv(name + ".conv1", x, planes, 1,
                                          1, 0)))
    y = o.relu(o.bn(name + ".bn2", o.conv(name + ".conv2", y, planes, 3,
                                          stride)))
    y = o.bn(name + ".bn3", o.conv(name + ".conv3", y, planes * 4, 1, 1, 0))
    r = x
    if shortcut:
        r = o.bn(name + ".downsample.1",
                 o.conv(name + ".downsample.0", x, planes * 4, 1, stride, 0))
    return o.relu(o.add(y, r))


def _heatmaps(o, x, hm):
    """The trunk and the deconvolution head on ``x``: K heatmap logits."""
    x = o.maxpool(o.relu(o.bn("bn1", o.conv("conv1", x, 64, 7, 2))))
    for stage, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), DEPTHS[int(hm["num_layers"])]), start=1):
        for b in range(blocks):
            x = _bottleneck(o, f"layer{stage}.{b}", x, planes,
                            2 if stage > 1 and b == 0 else 1, b == 0)
    extra = hm["extra"]
    bias = bool(extra.get("deconv_with_bias", False))
    for i in range(int(extra["num_deconv_layers"])):
        k = int(extra["num_deconv_kernels"][i])
        x = o.conv_transpose(f"deconv_layers.{3 * i}", x,
                             int(extra["num_deconv_filters"][i]), k,
                             *DECONV[k], bias=bias)
        x = o.relu(o.bn(f"deconv_layers.{3 * i + 1}", x))
    fk = int(extra["final_conv_kernel"])
    return o.conv("final_layer", x, int(hm["num_joints"]), fk, 1,
                  1 if fk == 3 else 0, bias=True)


def _pose_resnet(o, x, hm):
    """[N, K, 2] keypoints in [0, 1) of the crops ``x``."""
    return o.soft_argmax(_heatmaps(o, x, hm))


def _walk(o, cfg):
    hm = cfg["heatmapModel"]
    w, h = hm["input_size"]
    _pose_resnet(o, (1, 3, h, w), hm)
    return o


def shapes(cfg) -> dict:
    """{state_dict key: shape} of the keypoint model, in draw order."""
    return _walk(_Spec(), cfg).shapes


def forward(state, x, cfg, calibrate=False):
    """[N, K, 2] coordinates in [0, 1) of the crops ``x`` (fp32 NCHW)."""
    return _pose_resnet(_Compute(state, calibrate), x, cfg["heatmapModel"])


def fit_head(state, x, cfg, params):
    """Calibrate every batch norm on the crops ``x``, then scale the final
    layer (weight and bias) so that its heatmap logits, centred over each
    heatmap's pixels, have a root mean square of ``params['logit_std']``
    (the softmax's sharpness: the readout's spread); in place in
    ``state``."""
    logits = _heatmaps(_Compute(state, True), x, cfg["heatmapModel"])
    centred = logits - logits.mean(dim=(2, 3), keepdim=True)
    gain = float(params["logit_std"]) / float(
        centred.square().mean().sqrt().clamp_min(1e-6))
    state["final_layer.weight"] = state["final_layer.weight"] * gain
    state["final_layer.bias"] = state["final_layer.bias"] * gain


def flops(cfg) -> int:
    """FLOPs a crop of the trunk and head (``work.py``'s convention)."""
    return _walk(_FlopSpec(), cfg).flops


def shrink(cfg) -> dict:
    """The CPU tests' cut of ``cfg['heatmapModel']``, in place: ResNet-50's
    depths (the shallowest bottleneck spec), 64x64 crops and 16x16
    heatmaps; the deconvolution head keeps its widths."""
    hm = cfg["heatmapModel"]
    hm["num_layers"] = 50
    hm["input_size"] = [64, 64]
    hm["heatmap_size"] = [16, 16]
    return cfg
