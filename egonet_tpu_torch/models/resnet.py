"""Simple-Baselines pose network, ResNet backbone + deconvolution head, in
PyTorch.  Port of ``egonet_tpu/models/resnet.py``.

ResNet-{18, 34, 50, 101, 152} (7x7 stride-2 stem, BN, ReLU, 3x3 stride-2
max-pool, four stages of basic or bottleneck blocks), then
``num_deconv_layers`` x (ConvTranspose2d stride 2, BN, ReLU) and a
``final_layer`` conv to K heatmaps, returned NCHW in fp32.  The deconvs
take the reference's ``_get_deconv_cfg`` (kernel, padding, output
padding): (4, 1, 0), (3, 1, 1), (2, 0, 0), which the JAX package expresses
as a flax ``ConvTranspose`` with ``transpose_kernel`` and padding 'SAME'
(k = 4, 2) or [(1, 2), (1, 2)] (k = 3).  Module names equal the
reference's ``state_dict`` keys (``layer3.5.conv2``, ``deconv_layers.3``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from egonet_tpu_torch.models.hrnet import BasicBlock, Bottleneck
from egonet_tpu_torch.models.layers import CachedInference, Ops, bn, conv

RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
# kernel -> (padding, output padding): the reference's _get_deconv_cfg
DECONV_CFG = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


class PoseResNet(CachedInference):
    """``forward(x)``: NCHW normalized crops -> heatmaps [N, K, H/4, W/4]
    (three deconvs), fp32 (fp64 for an fp64 model)."""

    def __init__(self, num_layers=50, num_joints=33, num_deconv_layers=3,
                 num_deconv_filters=(256, 256, 256),
                 num_deconv_kernels=(4, 4, 4), final_conv_kernel=1,
                 deconv_with_bias=False, in_channels=3, dtype=torch.float32):
        super().__init__(dtype)
        kind, layers = RESNET_SPEC[int(num_layers)]
        block, exp = (BasicBlock, 1) if kind == "basic" else (Bottleneck, 4)
        self.conv1 = conv(in_channels, 64, 7, 2)
        self.bn1 = bn(64)
        cin = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers), start=1):
            mods = []
            for b in range(blocks):
                stride = 2 if stage > 1 and b == 0 else 1
                mods.append(block(cin, planes, stride))
                cin = planes * exp
            setattr(self, f"layer{stage}", nn.Sequential(*mods))
        deconvs = []
        for i in range(int(num_deconv_layers)):
            k, cout = int(num_deconv_kernels[i]), int(num_deconv_filters[i])
            pad, out_pad = DECONV_CFG[k]
            deconvs += [nn.ConvTranspose2d(cin, cout, k, 2, pad, out_pad,
                                           bias=bool(deconv_with_bias)),
                        bn(cout), nn.ReLU()]
            cin = cout
        self.deconv_layers = nn.Sequential(*deconvs)
        fk = int(final_conv_kernel)
        self.final_layer = conv(cin, int(num_joints), fk, 1,
                                1 if fk == 3 else 0, bias=True)
        if dtype == torch.float64:
            self.double()

    def forward(self, x):
        cache = self.inference_cache()
        ops = Ops(self.dtype, cache["cast"] if cache else None)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = torch.relu(ops.bn(self.bn1, ops.conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, 5):
            for blk in getattr(self, f"layer{stage}"):
                x = blk.run(ops, x)
        d = self.deconv_layers
        for i in range(0, len(d), 3):
            x = torch.relu(ops.bn(d[i + 1], ops.conv_transpose(d[i], x)))
        return ops.conv(self.final_layer, x).to(ops.stat_dtype)


def build_pose_resnet(cfgs: dict, dtype=torch.float32) -> PoseResNet:
    hm = cfgs["heatmapModel"]
    extra = hm.get("extra", {}) or {}
    return PoseResNet(
        num_layers=int(hm.get("num_layers", 50)),
        num_joints=int(hm.get("num_joints", 33)),
        num_deconv_layers=int(extra.get("num_deconv_layers", 3)),
        num_deconv_filters=tuple(extra.get("num_deconv_filters",
                                           (256, 256, 256))),
        num_deconv_kernels=tuple(extra.get("num_deconv_kernels", (4, 4, 4))),
        final_conv_kernel=int(extra.get("final_conv_kernel", 1)),
        deconv_with_bias=bool(extra.get("deconv_with_bias", False)),
        in_channels=5 if hm.get("add_xy", False) else 3,
        dtype=dtype,
    )
