"""PoseNetTPU, the MBConv keypoint model family, in PyTorch.  Port of
``egonet_tpu/models/tpu_native.py``.

The network: a stem to the base grid (default stride 8: one 8x8 stride-8
patchify conv; stride 4: two stride-2 3x3 convs), stages of inverted
bottlenecks (MBConv: 1x1 expand -> depthwise 3x3 -> 1x1 project, BN +
ReLU between, a ReLU'd residual sum with a 1x1 shortcut where the shape
changes) joined by stride-2 2x2 patch convs, a top-down pixel-shuffle FPN
(1x1 conv to 4x the channels + channel-to-space x2, summed with the
stage's features and blended by one MBConv), and the EgoNet heads:
'coordinates' (stride 8: the full-width grid features + xy maps through
stride-2 MBConvs down to 4x4 and a valid conv; stride 4: the K maps + xy
maps through four stride-2 MBConvs), 'heatmap' and 'angleregression'.
On the stride-8 grid the heatmaps come from the grid by a 1x1 conv and a
channel-to-space.  Per-stage expansion, ``act_quant`` after every MBConv.

Module names equal the JAX model's (``stage1.2.pw1``, ``up0.conv``,
``head2.3``, ...), so its variables and ``.pth`` files load strictly.
Precision follows ``models/hrnet.py``: convs in the compute dtype, batch
norm in fp32 (fp64 for an fp64 model), heads' dense layers in fp32.
Every layer is a cuDNN convolution or a matmul: the JAX package computes
this family with XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from egonet_tpu_torch.models.layers import (BN_MOMENTUM, CachedInference,
                                            Ops, batch_norm, bn, conv,
                                            pixel_shuffle)


class MBConv(nn.Module):
    """Inverted bottleneck: pw1 -> bn1 -> dw (3x3, groups=hidden) -> bn2 ->
    pw2 -> bn3, plus a 1x1 ``shortcut`` (conv, BN) where the stride or the
    width changes."""

    def __init__(self, cin, width, expansion, stride=1):
        super().__init__()
        hidden = width * expansion
        self.pw1 = conv(cin, hidden, 1, 1, 0)
        self.bn1 = bn(hidden)
        self.dw = conv(hidden, hidden, 3, stride, groups=hidden)
        self.bn2 = bn(hidden)
        self.pw2 = conv(hidden, width, 1, 1, 0)
        self.bn3 = bn(width)
        self.shortcut = None
        if stride != 1 or cin != width:
            self.shortcut = nn.Sequential(conv(cin, width, 1, stride, 0),
                                          bn(width))

    def run(self, ops: Ops, x):
        y = torch.relu(ops.bn(self.bn1, ops.conv(self.pw1, x)))
        y = torch.relu(ops.bn(self.bn2, ops.conv(self.dw, y)))
        y = ops.bn(self.bn3, ops.conv(self.pw2, y))
        if self.shortcut is not None:
            x = ops.conv_bn(self.shortcut, x)
        return ops.transport(torch.relu(x + y))


def _conv_bn_dict(cin, cout, k, stride, padding=0):
    """A ``{conv, bn}`` pair (the JAX names ``<prefix>.conv`` /
    ``<prefix>.bn``)."""
    return nn.ModuleDict({"conv": conv(cin, cout, k, stride, padding),
                          "bn": bn(cout)})


def _linspace_grid(h, w):
    """[2, h, w] float32: x then y, each linspace(0, 1)."""
    xs = np.tile(np.linspace(0, 1, w, dtype=np.float32), (h, 1))
    ys = np.tile(np.linspace(0, 1, h, dtype=np.float32)[:, None], (1, w))
    return torch.from_numpy(np.stack([xs, ys]))


class PoseNetTPU(CachedInference):
    """MBConv backbone + pixel-shuffle FPN + EgoNet heads; ``forward``
    keeps the head contract of ``hrnet.PoseHighResolutionNet``."""

    def __init__(self, depths=(1, 3, 9), widths=(256, 512, 1024),
                 expansion=(2, 3, 4), num_joints=33,
                 head_type="coordinates", heatmap_size=(64, 64),
                 input_size=(256, 256), head_width=128, in_channels=3,
                 dtype=torch.float32, act_quant="none", act_quant_scale=8.0,
                 grid_stride=8):
        super().__init__(dtype)
        if head_type not in ("coordinates", "heatmap", "angleregression"):
            raise NotImplementedError(head_type)
        if act_quant not in ("none", "int8"):
            raise NotImplementedError(f"act_quant {act_quant!r}")
        self.depths, self.widths = tuple(depths), tuple(widths)
        self.expansion = expansion
        self.num_joints = int(num_joints)
        self.head_type = head_type
        self.heatmap_size = tuple(int(s) for s in heatmap_size)
        self.head_width = int(head_width)
        self.act_quant = act_quant
        self.act_quant_scale = float(act_quant_scale)
        self.grid_stride = int(grid_stride)
        w0 = self.widths[0]
        if self.grid_stride == 8:
            self.stem = nn.ModuleDict({"patch": conv(in_channels, w0, 8, 8, 0),
                                       "bn1": bn(w0)})
        else:
            self.stem = nn.ModuleDict({"conv1": conv(in_channels, 64, 3, 2),
                                       "bn1": bn(64),
                                       "conv2": conv(64, w0, 3, 2),
                                       "bn2": bn(w0)})
        cin = w0
        for s, (depth, width) in enumerate(zip(self.depths, self.widths)):
            if s > 0:
                setattr(self, f"down{s}", _conv_bn_dict(cin, width, 2, 2))
                cin = width
            blocks = []
            for _ in range(depth):
                blocks.append(MBConv(cin, width, self._expansion_for(s)))
                cin = width
            setattr(self, f"stage{s}", nn.ModuleList(blocks))
        for s in range(len(self.widths) - 2, -1, -1):
            width = self.widths[s]
            setattr(self, f"up{s}", _conv_bn_dict(self.widths[s + 1],
                                                  4 * width, 1, 1))
            setattr(self, f"fpn{s}", MBConv(width, width,
                                            self._expansion_for(s)))

        k = self.num_joints
        map_w, map_h = self.heatmap_size
        gw, gh = (int(s) // self.grid_stride for s in input_size)  # grid
        head_exp = self._expansion_for(len(self.depths) - 1)
        if head_type == "coordinates" and self.grid_stride == 8:
            self.head1 = nn.Sequential(conv(w0, k * self._map_factor(gh) ** 2,
                                            1, 1, 0, bias=True))
            downs = max(0, int(np.log2(gh // 4)))
            blocks, cin, sides = [], w0 + 2, (gh, gw)
            for _ in range(downs):
                blocks.append(MBConv(cin, self.head_width, head_exp, 2))
                cin = self.head_width
                sides = tuple((s - 1) // 2 + 1 for s in sides)
            blocks.append(nn.Conv2d(cin, 2 * k, sides, bias=True))
            self.head2 = nn.ModuleList(blocks)
            self.register_buffer("coor", _linspace_grid(gh, gw),
                                 persistent=False)
        elif head_type == "coordinates":
            self.head1 = nn.Sequential(conv(w0, k, 1, 1, 0, bias=True))
            blocks, cin = [], k + 2
            for _ in range(4):
                blocks.append(MBConv(cin, self.head_width, head_exp, 2))
                cin = self.head_width
            blocks.append(nn.Conv2d(cin, 2 * k, (map_h // 16, map_w // 16),
                                    bias=True))
            self.head2 = nn.ModuleList(blocks)
            self.register_buffer("coor", _linspace_grid(map_h, map_w),
                                 persistent=False)
        elif head_type == "heatmap" and self.grid_stride == 8:
            self.head1 = nn.Sequential(conv(w0, k * self._map_factor(gh) ** 2,
                                            1, 1, 0, bias=True))
        elif head_type == "heatmap":
            self.final_layer = conv(w0, k, 1, 1, 0, bias=True)
        else:
            downs = max(1, int(np.log2(max(4, gh) // 4)))
            blocks = [conv(w0, self.head_width, 1, 1, 0, bias=True)]
            for _ in range(downs):
                blocks.append(MBConv(self.head_width, self.head_width,
                                     head_exp, 2))
            self.head = nn.ModuleList(blocks)
            self.final_fc = nn.Sequential(
                nn.Linear(self.head_width, 256),
                nn.BatchNorm1d(256, eps=1e-5, momentum=BN_MOMENTUM),
                nn.ReLU(), nn.Linear(256, 2))
        if dtype == torch.float64:
            self.double()

    def _expansion_for(self, stage: int) -> int:
        if isinstance(self.expansion, (tuple, list)):
            return int(self.expansion[min(stage, len(self.expansion) - 1)])
        return int(self.expansion)

    def _map_factor(self, grid: int) -> int:
        """Channel-to-space factor from the grid to the heatmaps (1 where
        they have the grid's size)."""
        map_w, map_h = self.heatmap_size
        fac = map_h // grid
        if map_h % grid or fac * grid != map_w:
            raise ValueError(f"heatmap {map_h}x{map_w} not a multiple of "
                             f"grid {grid}x{grid}")
        return fac

    # ---------------- forward ----------------

    def forward(self, x):
        """x: NCHW normalized crops -> the head's outputs (see
        ``hrnet.PoseHighResolutionNet``)."""
        cache = self.inference_cache()
        ops = Ops(self.dtype, cache["cast"] if cache else None,
                  self.act_quant, self.act_quant_scale)
        stem = self.stem
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        if self.grid_stride == 8:
            x = torch.relu(ops.bn(stem["bn1"], ops.conv(stem["patch"], x)))
        else:
            x = torch.relu(ops.bn(stem["bn1"], ops.conv(stem["conv1"], x)))
            x = torch.relu(ops.bn(stem["bn2"], ops.conv(stem["conv2"], x)))
        feats = []
        for s in range(len(self.depths)):
            if s > 0:
                down = getattr(self, f"down{s}")
                x = torch.relu(ops.bn(down["bn"], ops.conv(down["conv"], x)))
            for blk in getattr(self, f"stage{s}"):
                x = blk.run(ops, x)
            feats.append(x)
        y = feats[-1]
        for s in range(len(feats) - 2, -1, -1):
            up = getattr(self, f"up{s}")
            lat = torch.relu(ops.bn(up["bn"], ops.conv(up["conv"], y)))
            y = getattr(self, f"fpn{s}").run(ops, feats[s]
                                             + pixel_shuffle(lat, 2))
        if self.head_type == "coordinates":
            if self.grid_stride == 8:
                return self._coordinates_head_s8(ops, y)
            return self._coordinates_head(ops, y)
        if self.head_type == "heatmap":
            if self.grid_stride == 8:
                return self._emit_maps(ops, y).to(ops.stat_dtype)
            return ops.conv(self.final_layer, y).to(ops.stat_dtype)
        return self._angle_head(ops, y)

    def _emit_maps(self, ops, y0):
        maps = ops.conv(self.head1[0], y0)
        return pixel_shuffle(maps, self._map_factor(y0.shape[2]))

    def _coord_trunk(self, ops, h):
        n = h.shape[0]
        for blk in self.head2[:-1]:
            h = blk.run(ops, h)
        h = ops.conv(self.head2[-1], h)
        return torch.sigmoid(h.to(ops.stat_dtype)).reshape(n, -1, 2)

    def _coordinates_head_s8(self, ops, y0):
        maps = self._emit_maps(ops, y0)
        coor = self.coor.to(y0.dtype).expand(y0.shape[0], -1, -1, -1)
        coords = self._coord_trunk(ops, torch.cat([y0, coor], dim=1))
        return maps.to(ops.stat_dtype), coords

    def _coordinates_head(self, ops, y0):
        maps = ops.conv(self.head1[0], y0)
        coor = self.coor.to(maps.dtype).expand(maps.shape[0], -1, -1, -1)
        coords = self._coord_trunk(ops, torch.cat([maps, coor], dim=1))
        return maps.to(ops.stat_dtype), coords

    def _angle_head(self, ops, y0):
        h = ops.conv(self.head[0], y0)
        for blk in self.head[1:]:
            h = blk.run(ops, h)
        h = h.mean(dim=(2, 3)).to(ops.stat_dtype)
        fc = self.final_fc
        h = torch.relu(batch_norm(fc[1], ops.linear(fc[0], h),
                                  ops.stat_dtype))
        return ops.linear(fc[3], h)


def build_tpu_native(cfgs: dict, dtype=torch.float32) -> PoseNetTPU:
    """Construct from a config dict.  ``heatmapModel.extra`` may carry
    depths / widths / expansion / head_width / grid_stride; everything else
    follows the shared heatmapModel schema."""
    hm = cfgs["heatmapModel"]
    extra = hm.get("extra", {}) or {}
    exp = extra.get("expansion", (2, 3, 4))
    exp = (tuple(int(e) for e in exp) if isinstance(exp, (tuple, list))
           else int(exp))
    return PoseNetTPU(
        depths=tuple(int(d) for d in extra.get("depths", (1, 3, 9))),
        widths=tuple(int(w) for w in extra.get("widths", (256, 512, 1024))),
        expansion=exp,
        num_joints=int(hm["num_joints"]),
        head_type=hm.get("head_type", "coordinates"),
        heatmap_size=tuple(hm.get("heatmap_size", (64, 64))),
        input_size=tuple(hm.get("input_size", (256, 256))),
        head_width=int(extra.get("head_width", 128)),
        in_channels=5 if hm.get("add_xy", False) else 3,
        dtype=dtype,
        act_quant=str(hm.get("act_quant", "none")),
        act_quant_scale=float(hm.get("act_quant_scale", 8.0)),
        grid_stride=int(extra.get("grid_stride", 8)),
    )
