"""HRNet keypoint model with the EgoNet heads, in PyTorch.  Port of
``egonet_tpu/models/hrnet.py``.

Module names equal the reference ``state_dict`` keys (e.g.
``stage2.0.branches.1.3.conv2.weight``), so JAX-exported variables and
``HC.pth`` load with ``strict=True``.  Reproduced exactly: every new
transition reads the LAST branch; the coarse-to-fine nested upsample sum;
BN eps 1e-5; and the three heads: 'coordinates' (the one EgoNet ships:
the head2 stride-2 blocks with a forced downsample, the fixed linspace
coordinate channels, the valid conv of size heatmap//16 and an fp32
sigmoid), 'heatmap' (``final_layer``, with ``pixel_shuffle`` a 1x1 conv +
BN + ReLU to K*r*r channels and a channel-to-space by r = heatmap_w /
input_w * 4) and 'angleregression' (1x1 conv, four stride-2 blocks, global
mean, dense + BatchNorm1d + ReLU + dense); maps returned NCHW.

Options of the JAX model, same math: ``act_quant: int8`` quantizes the
tensor after every block, transition and fuse output to uint8 codes and
back (``layers.Ops.transport``); ``fuse_merge`` runs the convs that read
one tensor with one geometry (layer1 block 0's conv1 / downsample pair,
the first stride-2 conv of every fuse chain out of a branch, the 1x1
up-convs out of it) as one conv over their concatenated weights, with
the same parameter tree.

Precision: in bf16 runs each conv computes in bf16 and each batch norm in
fp32, then the result is cast back to bf16 (as the JAX model does).  The
trunk runs ``channels_last``.  In eval mode with bf16 activations, every
stride-1 identity-residual branch BasicBlock (104 of them in W48 and in
the W32 pedestrian model) goes, with BN folded, through one of two Hopper
kernels that compute the same function (their plain version on the CPU):

* ``ops.fused_block.fused_basic_block``, the tiled kernel (default);
* ``ops.fused_block_stencil.fused_basic_block_stencil``, the row-streaming
  kernel, selected by ``EGONET_PALLAS_STENCIL=1`` (or ``'auto'``: when its
  probe passes), or by ``prepare_inference(stencil="1")``.

Every other batch norm (96 in W48 and in W32) then runs with the residual
add and relu after it as one ``ops.bn_act`` pass: its fp32 affine in one
fused multiply-add rounded to bf16, then the bf16 add and relu, the
roundings of the unfused ops.  Train mode, fp32 and fp64 runs stay unfused
torch ops (cuDNN), as do the stride-2 and downsampling blocks' convs (the
heads' blocks among them).

Train mode follows the JAX package's batch norm: each layer normalizes
with the biased batch statistics and moves its running variance with the
biased batch variance (``torch.nn.functional.batch_norm`` alone would
move it with the unbiased one; see ``layers.batch_norm``).  A float64
model keeps float64 parameters and computes every layer, batch norm and
head in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from egonet_tpu_torch.models.layers import (BN_MOMENTUM, CachedInference,
                                           Ops, batch_norm, pixel_shuffle)
from egonet_tpu_torch.models.layers import bn as _bn
from egonet_tpu_torch.models.layers import conv as _conv
from egonet_tpu_torch.models.layers import conv_bn as _conv_bn
from egonet_tpu_torch.ops import fused_block, fused_block_stencil


class StageCfg:
    """Static per-stage configuration."""

    def __init__(self, num_modules, num_branches, block, num_blocks,
                 num_channels, fuse_method="sum"):
        self.num_modules = int(num_modules)
        self.num_branches = int(num_branches)
        self.block = str(block)
        self.num_blocks = tuple(int(b) for b in num_blocks)
        self.num_channels = tuple(int(c) for c in num_channels)
        self.fuse_method = str(fuse_method)

    @classmethod
    def from_dict(cls, d):
        return cls(d["num_modules"], d["num_branches"], d["block"],
                   d["num_blocks"], d["num_channels"],
                   d.get("fuse_method", "sum"))

    @property
    def widths(self):
        """Branch output widths: num_channels times the block expansion
        (basic 1, bottleneck 4)."""
        exp = 4 if self.block == "bottleneck" else 1
        return tuple(c * exp for c in self.num_channels)


class _Ops(Ops):
    """``Ops`` plus the HRNet's choice of fused-block kernel and its
    ``fuse_merge`` switch (see ``prepare_inference``)."""

    def __init__(self, dtype, cast=None, stencil=False, merge=False,
                 act_quant="none", act_quant_scale=8.0, affine=None):
        super().__init__(dtype, cast, act_quant, act_quant_scale, affine)
        self.stencil = stencil
        self.merge = merge

    def fused_block(self, x, folded):
        """The chosen kernel's wrapper on NHWC x (looked up at call time)."""
        if self.stencil:
            return fused_block_stencil.fused_basic_block_stencil(x, *folded)
        return fused_block.fused_basic_block(x, *folded)

    def merged_conv(self, group, x):
        """Several convs of one kernel size and stride reading ``x`` as one
        conv over their weights concatenated along the output channels
        (pre-concatenated in the cast table, keyed by the ``group`` tuple,
        for bf16 inference), split back: the JAX package's
        ``_merged_convs``."""
        w = self.cast.get(group)
        if w is None:
            w = torch.cat([self.weight(m) for m in group])
        y = F.conv2d(x, w, None, group[0].stride, group[0].padding)
        return torch.split(y, [m.out_channels for m in group], dim=1)


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, force_downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes or force_downsample:
            self.downsample = _conv_bn(inplanes, planes, 1, stride, 0)

    @property
    def fusable(self) -> bool:
        return self.downsample is None and self.conv1.stride == (1, 1)

    def run(self, ops: Ops, x, folded=None):
        if folded is not None:
            # NCHW channels_last storage is NHWC: permutes are views
            y = ops.fused_block(
                x.contiguous(memory_format=torch.channels_last)
                .permute(0, 2, 3, 1), folded)
            return ops.transport(y.permute(0, 3, 1, 2))
        residual = x
        y = ops.bn(self.bn1, ops.conv(self.conv1, x), relu=True)
        y = ops.conv(self.conv2, y)
        if self.downsample is not None:
            residual = ops.conv_bn(self.downsample, x)
        return ops.transport(ops.bn(self.bn2, y, relu=True,
                                    residual=residual))


class Bottleneck(nn.Module):
    fusable = False

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, 1, 0)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1, 1, 0)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = _conv_bn(inplanes, planes * 4, 1, stride, 0)

    @property
    def merge_group(self):
        """conv1 and downsample.0, both 1x1 stride-1 reads of x (None
        where there is no such pair)."""
        if self.downsample is None or self.conv2.stride != (1, 1):
            return None
        return (self.conv1, self.downsample[0])

    def run(self, ops: Ops, x, folded=None):
        group = self.merge_group if ops.merge else None
        if group is not None:
            y, residual = ops.merged_conv(group, x)
        else:
            y = ops.conv(self.conv1, x)
            residual = (x if self.downsample is None
                        else ops.conv(self.downsample[0], x))
        y = ops.bn(self.bn1, y, relu=True)
        y = ops.bn(self.bn2, ops.conv(self.conv2, y), relu=True)
        y = ops.conv(self.conv3, y)
        if self.downsample is not None:
            residual = ops.bn(self.downsample[1], residual)
        return ops.transport(ops.bn(self.bn3, y, relu=True,
                                    residual=residual))


def _upsample2(x):
    """Exact nearest-neighbour x2 (an integer repeat)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class HighResolutionModule(nn.Module):
    def __init__(self, cfg: StageCfg, in_widths, multi_scale_output=True):
        super().__init__()
        nb = cfg.num_branches
        block = BasicBlock if cfg.block == "basic" else Bottleneck
        widths = cfg.widths
        self.branches = nn.ModuleList()
        for i in range(nb):
            blocks, cin = [], in_widths[i]
            for _ in range(cfg.num_blocks[i]):
                blocks.append(block(cin, cfg.num_channels[i]))
                cin = widths[i]
            self.branches.append(nn.Sequential(*blocks))
        self.out_count = (nb if multi_scale_output else 1) if nb > 1 else 0
        self.fuse_layers = nn.ModuleList()
        for i in range(self.out_count):
            row = nn.ModuleList()
            for j in range(nb):
                if j > i:
                    row.append(_conv_bn(widths[j], widths[i], 1, 1, 0))
                elif j == i:
                    row.append(None)
                else:
                    chain = [_conv_bn(widths[j], widths[i] if k == i - j - 1
                                      else widths[j], 3, 2)
                             for k in range(i - j)]
                    row.append(nn.Sequential(*chain))
            self.fuse_layers.append(row)

    def merge_groups(self):
        """``fuse_merge``'s groups, per branch j: (targets, convs) of the
        first stride-2 conv of every downsample chain out of j, then of the
        1x1 up-convs out of j (the JAX package's grouping)."""
        groups = []
        for j in range(len(self.branches)):
            down = list(range(j + 1, self.out_count))
            up = list(range(min(j, self.out_count)))
            if down:
                groups.append(("down", j, down, tuple(
                    self.fuse_layers[i][j][0][0] for i in down)))
            if up:
                groups.append(("up", j, up, tuple(
                    self.fuse_layers[i][j][0] for i in up)))
        return groups

    def run(self, ops: Ops, xs, folded):
        ys = []
        for i, branch in enumerate(self.branches):
            y = xs[i]
            for blk in branch:
                y = blk.run(ops, y, folded.get(blk))
            ys.append(y)
        if self.out_count == 0:
            return ys
        nb = len(ys)
        merge = ops.merge
        first = {}                  # fuse_merge: (i, j) -> first link's output
        if merge:
            for kind, j, targets, group in self.merge_groups():
                for i, t in zip(targets, ops.merged_conv(group, ys[j])):
                    if kind == "up":
                        first[(i, j)] = ops.bn(self.fuse_layers[i][j][1], t)
                    else:
                        first[(i, j)] = ops.bn(self.fuse_layers[i][j][0][1],
                                               t, relu=i != j + 1)
        fused = []
        for i in range(self.out_count):
            acc = None
            for j in range(i + 1):
                if j == i:
                    t = ys[j]
                else:
                    t = first[(i, j)] if merge else ys[j]
                    chain = self.fuse_layers[i][j]
                    start = 1 if merge else 0
                    for k in range(start, i - j - 1):
                        t = ops.conv_bn(chain[k], t, relu=True)
                    if start < i - j:
                        # the chain's last link adds itself to the sum
                        acc = ops.conv_bn(chain[i - j - 1], t, residual=acc)
                        continue
                acc = t if acc is None else acc + t
            # lower-resolution contributions, summed coarse-to-fine (nearest
            # up4 = up2(up2(.)), so one full-res tensor is materialized)
            up_acc = None
            for j in range(nb - 1, i, -1):
                t = (first[(i, j)] if merge
                     else ops.conv_bn(self.fuse_layers[i][j], ys[j]))
                up_acc = t if up_acc is None else _upsample2(up_acc) + t
            if up_acc is not None:
                acc = acc + _upsample2(up_acc)
            fused.append(ops.transport(torch.relu(acc)))
        return fused


HEADS = ("coordinates", "heatmap", "angleregression")


class PoseHighResolutionNet(CachedInference):
    """HRNet-W48/W32 with the EgoNet heads.

    ``forward(x)`` takes NCHW normalized crops and returns, per head,
    'coordinates': (maps [N, K, Hh, Wh], coords [N, K, 2] in [0, 1]);
    'heatmap': maps [N, K, Hh, Wh]; 'angleregression': [N, 2]; all fp32
    (fp64 for an fp64 model).  ``dtype`` is the compute dtype; parameters
    are fp32, except in an fp64 model, whose parameters are fp64."""

    def __init__(self, stage2: StageCfg, stage3: StageCfg, stage4: StageCfg,
                 num_joints=33, head_type="coordinates",
                 heatmap_size=(64, 64), input_size=(256, 256),
                 pixel_shuffle=False, final_conv_kernel=1, in_channels=3,
                 dtype=torch.float32, act_quant="none", act_quant_scale=8.0,
                 fuse_merge=False):
        super().__init__(dtype)
        if head_type not in HEADS:
            raise NotImplementedError(f"head_type {head_type!r}; known: "
                                      f"{HEADS}")
        if act_quant not in ("none", "int8"):
            raise NotImplementedError(f"act_quant {act_quant!r}")
        self.head_type = head_type
        self.num_joints = int(num_joints)
        self.heatmap_size = tuple(int(s) for s in heatmap_size)
        self.act_quant = act_quant
        self.act_quant_scale = float(act_quant_scale)
        self.fuse_merge = bool(fuse_merge)
        # eval-mode bf16 runs send the fusable branch blocks through the
        # fused kernel; False keeps every block on unfused torch ops
        self.fuse_blocks = True
        # EGONET_PALLAS_STENCIL value given to prepare_inference (None: the
        # environment's); kept so that a rebuild keeps the choice
        self.stencil = None

        self.conv1 = _conv(in_channels, 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = _bn(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64),
                                    *[Bottleneck(256, 64) for _ in range(3)])
        self.stage_cfgs = (stage2, stage3, stage4)
        pre = (256,)
        for s, cfg in enumerate(self.stage_cfgs, start=2):
            setattr(self, f"transition{s - 1}", self._transition(pre, cfg.widths))
            mods, in_w = [], cfg.widths
            for m in range(cfg.num_modules):
                mso = s != 4 or m < cfg.num_modules - 1
                mods.append(HighResolutionModule(cfg, in_w, mso))
            setattr(self, f"stage{s}", nn.Sequential(*mods))
            pre = cfg.widths

        k = self.num_joints
        map_w, map_h = self.heatmap_size
        w0 = stage4.widths[0]
        if head_type == "coordinates":
            self.head1 = nn.Sequential(_conv(w0, k, 1, 1, 0, bias=True))
            self.head2 = nn.Sequential(
                *[BasicBlock(k + 2 if b == 0 else 2 * k, 2 * k, 2,
                             force_downsample=True) for b in range(4)],
                nn.Conv2d(2 * k, 2 * k, (map_h // 16, map_w // 16),
                          bias=True))
            xs = np.tile(np.linspace(0, 1, map_w, dtype=np.float32),
                         (map_h, 1))
            ys = np.tile(np.linspace(0, 1, map_h, dtype=np.float32)[:, None],
                         (1, map_w))
            self.register_buffer("coor",
                                 torch.from_numpy(np.stack([xs, ys])),
                                 persistent=False)              # [2, H, W]
        elif head_type == "heatmap":
            fk = int(final_conv_kernel)
            self.final_layer = _conv(w0, k, fk, 1, 1 if fk == 3 else 0,
                                     bias=True)
            self.shuffle, self.upsample_layer = 1, None
            if pixel_shuffle:
                r = int(self.heatmap_size[0] / int(input_size[0]) * 4)
                self.shuffle = r
                self.upsample_layer = nn.Sequential(
                    nn.Conv2d(k, k * r * r, 1, bias=True), _bn(k * r * r))
        else:
            self.head = nn.Sequential(
                _conv(w0, 256, 1, 1, 0, bias=True),
                *[BasicBlock(256, 256, 2, force_downsample=True)
                  for _ in range(4)])
            self.final_fc = nn.Sequential(
                nn.Linear(256, 256),
                nn.BatchNorm1d(256, eps=1e-5, momentum=BN_MOMENTUM),
                nn.ReLU(), nn.Linear(256, 2))
        if dtype == torch.float64:
            self.double()

    @staticmethod
    def _transition(pre_widths, cur_widths):
        num_pre = len(pre_widths)
        layers = nn.ModuleList()
        for i, ch in enumerate(cur_widths):
            if i < num_pre:
                # a width change reads the LAST previous branch
                layers.append(_conv_bn(pre_widths[-1], ch, 3)
                              if pre_widths[i] != ch else None)
            else:
                chain, cin = [], pre_widths[-1]
                for j in range(i + 1 - num_pre):
                    out_ch = ch if j == i - num_pre else cin
                    chain.append(_conv_bn(cin, out_ch, 3, 2))
                    cin = out_ch
                layers.append(nn.Sequential(*chain))
        return layers

    def _run_transition(self, ops, layers, x_list):
        num_pre = len(x_list)
        outs = []
        for i, layer in enumerate(layers):
            if i < num_pre:
                outs.append(x_list[i] if layer is None else ops.transport(
                    ops.conv_bn(layer, x_list[-1], relu=True)))
            else:
                y = x_list[-1]
                for cb in layer:
                    y = ops.conv_bn(cb, y, relu=True)
                outs.append(y)
        return outs

    # ---------------- inference preparation ----------------

    def _fusable_blocks(self, stencil: bool = False):
        """The stride-1 identity branch blocks whose width the chosen
        kernel takes (the stencil's with ``stencil``, else the tiled
        one's); the others run unfused on every device."""
        takes = (fused_block_stencil if stencil else fused_block).takes
        for s in (2, 3, 4):
            for mod in getattr(self, f"stage{s}"):
                for branch in mod.branches:
                    for blk in branch:
                        if blk.fusable and takes(blk.conv2.out_channels):
                            yield blk

    def _merge_groups(self):
        """Every conv group ``fuse_merge`` runs as one conv."""
        groups = [blk.merge_group for blk in self.layer1
                  if blk.merge_group is not None]
        for s in (2, 3, 4):
            for mod in getattr(self, f"stage{s}"):
                groups += [g for *_, g in mod.merge_groups()]
        return groups

    def prepare_inference(self, stencil: str | None = None):
        """Fold BN into every fusable branch block, pre-cast the conv
        weights to the compute dtype (and concatenate ``fuse_merge``'s
        groups; each other batch norm's fp32 (scale, shift) for
        ``ops.bn_act``), once, from the current fp32 parameters, and choose
        the fused-block kernel: ``fused_block_stencil.stencil_enabled(stencil)``
        ('0' tiled, '1' stencil, 'auto' probe; None reads
        EGONET_PALLAS_STENCIL).  Both kernels take the same folded weights.
        Rebuilt after ``load_state_dict`` and whenever the parameters move
        (``.to``) or train mode is entered; an explicit ``stencil`` is kept
        for those rebuilds."""
        if stencil is not None:
            self.stencil = stencil
        return super().prepare_inference()

    def _build_cache(self) -> dict:
        stencil = fused_block_stencil.stencil_enabled(self.stencil)
        folded = {}
        if self.dtype == torch.bfloat16:
            for blk in self._fusable_blocks(stencil):
                folded[blk] = (
                    *fused_block.fold_conv_bn(blk.conv1.weight, blk.bn1),
                    *fused_block.fold_conv_bn(blk.conv2.weight, blk.bn2))
        cache = super()._build_cache(
            folded={bn for blk in folded for bn in (blk.bn1, blk.bn2)})
        cache["folded"] = folded
        cache["stencil"] = stencil
        if self.dtype == torch.bfloat16 and self.fuse_merge:
            for group in self._merge_groups():
                cache["cast"][group] = torch.cat(
                    [cache["cast"][m] for m in group]).contiguous(
                        memory_format=torch.channels_last)
        return cache

    # ---------------- forward ----------------

    def forward(self, x):
        cache = self.inference_cache()
        ops = _Ops(self.dtype, cache["cast"] if cache else None,
                   bool(cache and cache["stencil"]), self.fuse_merge,
                   self.act_quant, self.act_quant_scale,
                   cache["affine"] if cache else None)
        folded = (cache["folded"] if cache and self.fuse_blocks
                  else {})
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = ops.bn(self.bn1, ops.conv(self.conv1, x), relu=True)
        x = ops.bn(self.bn2, ops.conv(self.conv2, x), relu=True)
        for blk in self.layer1:
            x = blk.run(ops, x)
        ys = [x]
        for s in (2, 3, 4):
            xs = self._run_transition(ops, getattr(self, f"transition{s - 1}"),
                                      ys)
            for mod in getattr(self, f"stage{s}"):
                xs = mod.run(ops, xs, folded)
            ys = xs
        if self.head_type == "coordinates":
            return self._coordinates_head(ops, ys[0])
        if self.head_type == "heatmap":
            return self._heatmap_head(ops, ys[0])
        return self._angle_head(ops, ys[0])

    def _coordinates_head(self, ops, y0):
        n = y0.shape[0]
        maps = ops.conv(self.head1[0], y0)
        coor = self.coor.to(maps.dtype).expand(n, -1, -1, -1)
        h = torch.cat([maps, coor], dim=1)
        for b in range(4):
            h = self.head2[b].run(ops, h)
        h = ops.conv(self.head2[4], h)
        coords = torch.sigmoid(h.to(ops.stat_dtype)).reshape(n, -1, 2)
        return maps.to(ops.stat_dtype), coords                 # [N, K, 2]

    def _heatmap_head(self, ops, y0):
        x = ops.conv(self.final_layer, y0)
        if self.upsample_layer is not None:
            x = ops.conv_bn(self.upsample_layer, x, relu=True)
            x = pixel_shuffle(x, self.shuffle)
        return x.to(ops.stat_dtype)

    def _angle_head(self, ops, y0):
        h = ops.conv(self.head[0], y0)
        for b in range(1, 5):
            h = self.head[b].run(ops, h)
        # the reference's AvgPool2d(4) on the remaining 4x4 map (input 256)
        # as a global mean, as the JAX package takes it
        h = h.mean(dim=(2, 3)).to(ops.stat_dtype)
        fc = self.final_fc
        h = torch.relu(batch_norm(fc[1], ops.linear(fc[0], h),
                                  ops.stat_dtype))
        return ops.linear(fc[3], h)


def build_hrnet(cfgs: dict, dtype=torch.float32) -> PoseHighResolutionNet:
    """Construct from a reference-style config dict (cfgs['heatmapModel'])."""
    hm = cfgs["heatmapModel"]
    extra = hm["extra"]
    return PoseHighResolutionNet(
        stage2=StageCfg.from_dict(extra["stage2"]),
        stage3=StageCfg.from_dict(extra["stage3"]),
        stage4=StageCfg.from_dict(extra["stage4"]),
        num_joints=int(hm["num_joints"]),
        head_type=hm.get("head_type", "coordinates"),
        heatmap_size=tuple(hm.get("heatmap_size", (64, 64))),
        input_size=tuple(hm.get("input_size", (256, 256))),
        pixel_shuffle=bool(hm.get("pixel_shuffle", False)),
        final_conv_kernel=int(extra.get("final_conv_kernel", 1)),
        in_channels=5 if hm.get("add_xy", False) else 3,
        dtype=dtype,
        act_quant=str(hm.get("act_quant", "none")),
        act_quant_scale=float(hm.get("act_quant_scale", 8.0)),
        fuse_merge=bool(hm.get("fuse_merge", False)),
    )
