"""HRNet keypoint model with the EgoNet 'coordinates' head, in PyTorch.
Port of ``egonet_tpu/models/hrnet.py``.

Module names equal the reference ``state_dict`` keys (e.g.
``stage2.0.branches.1.3.conv2.weight``), so JAX-exported variables and
``HC.pth`` load with ``strict=True``.  Reproduced exactly: every new
transition reads the LAST branch; the coarse-to-fine nested upsample sum;
the head2 stride-2 blocks with a forced downsample; the fixed linspace
coordinate channels; the valid conv of size heatmap//16 and an fp32
sigmoid; maps returned NCHW; BN eps 1e-5.

Precision: in bf16 runs each conv computes in bf16 and each batch norm in
fp32, then the result is cast back to bf16 (as the JAX model does).  The
trunk runs ``channels_last``.  In eval mode with bf16 activations, every
stride-1 identity-residual branch BasicBlock (104 of them in W48) goes,
with BN folded, through one of two Hopper kernels that compute the same
function (their plain version on the CPU):

* ``ops.fused_block.fused_basic_block``, the tiled kernel (default);
* ``ops.fused_block_stencil.fused_basic_block_stencil``, the row-streaming
  kernel, selected by ``EGONET_PALLAS_STENCIL=1`` (or ``'auto'``: when its
  probe passes), or by ``prepare_inference(stencil="1")``.

Train mode, fp32 runs, stride-2 and downsampling blocks stay unfused torch
ops (cuDNN).

Not ported yet (raise NotImplementedError): the 'heatmap' and
'angleregression' heads, ``fuse_merge`` and ``act_quant``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from egonet_tpu_torch.ops import fused_block, fused_block_stencil

BN_MOMENTUM = 0.1


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


def _conv(cin, cout, k, stride=1, padding=None, bias=False):
    if padding is None:
        padding = (k - 1) // 2
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


def _conv_bn(cin, cout, k, stride=1, padding=None):
    return nn.Sequential(_conv(cin, cout, k, stride, padding), _bn(cout))


class _Ops:
    """The primitive layers, parameterized by the compute dtype, an
    optional table of pre-cast weights and the choice of fused-block kernel
    (see ``prepare_inference``)."""

    def __init__(self, dtype, cast, stencil=False):
        self.dtype = dtype
        self.cast = cast or {}
        self.stencil = stencil

    def fused_block(self, x, folded):
        """The chosen kernel's wrapper on NHWC x (looked up at call time)."""
        if self.stencil:
            return fused_block_stencil.fused_basic_block_stencil(x, *folded)
        return fused_block.fused_basic_block(x, *folded)

    def conv(self, m: nn.Conv2d, x):
        w = self.cast.get(m)
        if w is None:
            w = m.weight.to(self.dtype)
        b = None if m.bias is None else m.bias.to(self.dtype)
        return F.conv2d(x, w, b, m.stride, m.padding)

    def bn(self, m: nn.BatchNorm2d, x):
        y = F.batch_norm(x.float(), m.running_mean, m.running_var, m.weight,
                         m.bias, m.training, m.momentum, m.eps)
        return y.to(self.dtype)

    def conv_bn(self, seq: nn.Sequential, x):
        return self.bn(seq[1], self.conv(seq[0], x))


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

    def run(self, ops: _Ops, x, folded=None):
        if folded is not None:
            # NCHW channels_last storage is NHWC: permutes are views
            y = ops.fused_block(
                x.contiguous(memory_format=torch.channels_last)
                .permute(0, 2, 3, 1), folded)
            return y.permute(0, 3, 1, 2)
        residual = x
        y = torch.relu(ops.bn(self.bn1, ops.conv(self.conv1, x)))
        y = ops.bn(self.bn2, ops.conv(self.conv2, y))
        if self.downsample is not None:
            residual = ops.conv_bn(self.downsample, x)
        return torch.relu(y + residual)


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

    def run(self, ops: _Ops, x, folded=None):
        residual = x
        y = torch.relu(ops.bn(self.bn1, ops.conv(self.conv1, x)))
        y = torch.relu(ops.bn(self.bn2, ops.conv(self.conv2, y)))
        y = ops.bn(self.bn3, ops.conv(self.conv3, y))
        if self.downsample is not None:
            residual = ops.conv_bn(self.downsample, x)
        return torch.relu(y + residual)


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

    def run(self, ops: _Ops, xs, folded):
        ys = []
        for i, branch in enumerate(self.branches):
            y = xs[i]
            for blk in branch:
                y = blk.run(ops, y, folded.get(blk))
            ys.append(y)
        if self.out_count == 0:
            return ys
        nb = len(ys)
        fused = []
        for i in range(self.out_count):
            acc = None
            for j in range(i + 1):
                if j == i:
                    t = ys[j]
                else:
                    t = ys[j]
                    chain = self.fuse_layers[i][j]
                    for k, cb in enumerate(chain):
                        t = ops.conv_bn(cb, t)
                        if k != i - j - 1:
                            t = torch.relu(t)
                acc = t if acc is None else acc + t
            # lower-resolution contributions, summed coarse-to-fine (nearest
            # up4 = up2(up2(.)), so one full-res tensor is materialized)
            up_acc = None
            for j in range(nb - 1, i, -1):
                t = ops.conv_bn(self.fuse_layers[i][j], ys[j])
                up_acc = t if up_acc is None else _upsample2(up_acc) + t
            if up_acc is not None:
                acc = acc + _upsample2(up_acc)
            fused.append(torch.relu(acc))
        return fused


class PoseHighResolutionNet(nn.Module):
    """HRNet-W48/W32 with the EgoNet 'coordinates' head.

    ``forward(x)`` takes NCHW normalized crops and returns (maps
    [N, K, Hh, Wh] fp32, coords [N, K, 2] fp32 in [0, 1]).  ``dtype`` is
    the compute dtype; parameters stay fp32."""

    def __init__(self, stage2: StageCfg, stage3: StageCfg, stage4: StageCfg,
                 num_joints=33, head_type="coordinates",
                 heatmap_size=(64, 64), in_channels=3, dtype=torch.float32):
        super().__init__()
        if head_type != "coordinates":
            raise NotImplementedError(
                f"head_type {head_type!r} is not ported yet (queued)")
        self.dtype = dtype
        self.num_joints = int(num_joints)
        self.heatmap_size = tuple(int(s) for s in heatmap_size)
        # eval-mode bf16 runs send the fusable branch blocks through the
        # fused kernel; False keeps every block on unfused torch ops
        self.fuse_blocks = True
        # EGONET_PALLAS_STENCIL value given to prepare_inference (None: the
        # environment's); kept so that a rebuild keeps the choice
        self.stencil = None
        self._inference_cache = None

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
        self.head1 = nn.Sequential(_conv(stage4.widths[0], k, 1, 1, 0,
                                         bias=True))
        self.head2 = nn.Sequential(
            *[BasicBlock(k + 2 if b == 0 else 2 * k, 2 * k, 2,
                         force_downsample=True) for b in range(4)],
            nn.Conv2d(2 * k, 2 * k, (map_h // 16, map_w // 16), bias=True))
        xs = np.tile(np.linspace(0, 1, map_w, dtype=np.float32), (map_h, 1))
        ys = np.tile(np.linspace(0, 1, map_h, dtype=np.float32)[:, None],
                     (1, map_w))
        self.register_buffer("coor", torch.from_numpy(np.stack([xs, ys])),
                             persistent=False)                  # [2, H, W]

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
                outs.append(x_list[i] if layer is None else
                            torch.relu(ops.conv_bn(layer, x_list[-1])))
            else:
                y = x_list[-1]
                for cb in layer:
                    y = torch.relu(ops.conv_bn(cb, y))
                outs.append(y)
        return outs

    # ---------------- inference preparation ----------------

    def _fusable_blocks(self):
        for s in (2, 3, 4):
            for mod in getattr(self, f"stage{s}"):
                for branch in mod.branches:
                    for blk in branch:
                        if blk.fusable:
                            yield blk

    def prepare_inference(self, stencil: str | None = None):
        """Fold BN into every fusable branch block, pre-cast the conv
        weights to the compute dtype, once, from the current fp32
        parameters, and choose the fused-block kernel:
        ``fused_block_stencil.stencil_enabled(stencil)`` ('0' tiled, '1'
        stencil, 'auto' probe; None reads EGONET_PALLAS_STENCIL).  Both
        kernels take the same folded weights.  Rebuilt after
        ``load_state_dict`` and whenever the parameters move (``.to``) or
        train mode is entered; an explicit ``stencil`` is kept for those
        rebuilds."""
        if stencil is not None:
            self.stencil = stencil
        cache = {"folded": {}, "cast": {},
                 "stencil": fused_block_stencil.stencil_enabled(self.stencil)}
        if self.dtype == torch.bfloat16:
            with torch.no_grad():
                for blk in self._fusable_blocks():
                    cache["folded"][blk] = (
                        *fused_block.fold_conv_bn(blk.conv1.weight, blk.bn1),
                        *fused_block.fold_conv_bn(blk.conv2.weight, blk.bn2))
                for m in self.modules():
                    if isinstance(m, nn.Conv2d):
                        cache["cast"][m] = m.weight.detach().to(
                            self.dtype, memory_format=torch.channels_last)
        self._inference_cache = cache
        return self

    def load_state_dict(self, state_dict, strict: bool = True, **kw):
        result = super().load_state_dict(state_dict, strict=strict, **kw)
        self.prepare_inference()
        return result

    def _apply(self, fn, *args, **kw):
        self._inference_cache = None
        return super()._apply(fn, *args, **kw)

    def train(self, mode: bool = True):
        if mode:
            self._inference_cache = None
        return super().train(mode)

    # ---------------- forward ----------------

    def forward(self, x):
        inference = not self.training
        if inference and self._inference_cache is None:
            self.prepare_inference()
        cache = self._inference_cache if inference else None
        ops = _Ops(self.dtype, cache["cast"] if cache else None,
                   bool(cache and cache["stencil"]))
        folded = (cache["folded"] if cache and self.fuse_blocks
                  else {})
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = torch.relu(ops.bn(self.bn1, ops.conv(self.conv1, x)))
        x = torch.relu(ops.bn(self.bn2, ops.conv(self.conv2, x)))
        for blk in self.layer1:
            x = blk.run(ops, x)
        ys = [x]
        for s in (2, 3, 4):
            xs = self._run_transition(ops, getattr(self, f"transition{s - 1}"),
                                      ys)
            for mod in getattr(self, f"stage{s}"):
                xs = mod.run(ops, xs, folded)
            ys = xs
        return self._coordinates_head(ops, ys[0])

    def _coordinates_head(self, ops, y0):
        n = y0.shape[0]
        maps = ops.conv(self.head1[0], y0)
        coor = self.coor.to(maps.dtype).expand(n, -1, -1, -1)
        h = torch.cat([maps, coor], dim=1)
        for b in range(4):
            h = self.head2[b].run(ops, h)
        h = ops.conv(self.head2[4], h)
        coords = torch.sigmoid(h.float()).reshape(n, -1, 2)    # [N, K, 2]
        return maps.float(), coords


def build_hrnet(cfgs: dict, dtype=torch.float32) -> PoseHighResolutionNet:
    """Construct from a reference-style config dict (cfgs['heatmapModel'])."""
    hm = cfgs["heatmapModel"]
    extra = hm["extra"]
    if str(hm.get("act_quant", "none")) != "none":
        raise NotImplementedError("act_quant is not ported yet (queued)")
    if bool(hm.get("fuse_merge", False)):
        raise NotImplementedError("fuse_merge is not ported yet (queued)")
    return PoseHighResolutionNet(
        stage2=StageCfg.from_dict(extra["stage2"]),
        stage3=StageCfg.from_dict(extra["stage3"]),
        stage4=StageCfg.from_dict(extra["stage4"]),
        num_joints=int(hm["num_joints"]),
        head_type=hm.get("head_type", "coordinates"),
        heatmap_size=tuple(hm.get("heatmap_size", (64, 64))),
        in_channels=5 if hm.get("add_xy", False) else 3,
        dtype=dtype,
    )
