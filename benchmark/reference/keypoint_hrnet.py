"""The keypoint family ``hrnet`` (``heatmapModel.name`` 'hrnet', the
default, or 'pose_hrnet'): HRNet (Sun et al. 2019) with EgoNet's
'coordinates' head, in plain fp32 PyTorch.

The trunk: a two-conv stride-4 stem, four Bottlenecks (``layer1``), then
stages 2-4 of parallel branches of BasicBlocks at the widths of
``heatmapModel.extra``, fused across branches after each module.  The
head: a 1x1 conv to K heatmaps, two linspace(0, 1) coordinate channels,
four stride-2 BasicBlocks with a 1x1 downsample each, a valid conv to 2K
numbers and a sigmoid giving each joint's (x, y) in [0, 1] of the crop.

The architecture is walked once by :func:`_hrnet` through the
reference's walkers (``egonet_ref._Spec`` / ``_Compute``, and
``work._FlopSpec`` for the FLOPs), so the parameter list, the forward
pass and the work count cannot disagree.  Parameter names are the
port's ``state_dict`` keys.
"""

from __future__ import annotations

import torch

from benchmark.reference import egonet_ref as ref
from benchmark.work import _FlopSpec


def _basic(o, name, x, planes, stride=1, downsample=False):
    y = o.relu(o.bn(name + ".bn1", o.conv(name + ".conv1", x, planes, 3,
                                          stride)))
    y = o.bn(name + ".bn2", o.conv(name + ".conv2", y, planes, 3))
    r = x
    if downsample:
        r = o.bn(name + ".downsample.1",
                 o.conv(name + ".downsample.0", x, planes, 1, stride, 0))
    return o.relu(o.add(y, r))


def _bottleneck(o, name, x, planes, downsample=False):
    y = o.relu(o.bn(name + ".bn1", o.conv(name + ".conv1", x, planes, 1,
                                          1, 0)))
    y = o.relu(o.bn(name + ".bn2", o.conv(name + ".conv2", y, planes, 3)))
    y = o.bn(name + ".bn3", o.conv(name + ".conv3", y, planes * 4, 1, 1, 0))
    r = x
    if downsample:
        r = o.bn(name + ".downsample.1",
                 o.conv(name + ".downsample.0", x, planes * 4, 1, 1, 0))
    return o.relu(o.add(y, r))


def _conv_bn(o, name, x, cout, k, stride=1, pad=None):
    return o.bn(name + ".1", o.conv(name + ".0", x, cout, k, stride, pad))


def _hrnet(o, x, hm):
    """HRNet + the coordinates head on ``x``; ``hm`` is the config's
    ``heatmapModel``.  Returns [N, K, 2] coordinates in [0, 1]."""
    x = o.relu(o.bn("bn1", o.conv("conv1", x, 64, 3, 2)))
    x = o.relu(o.bn("bn2", o.conv("conv2", x, 64, 3, 2)))
    for b in range(4):
        x = _bottleneck(o, f"layer1.{b}", x, 64, downsample=b == 0)
    ys, pre = [x], (256,)
    extra = hm["extra"]
    for s in (2, 3, 4):
        st = extra[f"stage{s}"]
        assert st["block"] == "basic"
        widths = tuple(st["num_channels"])
        # transition: a width change, or a new branch, reads the LAST
        # previous branch (stride-2 3x3 conv chains for new branches)
        xs = []
        for i, c in enumerate(widths):
            tname = f"transition{s - 1}.{i}"
            if i < len(pre):
                xs.append(ys[i] if pre[i] == c else o.relu(
                    _conv_bn(o, tname, ys[-1], c, 3)))
            else:
                y, cin = ys[-1], pre[-1]
                for j in range(i + 1 - len(pre)):
                    cout = c if j == i - len(pre) else cin
                    y = o.relu(_conv_bn(o, f"{tname}.{j}", y, cout, 3, 2))
                    cin = cout
                xs.append(y)
        for m in range(st["num_modules"]):
            mname = f"stage{s}.{m}"
            nb = st["num_branches"]
            for i in range(nb):
                for b in range(st["num_blocks"][i]):
                    xs[i] = _basic(o, f"{mname}.branches.{i}.{b}", xs[i],
                                   widths[i])
            n_out = nb if (s != 4 or m < st["num_modules"] - 1) else 1
            fused = []
            for i in range(n_out):
                acc = xs[i]
                for j in range(nb):
                    fname = f"{mname}.fuse_layers.{i}.{j}"
                    if j > i:
                        t = o.upsample(_conv_bn(o, fname, xs[j], widths[i],
                                                1, 1, 0), 2 ** (j - i))
                    elif j < i:
                        t = xs[j]
                        for k in range(i - j):
                            last = k == i - j - 1
                            t = _conv_bn(o, f"{fname}.{k}", t,
                                         widths[i] if last else widths[j],
                                         3, 2)
                            if not last:
                                t = o.relu(t)
                    else:
                        continue
                    acc = o.add(acc, t)
                fused.append(o.relu(acc))
            xs = fused
        ys, pre = xs, widths
    k = int(hm["num_joints"])
    map_w, map_h = hm["heatmap_size"]
    h = o.conv("head1.0", ys[0], k, 1, 1, 0, bias=True)
    h = o.cat_coords(h)
    for b in range(4):
        h = _basic(o, f"head2.{b}", h, 2 * k, 2, downsample=True)
    h = o.conv("head2.4", h, 2 * k, (map_h // 16, map_w // 16), 1, 0,
               bias=True)
    return o.sigmoid_coords(h)


def _walk(o, cfg):
    hm = cfg["heatmapModel"]
    w, h = hm["input_size"]
    _hrnet(o, (1, 3, h, w), hm)
    return o


def shapes(cfg) -> dict:
    """{state_dict key: shape} of the keypoint model, in draw order."""
    return _walk(ref._Spec(), cfg).shapes


def forward(state, x, cfg, calibrate=False):
    """[N, K, 2] coordinates in [0, 1] of the crops ``x`` (fp32 NCHW)."""
    return _hrnet(ref._Compute(state, calibrate), x, cfg["heatmapModel"])


def fit_head(state, x, cfg, params):
    """Calibrate every batch norm on the crops ``x``, then rescale the
    head's last conv (``head2.4``) so its logits, centred per channel over
    the crops, have standard deviation ``params['logit_std']``; in place
    in ``state``."""
    coords = forward(state, x, cfg, calibrate=True)
    # the head's logits, standardised per channel
    p = coords.double().clamp(1e-12, 1 - 1e-12).reshape(len(x), -1)
    logits = torch.log(p / (1 - p))
    centred = logits - logits.mean(0)
    gain = float(params["logit_std"]) / centred.std().clamp_min(1e-6)
    gain = gain.expand(logits.shape[1])
    w, b = state["head2.4.weight"], state["head2.4.bias"]
    state["head2.4.bias"] = (b - logits.mean(0).float()) * gain.float()
    state["head2.4.weight"] = w * gain.float()[:, None, None, None]


def flops(cfg) -> int:
    """FLOPs a crop of the trunk and head (``work.py``'s convention)."""
    return _walk(_FlopSpec(), cfg).flops


def shrink(cfg) -> dict:
    """The CPU tests' cut of ``cfg['heatmapModel']``, in place: widths
    8/16/32/64, one block a branch and one module a stage, 64x64 crops
    (16x16 heatmaps)."""
    extra = cfg["heatmapModel"]["extra"]
    chans = {"stage2": [8, 16], "stage3": [8, 16, 32],
             "stage4": [8, 16, 32, 64]}
    for s, c in chans.items():
        extra[s].update({"num_channels": c, "num_blocks": [1] * len(c),
                         "num_modules": 1})
    cfg["heatmapModel"]["input_size"] = [64, 64]
    cfg["heatmapModel"]["heatmap_size"] = [16, 16]
    return cfg
