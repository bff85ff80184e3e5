"""Plain fp32 PyTorch reference of EgoNet's inference, written from the
published description (Li et al., "Exploring intermediate representation
for monocular vehicle pose estimation", CVPR 2021, and its code
github.com/Nicholasli1995/EgoNet), against which the benchmark judges the
program's outputs.  It and the keypoint families beside it import torch,
numpy, the standard library and one another (and ``benchmark/work.py``'s
FLOP walker), nothing of the program.

Stages, per detection box:

1. the crop: the box enlarged by ``enlarge`` about its centre, widened or
   heightened to the crop's aspect ratio, mapped onto the crop by a
   uniform scale (patch pixel p -> source pixel c + (p - out/2) * k);
2. bilinear sampling of the frame (zero outside it), rounded to whole
   levels (half to even), scaled to [0, 1] and normalised by mean / std;
3. the keypoint model of the configuration's family, found by
   ``heatmapModel.name`` (:func:`keypoint_model`): the crops' [N, K, 2]
   joint coordinates in [0, 1] of the crop;
4. the inverse of step 1's map, back to screen pixels;
5. the FC lifter (Martinez et al. 2017): normalise, Linear-BN-ReLU, N
   residual blocks of two Linear-BN-ReLU, Linear, un-normalise -> 32
   centre-relative cuboid points;
6. a cuboid template sized by the mean edge lengths, fitted by Kabsch's
   SVD solve (float64), the rotation read as R = Rz(c) Rx(b) Ry(a), and
   alpha = ry - atan2(-f, x - cx) - pi/2 from the first keypoint's x.

Batch norm runs with its running statistics (inference).  Everything is
fp32 (TF32 off) but the rigid solve, which is float64.

A network is walked once, by a family's walk or :func:`_lifter`,
through an object that either computes (``_Compute``) or lists each
parameter's name and shape (``_Spec``), so the parameter list and the
forward pass cannot disagree; a family that needs another primitive
subclasses them.  ``calibrate=True`` sets every batch norm's running
mean to 0 and its running variance to its input's mean square over the
whole layer (the benchmark's seeded weights use it to keep each layer's
output at a known scale).
"""

from __future__ import annotations

import importlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

SIZE = 200.0                      # a crop "scale" s covers s * 200 pixels
BN_EPS = 1e-5
# the 12 cuboid edges as (parent, child) corner slots of the 32-point
# centre-relative prediction (corners are slots 0..7): 4 along the height,
# 4 along the length, 4 along the width
EDGE_PARENT = (0, 2, 4, 6, 0, 1, 2, 3, 0, 1, 4, 5)
EDGE_CHILD = (1, 3, 5, 7, 4, 5, 6, 7, 2, 3, 6, 7)
INTERP = (0.332, 0.667)
# heatmapModel.name -> family, as the port's models/factory.py names them
KEYPOINT_ALIASES = {"pose_hrnet": "hrnet", "pose_resnet": "resnet",
                    "posenet_tpu": "tpu_native"}


# ---------------------------------------------------------------------------
# crops (host, float64)

def crop_affines(boxes, out_hw, enlarge: float = 1.1):
    """Patch -> source affines [N, 2, 3] (float64) and each crop's source
    width [N] for boxes [N, 4] (x1, y1, x2, y2); ``out_hw`` = (h, w)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    out_h, out_w = float(out_hw[0]), float(out_hw[1])
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    w = (boxes[:, 2] - boxes[:, 0]) * enlarge
    h = (boxes[:, 3] - boxes[:, 1]) * enlarge
    ar = out_h / out_w
    w = np.where(h / w > ar, h / ar, w)
    scale_w = w / SIZE                       # the crop covers s * SIZE px
    k = scale_w * SIZE / out_w
    inv = np.zeros((len(boxes), 2, 3))
    inv[:, 0, 0] = k
    inv[:, 1, 1] = k
    inv[:, 0, 2] = cx - k * out_w / 2
    inv[:, 1, 2] = cy - k * out_h / 2
    return inv, scale_w * SIZE


def sample_crops(frames, frame_idx, inv, out_hw):
    """Bilinear samples [N, h, w, 3] (fp32, 0-255 scale) of uint8 frames
    [B, H, W, 3] (a tensor on the reference's device) at the affines
    ``inv`` [N, 2, 3]; taps outside the frame read zero."""
    dev = frames.device
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    big_h, big_w = frames.shape[1], frames.shape[2]
    inv = torch.as_tensor(inv, dtype=torch.float32, device=dev)
    idx = torch.as_tensor(np.asarray(frame_idx), dtype=torch.long,
                          device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    sx = inv[:, 0, 0, None] * xs[None] + inv[:, 0, 2, None]       # [N, w]
    sy = inv[:, 1, 1, None] * ys[None] + inv[:, 1, 2, None]       # [N, h]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    out = torch.zeros((len(inv), out_h, out_w, 3), dtype=torch.float32,
                      device=dev)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = ((yy >= 0) & (yy < big_h))[:, :, None] \
                & ((xx >= 0) & (xx < big_w))[:, None, :]
            px = frames[idx[:, None, None], yy.clamp(0, big_h - 1)[:, :, None],
                        xx.clamp(0, big_w - 1)[:, None, :]].float()
            wgt = (wy[:, :, None] * wx[:, None, :] * ok)[..., None]
            out += px * wgt
    return out


def normalize_crops(samples, mean, std):
    """0-255 samples [N, h, w, 3] -> NCHW network input."""
    dev = samples.device
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev)
    x = (torch.round(samples) / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# the walkers: a network walked once for its parameters and its forward pass

class _Spec:
    """Lists parameter names and shapes; activations are shapes (N, C, H,
    W)."""

    def __init__(self):
        self.shapes = {}

    def conv(self, name, x, cout, k, stride=1, pad=None, bias=False):
        n, cin, h, w = x
        kh, kw = (k, k) if isinstance(k, int) else k
        pad = (kh - 1) // 2 if pad is None else pad
        self.shapes[name + ".weight"] = (cout, cin, kh, kw)
        if bias:
            self.shapes[name + ".bias"] = (cout,)
        return (n, cout, (h + 2 * pad - kh) // stride + 1,
                (w + 2 * pad - kw) // stride + 1)

    def bn(self, name, x):
        c = x[1]
        for p in ("weight", "bias", "running_mean", "running_var"):
            self.shapes[f"{name}.{p}"] = (c,)
        self.shapes[name + ".num_batches_tracked"] = ()
        return x

    def relu(self, x):
        return x

    def add(self, a, b):
        return a

    def upsample(self, x, factor):
        return (x[0], x[1], x[2] * factor, x[3] * factor)

    def cat_coords(self, x):
        return (x[0], x[1] + 2, x[2], x[3])

    def sigmoid_coords(self, x):
        return (x[0], x[1] // 2, 2)


class _Compute:
    """Runs the walk on fp32 NCHW tensors with parameters from ``state``;
    with ``calibrate`` each batch norm first takes 0 as its running mean
    and its input's mean square as its running variance."""

    def __init__(self, state, calibrate=False):
        self.p = state
        self.calibrate = calibrate

    def conv(self, name, x, cout, k, stride=1, pad=None, bias=False):
        w = self.p[name + ".weight"]
        pad = (w.shape[2] - 1) // 2 if pad is None else pad
        b = self.p[name + ".bias"] if bias else None
        return F.conv2d(x, w, b, stride, pad)

    def bn(self, name, x):
        mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        if self.calibrate:
            mean.zero_()
            var.fill_(float((x * x).mean()))
        return F.batch_norm(x, mean, var, self.p[name + ".weight"],
                            self.p[name + ".bias"], False, 0.0, BN_EPS)

    def relu(self, x):
        return torch.relu(x)

    def add(self, a, b):
        return a + b

    def upsample(self, x, factor):
        return F.interpolate(x, scale_factor=factor, mode="nearest")

    def cat_coords(self, x):
        n, _, h, w = x.shape
        xs = torch.linspace(0, 1, w, device=x.device).expand(h, w)
        ys = torch.linspace(0, 1, h, device=x.device)[:, None].expand(h, w)
        coords = torch.stack([xs, ys])[None].expand(n, 2, h, w)
        return torch.cat([x, coords], dim=1)

    def sigmoid_coords(self, x):
        return torch.sigmoid(x).reshape(x.shape[0], -1, 2)


def _lifter(o, x, fc):
    """The FC lifter on [N, input_size] normalised inputs (``o`` walks
    Linear layers through ``linear``)."""
    n = int(fc.get("num_neurons", 1024))
    y = o.relu(o.bn("batch_norm1", o.linear("w1", x, n)))
    for b in range(int(fc.get("num_blocks", 2))):
        p = f"res_blocks.{b}"
        z = o.relu(o.bn(p + ".batch_norm1", o.linear(p + ".w1", y, n)))
        z = o.relu(o.bn(p + ".batch_norm2", o.linear(p + ".w2", z, n)))
        y = o.add(y, z)
    return o.linear("w2", y, int(fc["output_size"]))


class _SpecLinear(_Spec):
    def linear(self, name, x, cout):
        self.shapes[name + ".weight"] = (cout, x[1])
        self.shapes[name + ".bias"] = (cout,)
        return (x[0], cout)


class _ComputeLinear(_Compute):
    def linear(self, name, x, cout):
        return F.linear(x, self.p[name + ".weight"], self.p[name + ".bias"])


def keypoint_model(cfg):
    """The module ``benchmark/reference/keypoint_<name>.py`` of the keypoint
    family that ``cfg['heatmapModel']['name']`` names (default 'hrnet'; the
    port's aliases).  It holds ``shapes(cfg)``, ``forward(state, x, cfg,
    calibrate=False)``, ``fit_head(state, x, cfg, params)``, ``flops(cfg)``
    and ``shrink(cfg)``."""
    name = str(cfg["heatmapModel"].get("name", "hrnet")).lower()
    name = KEYPOINT_ALIASES.get(name, name)
    module = f"{__package__}.keypoint_{name}"
    if name.isidentifier():
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    looked = [os.path.join(d, f"keypoint_{name}.py")
              for d in importlib.import_module(__package__).__path__]
    raise FileNotFoundError(f"heatmapModel.name {name!r}: no keypoint "
                            f"family; looked for {', '.join(looked)}")


def lifter_shapes(cfg) -> dict:
    spec = _SpecLinear()
    _lifter(spec, (1, int(cfg["FCModel"]["input_size"])), cfg["FCModel"])
    return spec.shapes


def lifter_forward(state, x, cfg, calibrate=False):
    return _lifter(_ComputeLinear(state, calibrate), x, cfg["FCModel"])


# ---------------------------------------------------------------------------
# cuboid fit (float64, host)

def cuboid_template(pred):
    """[N, 32, 3] predictions -> [N, 32, 3] zero-rotation templates with
    the predictions' mean height, length and width."""
    par, chi = list(EDGE_PARENT), list(EDGE_CHILD)
    lengths = np.linalg.norm(pred[:, par] - pred[:, chi], axis=2)  # [N, 12]
    h, l, w = (lengths[:, 0:4].mean(1), lengths[:, 4:8].mean(1),
               lengths[:, 8:12].mean(1))
    zero = np.zeros_like(h)
    xc = np.stack([l, l, l, l, zero, zero, zero, zero], 1) - l[:, None] / 2
    yc = np.stack([zero, h, zero, h, zero, h, zero, h], 1) - h[:, None]
    zc = np.stack([w, w, zero, zero, w, w, zero, zero], 1) - w[:, None] / 2
    corners = np.stack([xc, yc, zc], 2)                           # [N, 8, 3]
    p, c = corners[:, par], corners[:, chi]
    return np.concatenate([corners] + [p + t * (c - p) for t in INTERP],
                          axis=1)


def kabsch_rotation(X, Y):
    """Proper rotations R [N, 3, 3] minimising |R X_i + t - Y_i| over
    point sets X, Y [N, P, 3] (SVD with the reflection fix)."""
    Xc = X - X.mean(1, keepdims=True)
    Yc = Y - Y.mean(1, keepdims=True)
    H = np.einsum("npi,npj->nij", Xc, Yc)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(np.einsum("nji,nkj->nik", Vt, U)))
    D = np.zeros((len(X), 3, 3))
    D[:, 0, 0] = 1
    D[:, 1, 1] = 1
    D[:, 2, 2] = d
    return np.einsum("nji,njk,nlk->nil", Vt, D, U)


def euler_xyz(R):
    """(rx, ry, rz) with R = Rz(rz) Rx(rx) Ry(ry)."""
    rx = np.arcsin(np.clip(R[:, 2, 1], -1.0, 1.0))
    ry = np.arctan2(-R[:, 2, 0], R[:, 2, 2])
    rz = np.arctan2(-R[:, 0, 1], R[:, 1, 1])
    return np.stack([rx, ry, rz], 1)


def wrap(a):
    return np.mod(a + np.pi, 2 * np.pi) - np.pi


# ---------------------------------------------------------------------------
# the whole pipeline

def run(frames, items, keypoint_state, lifter_state, ls_stats, cfg,
        block: int = 64) -> dict:
    """Reference outputs for ``items``: a dict of arrays over crops with
    'frame' [N] (index into ``frames``, uint8 [B, H, W, 3] on the
    reference's device), 'box' [N, 4] and 'K' [N, 3, 3].  Runs in blocks
    of ``block`` crops.  Returns float64 arrays: 'kpts_2d' [N, K, 2]
    screen px, 'kpts_3d' [N, P, 3], 'euler' [N, 3], 'alpha' [N], and
    'crop_w' [N] (each crop's source width in px)."""
    dev = frames.device
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(frames, items, keypoint_state, lifter_state, ls_stats,
                    cfg, block, dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _run(frames, items, keypoint_state, lifter_state, ls_stats, cfg, block,
         dev):
    keypoints = keypoint_model(cfg)
    hm = cfg["heatmapModel"]
    in_w, in_h = hm["input_size"]
    pth = cfg["dataset"]["pth_transform"]
    ls = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
          for k, v in ls_stats.items()}
    out = {"kpts_2d": [], "kpts_3d": [], "crop_w": []}
    n = len(items["frame"])
    with torch.no_grad():
        for a in range(0, n, block):
            sl = slice(a, min(n, a + block))
            inv, crop_w = crop_affines(items["box"][sl], (in_h, in_w))
            x = normalize_crops(sample_crops(frames, items["frame"][sl], inv,
                                             (in_h, in_w)),
                                pth["mean"], pth["std"])
            coords = keypoints.forward(keypoint_state, x, cfg).double()
            inv_t = torch.as_tensor(inv, device=dev)
            local = coords * torch.tensor([in_w, in_h], dtype=torch.float64,
                                          device=dev)
            screen = (torch.einsum("nkj,nij->nki", local, inv_t[:, :, :2])
                      + inv_t[:, None, :, 2])
            flat = screen.float().reshape(len(screen), -1)
            pred = lifter_forward(lifter_state,
                                  (flat - ls["mean_in"]) / ls["std_in"], cfg)
            pred = pred * ls["std_out"] + ls["mean_out"]
            out["kpts_2d"].append(screen.cpu().numpy())
            out["kpts_3d"].append(
                pred.double().reshape(len(pred), -1, 3).cpu().numpy())
            out["crop_w"].append(crop_w)
    res = {k: np.concatenate(v) for k, v in out.items()}
    k3d = res["kpts_3d"]
    R = kabsch_rotation(cuboid_template(k3d), k3d)
    res["euler"] = euler_xyz(R)
    K = np.asarray(items["K"], np.float64)
    x_center = res["kpts_2d"][:, 0, 0] - K[:, 0, 2]
    res["alpha"] = wrap(res["euler"][:, 1]
                        - np.arctan2(-K[:, 0, 0], x_center) - math.pi / 2)
    return res
