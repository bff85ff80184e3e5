"""Keypoint decoding (soft / hard argmax), Gaussian heatmap targets and
the cross-ratio primitive, as batched torch ops (port of
``egonet_tpu/ops/keypoints.py``).  Each works in the dtype and on the
device of its input."""

from __future__ import annotations

import torch


def _marginals(probs, unit=False):
    """Expected (x, y) of [N, K, H, W] weights: the column / row marginals
    times the pixel index (over W and H with ``unit``)."""
    n, k, h, w = probs.shape
    xs = torch.arange(w, dtype=probs.dtype, device=probs.device)
    ys = torch.arange(h, dtype=probs.dtype, device=probs.device)
    if unit:
        xs, ys = xs / w, ys / h
    x = (probs.sum(dim=2) * xs).sum(dim=2)          # marginal over rows
    y = (probs.sum(dim=3) * ys).sum(dim=2)          # marginal over cols
    return torch.stack([x, y], dim=2)


def soft_argmax_coords(heatmaps: torch.Tensor, unit: bool = False):
    """Softmax-weighted expected (x, y) per heatmap, in heatmap pixels, or
    with ``unit`` in the crop's unit square (E[column] / W, E[row] / H:
    the facade's readout of a 'heatmap' head, which a crop of the input
    size maps back to input px = heatmap index x input / heatmap size).

    heatmaps: [N, K, H, W].  Returns coords [N, K, 2]."""
    n, k, h, w = heatmaps.shape
    probs = torch.softmax(heatmaps.reshape(n, k, h * w), dim=2)
    return _marginals(probs.reshape(n, k, h, w), unit)


def soft_argmax(heatmaps: torch.Tensor):
    """Softmax-weighted expected (x, y) per heatmap, in heatmap pixels,
    and each heatmap's peak value.

    heatmaps: [N, K, H, W].  Returns (coords [N, K, 2], maxvals [N, K, 1])."""
    n, k = heatmaps.shape[:2]
    maxvals = heatmaps.reshape(n, k, -1).amax(dim=2, keepdim=True)
    return soft_argmax_coords(heatmaps), maxvals


def soft_argmax_sumnorm(heatmaps: torch.Tensor):
    """Sum-normalized (not softmax) soft argmax over the unclipped
    activations (the evaluation-time decoder, whose negative clip is dead
    code in the reference, so none is applied); predictions whose max
    activation is <= 0 are zeroed."""
    n, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, k, h * w)
    maxvals = flat.amax(dim=2, keepdim=True)
    probs = (flat / flat.sum(dim=2, keepdim=True)).reshape(n, k, h, w)
    coords = _marginals(probs)
    return coords * (maxvals > 0.0).to(coords.dtype), maxvals


def hard_argmax(heatmaps: torch.Tensor):
    """Argmax (x, y) per heatmap with the (maxval > 0) validity mask."""
    n, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, k, h * w)
    idx = flat.argmax(dim=2)
    maxvals = flat.amax(dim=2, keepdim=True)
    x = (idx % w).to(heatmaps.dtype)
    y = torch.floor(idx.to(heatmaps.dtype) / w)
    coords = torch.stack([x, y], dim=2)
    return coords * (maxvals > 0.0).to(coords.dtype), maxvals


def gaussian_targets(joints: torch.Tensor, joints_vis: torch.Tensor,
                     heatmap_hw, input_hw, sigma: float):
    """One Gaussian dot per joint, vectorized over (instance, joint).

    joints: [N, K, 2] crop-frame (input resolution) coordinates;
    joints_vis: [N, K] in {0, 1}.  Returns (target [N, K, Hh, Wh],
    target_weight [N, K]).  The dot's center is quantized to the heatmap
    grid (int(x / stride + 0.5), truncating toward zero), the Gaussian
    peaks at 1 and is cut beyond 3 sigma, and joints whose 3-sigma box
    misses the heatmap get weight 0."""
    hh, hw = int(heatmap_hw[0]), int(heatmap_hw[1])
    ih, iw = float(input_hw[0]), float(input_hw[1])
    stride_x = iw / hw
    stride_y = ih / hh
    tmp_size = sigma * 3

    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5)
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5)
    ul_x, ul_y = mu_x - tmp_size, mu_y - tmp_size
    br_x, br_y = mu_x + tmp_size + 1, mu_y + tmp_size + 1
    in_bounds = ~((ul_x >= hw) | (ul_y >= hh) | (br_x < 0) | (br_y < 0))
    weight = joints_vis * in_bounds.to(joints.dtype)

    xs = torch.arange(hw, dtype=joints.dtype, device=joints.device)
    ys = torch.arange(hh, dtype=joints.dtype, device=joints.device)
    dx2 = (xs[None, None, :] - mu_x[..., None]) ** 2          # [N, K, Wh]
    dy2 = (ys[None, None, :] - mu_y[..., None]) ** 2          # [N, K, Hh]
    gx = torch.exp(-dx2 / (2.0 * sigma ** 2))
    gy = torch.exp(-dy2 / (2.0 * sigma ** 2))
    gx = torch.where(dx2 <= tmp_size ** 2, gx, torch.zeros_like(gx))
    gy = torch.where(dy2 <= tmp_size ** 2, gy, torch.zeros_like(gy))
    target = gy[..., :, None] * gx[..., None, :]               # [N, K, Hh, Wh]
    return target * weight[..., None, None], weight


def cross_ratio_sq(points: torch.Tensor) -> torch.Tensor:
    """Squared cross-ratio of 4 ordered 2D points via inner products.

    points: [..., 4, 2].  CR^2 = (|AC|^2 |BD|^2) / (|BC|^2 |AD|^2)."""
    ac = points[..., 2, :] - points[..., 0, :]
    bd = points[..., 3, :] - points[..., 1, :]
    bc = points[..., 2, :] - points[..., 1, :]
    ad = points[..., 3, :] - points[..., 0, :]

    def sq(v):
        return (v * v).sum(dim=-1)

    return (sq(ac) * sq(bd)) / (sq(bc) * sq(ad))
