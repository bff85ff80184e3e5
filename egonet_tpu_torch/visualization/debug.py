"""Training debug grids (port of ``egonet_tpu/visualization/debug.py``):
crops with predicted / GT joints, and per-instance rows of heatmaps, from
NHWC numpy batches, written as PNG by ``data/png.encode`` (no cv2).

The heatmap grids equal the JAX package's arrays: the crop thumbnail is
cv2's ``INTER_LINEAR`` resize (11-bit fixed-point weights; equal to cv2's
at the integer factors the configs use, input / heatmap = 4) and the
colouring is cv2's ``COLORMAP_JET`` table, both restated here in NumPy.
The joint discs are drawn here and need not match cv2's pixels.
"""

from __future__ import annotations

import math
import os

import numpy as np

from egonet_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD


def _denormalize(crops: np.ndarray, mean=None, std=None,
                 scale: float = 255.0) -> np.ndarray:
    """Normalized crops -> uint8 RGB (channels beyond the first 3, the
    add_xy maps, are dropped).  ``scale`` is the divisor the pipeline
    applied before normalizing (``constants.crop_scale_divisor``)."""
    crops = np.asarray(crops)[..., :3]
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    img = crops * std[:3] + mean[:3]
    return np.clip(img * scale, 0, 255).astype(np.uint8)


def _jet_lut() -> np.ndarray:
    """cv2's COLORMAP_JET as a [256, 3] RGB table: channel k (r, g, b at
    k = 3, 2, 1) is clip(1.5 - |4 i/255 - k|, 0, 1) * 255, rounded half to
    even (reckoned in halves, so the ties are exact), except one tie that
    cv2's float table rounds down."""
    i = np.arange(256)[:, None]
    k = np.array([3, 2, 1])[None, :]
    halves = np.clip(765 - 2 * np.abs(4 * i - 255 * k), 0, 510)
    lut = np.round(halves / 2.0).astype(np.uint8)
    lut[159, 2] = 1
    return lut


_JET = _jet_lut()


def _resize_coeffs(n_src: int, n_out: int):
    """Per output sample: left source index and the two 11-bit weights of
    cv2's linear resize (clamped at the borders)."""
    scale = n_src / n_out
    fx = (np.arange(n_out) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    lo = sx < 0
    fx[lo], sx[lo] = 0.0, 0
    hi = sx >= n_src - 1
    fx[hi], sx[hi] = 0.0, n_src - 1
    c0 = np.round((1.0 - fx) * 2048).astype(np.int64)
    return sx, np.minimum(sx + 1, n_src - 1), c0, 2048 - c0


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 [H, W, C] -> [out_h, out_w, C] as ``cv2.resize`` with
    ``INTER_LINEAR``: integer weights summing to 2048 per axis, the two
    passes' product rounded by (v + 2^21) >> 22."""
    a = img.astype(np.int64)
    x0, x1, cx0, cx1 = _resize_coeffs(img.shape[1], out_w)
    y0, y1, cy0, cy1 = _resize_coeffs(img.shape[0], out_h)
    rows = a[:, x0] * cx0[None, :, None] + a[:, x1] * cx1[None, :, None]
    v = rows[y0] * cy0[:, None, None] + rows[y1] * cy1[:, None, None]
    return np.clip((v + (1 << 21)) >> 22, 0, 255).astype(np.uint8)


def _disc(img, x, y, radius, color):
    h, w = img.shape[:2]
    ys, xs = np.ogrid[max(0, y - radius):min(h, y + radius + 1),
                      max(0, x - radius):min(w, x + radius + 1)]
    inside = (xs - x) ** 2 + (ys - y) ** 2 <= radius * radius
    img[ys.min():ys.max() + 1, xs.min():xs.max() + 1][inside] = color


def _write(path: str, grid: np.ndarray) -> str:
    from egonet_tpu_torch.data import png
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png.encode(grid))
    return path


def batch_image_with_joints(crops, joints, joints_vis, nrow: int = 8,
                            radius: int = 2, norm_stats=None,
                            scale: float = 255.0) -> np.ndarray:
    """Grid of crops with joint discs.  crops: [N, H, W, 3+] normalized;
    joints: [N, K, 2] crop pixels.  Returns the RGB grid."""
    imgs = _denormalize(np.asarray(crops), *(norm_stats or (None, None)),
                        scale=scale)
    n, h, w = imgs.shape[:3]
    ncol = min(nrow, n)
    nr = math.ceil(n / ncol)
    grid = np.zeros((nr * h, ncol * w, 3), np.uint8)
    for i in range(n):
        img = imgs[i].copy()
        for k in range(joints.shape[1]):
            if joints_vis is None or joints_vis[i][k] > 0:
                x, y = int(joints[i, k, 0]), int(joints[i, k, 1])
                if 0 <= x < w and 0 <= y < h:
                    _disc(img, x, y, radius, (0, 255, 0))
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    return grid


def batch_heatmaps(crops, heatmaps, norm_stats=None,
                   scale: float = 255.0) -> np.ndarray:
    """Per-instance row: [crop thumbnail | each joint's heatmap in JET,
    blended 0.7 / 0.3 with the thumbnail].  Returns the RGB grid."""
    imgs = _denormalize(np.asarray(crops), *(norm_stats or (None, None)),
                        scale=scale)
    hms = np.asarray(heatmaps)
    n, k, hh, hw = hms.shape
    rows = []
    for i in range(n):
        small = resize_linear(imgs[i], hw, hh)
        cells = [small]
        for j in range(k):
            hm = np.clip(hms[i, j], 0, None)
            maxv = hm.max() if hm.max() > 0 else 1.0
            colored = _JET[(hm / maxv * 255).astype(np.uint8)]
            cells.append((colored * 0.7 + small * 0.3).astype(np.uint8))
        rows.append(np.concatenate(cells, axis=1))
    return np.concatenate(rows, axis=0)


def save_batch_image_with_joints(crops, joints, joints_vis, path,
                                 nrow: int = 8, radius: int = 2,
                                 norm_stats=None, scale: float = 255.0):
    return _write(path, batch_image_with_joints(
        crops, joints, joints_vis, nrow, radius, norm_stats, scale))


def save_batch_heatmaps(crops, heatmaps, path, norm_stats=None,
                        scale: float = 255.0):
    return _write(path, batch_heatmaps(crops, heatmaps, norm_stats, scale))


def save_debug_images(cfgs, crops, joints_gt, joints_pred, targets,
                      outputs, prefix):
    """The grids ``training_settings.debug`` asks for, as
    ``<prefix>_{pred,gt,hm_gt,hm_pred}.png``; returns the paths."""
    debug = cfgs.get("training_settings", {}).get("debug", {})
    if not debug.get("save", False):
        return []
    from egonet_tpu_torch.constants import crop_scale_divisor, norm_stats
    stats = norm_stats(cfgs)
    scale = crop_scale_divisor(cfgs)
    written = []
    if debug.get("save_images_kpts", False) and joints_pred is not None:
        written.append(save_batch_image_with_joints(
            crops, joints_pred, None, f"{prefix}_pred.png",
            norm_stats=stats, scale=scale))
        if joints_gt is not None:
            written.append(save_batch_image_with_joints(
                crops, joints_gt[..., :2],
                joints_gt[..., 2] if joints_gt.shape[-1] > 2 else None,
                f"{prefix}_gt.png", norm_stats=stats, scale=scale))
    if debug.get("save_hms_gt", False) and targets is not None:
        written.append(save_batch_heatmaps(crops, targets,
                                           f"{prefix}_hm_gt.png",
                                           norm_stats=stats, scale=scale))
    if debug.get("save_hms_pred", False) and outputs is not None:
        written.append(save_batch_heatmaps(crops, outputs,
                                           f"{prefix}_hm_pred.png",
                                           norm_stats=stats, scale=scale))
    return written
