"""Affine crop math (NumPy, host) and the separable crop warp (torch,
device).  Port of ``egonet_tpu/ops/affine.py``.

Host half: the center/scale crop convention of the original preprocessing
(cv2-free: the 2x3 matrix comes from the same 3-point correspondence with
a linear solve), plus the vectorized rot=0 closed form used at inference,
``simple_crop`` and ``save_cropped_patches`` (PNGs by the port's encoder).
Device half, besides the separable warp below: ``warp_affine``, the
bilinear gather warp of one image for any affine, and ``warp_instances``,
a batch of crops from one image.

Device half: every EgoNet crop is an axis-aligned scale+translate, so the
bilinear warp factorizes into a column interpolation and a row
interpolation — two matmuls with hat-weight matrices.  Each instance reads
its source frame (or ROI-packed window) as a VIEW selected by a host index:
no [N, H, W, C] gathered copy of the sources is ever built.
"""

from __future__ import annotations

import numpy as np
import torch

from egonet_tpu_torch.constants import SIZE, crop_scale_divisor, norm_stats


# ---------------------------------------------------------------------------
# Host-side (NumPy) affine-matrix construction
# ---------------------------------------------------------------------------

def _rotate_2d(point, rot_rad: float):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([point[0] * cs - point[1] * sn,
                     point[0] * sn + point[1] * cs], dtype=np.float64)


def _third_point(a, b):
    """Complete a right-angle triangle: rotate (a-b) by 90 deg around b."""
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float64)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine matrix mapping three src points onto three dst points."""
    ones = np.ones((3, 1), dtype=np.float64)
    src_h = np.hstack([src.astype(np.float64), ones])          # [3, 3]
    m_t = np.linalg.solve(src_h, dst.astype(np.float64))        # [3, 2]
    return m_t.T                                                # [2, 3]


def get_affine_transform(center, scale, rot: float, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """Affine matrix for a center/scale/rotation crop.

    center (x, y) source px; scale (sx, sy), the crop covering
    ``scale * SIZE`` source px; rot in degrees; output_size (height,
    width); shift a fraction of scale*SIZE; ``inv`` gives patch -> source.
    Returns a float64 [2, 3] matrix."""
    center = np.asarray(center, dtype=np.float64).reshape(2)
    scale = np.asarray(scale, dtype=np.float64).reshape(2)
    shift = np.asarray(shift, dtype=np.float64).reshape(2)

    scale_tmp = scale * SIZE
    src_w = scale_tmp[0]
    dst_h, dst_w = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate_2d([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float64)

    src = np.zeros((3, 2), dtype=np.float64)
    dst = np.zeros((3, 2), dtype=np.float64)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform_pts(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a [2, 3] affine matrix to [N, 2] points (host-side)."""
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ t[:, :2].T + t[:, 2]


def transform_preds(coords: np.ndarray, center, scale, output_size):
    """Local patch coordinates -> source-image coordinates."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    return affine_transform_pts(np.asarray(coords)[:, :2], trans)


def simple_crop(image: np.ndarray, center, crop_size) -> np.ndarray:
    """Rectangular crop around ``center`` with zero padding outside the
    image (host-side)."""
    if image.ndim != 3:
        raise ValueError(f"expected an [H, W, C] image, got {image.shape}")
    sx = int(center[0] - crop_size[0])
    ex = int(center[0] + crop_size[0])
    sy = int(center[1] - crop_size[1])
    ey = int(center[1] + crop_size[1])
    out = np.zeros((ey - sy, ex - sx, image.shape[2]), dtype=image.dtype)
    nsx, nex = max(-sx, 0), min(image.shape[1], ex) - sx
    nsy, ney = max(-sy, 0), min(image.shape[0], ey) - sy
    osx, oex = max(sx, 0), min(ex, image.shape[1])
    osy, oey = max(sy, 0), min(ey, image.shape[0])
    out[nsy:ney, nsx:nex] = image[osy:oey, osx:oex]
    return out


def generate_xy_map(bbox, resolution, global_size) -> np.ndarray:
    """Normalized [-1, 1] coordinate channels for a crop region (the add_xy
    input).  resolution is (width, height); global_size is (height,
    width)."""
    map_w, map_h = int(resolution[0]), int(resolution[1])
    g_h, g_w = global_size
    xs = np.linspace(2 * bbox[0] / g_w - 1, 2 * bbox[2] / g_w - 1, map_w)
    ys = np.linspace(2 * bbox[1] / g_h - 1, 2 * bbox[3] / g_h - 1, map_h)
    x_map = np.tile(xs, (map_h, 1))[..., None]
    y_map = np.tile(ys[:, None], (1, map_w))[..., None]
    return np.concatenate([x_map, y_map], axis=2)


def resize_bbox(left, top, right, bottom, target_ar: float = 1.0) -> dict:
    """Expand a box (never shrink) to the target aspect ratio (h/w)."""
    width = right - left
    height = bottom - top
    aspect_ratio = height / width
    cx = (left + right) / 2.0
    cy = (top + bottom) / 2.0
    if aspect_ratio > target_ar:
        new_w = height / target_ar
        bbox = [cx - 0.5 * new_w, top, cx + 0.5 * new_w, bottom]
    else:
        new_h = width * target_ar
        bbox = [left, cy - 0.5 * new_h, right, cy + 0.5 * new_h]
    return {
        "bbox": bbox,
        "c": np.array([cx, cy]),
        "s": np.array([(bbox[2] - bbox[0]) / SIZE, (bbox[3] - bbox[1]) / SIZE]),
    }


def enlarge_bbox(left, top, right, bottom, enlarge) -> list:
    w = (right - left) * enlarge[0]
    h = (bottom - top) * enlarge[1]
    cx = (left + right) / 2.0
    cy = (top + bottom) / 2.0
    return [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h]


def modify_bbox(bbox, target_ar: float, enlarge: float = 1.1) -> dict:
    """Enlarge then aspect-ratio-fix a detection box (the inference crop)."""
    l = enlarge_bbox(bbox[0], bbox[1], bbox[2], bbox[3], [enlarge, enlarge])
    return resize_bbox(l[0], l[1], l[2], l[3], target_ar=target_ar)


def cs2bbox(center, size):
    """(center, half-size) -> [x1, y1, x2, y2]."""
    return [center[0] - size[0], center[1] - size[1],
            center[0] + size[0], center[1] + size[1]]


def resize_crop(crop_size, target_ar=None):
    if target_ar is None:
        return crop_size
    width, height = crop_size[0], crop_size[1]
    if height / width > target_ar:
        return [height / target_ar, height]
    return [width, width * target_ar]


def kpts2cs(keypoints: np.ndarray,
            enlarge: float = 1.1,
            method: str = "boundary",
            target_ar=None,
            use_visibility: bool = True):
    """Tight crop center / half-size from instance keypoints [K, 2 or 3].
    Returns (center, crop_half_size, shifted_keypoints, visible_rate)."""
    assert keypoints.shape[1] in (2, 3)
    if keypoints.shape[1] == 2:
        visible = keypoints
        visible_idx = np.arange(len(keypoints))
        vis_rate = 1.0
    elif use_visibility:
        visible_idx = keypoints[:, 2].nonzero()[0]
        visible = keypoints[visible_idx, :2]
        vis_rate = len(visible) / len(keypoints)
    else:
        visible = keypoints[:, :2]
        visible_idx = np.arange(len(keypoints))
        vis_rate = 1.0

    if method == "centroid":
        center = np.ceil(visible.mean(axis=0, keepdims=True))
        dif = np.abs(visible - center).max(axis=0, keepdims=True)
        crop_size = np.ceil(dif * enlarge).squeeze()
        center = center.squeeze()
    elif method == "boundary":
        lt = visible.min(axis=0, keepdims=True)
        rb = visible.max(axis=0, keepdims=True)
        center = ((lt + rb) / 2.0).squeeze()
        crop_size = ((rb - lt) * enlarge / 2.0).squeeze()
    else:
        raise NotImplementedError(method)

    crop_size = resize_crop(crop_size, target_ar)
    x1, y1, _, _ = cs2bbox(center, crop_size)
    origin = np.array([[x1, y1]], dtype=keypoints.dtype)
    new_keypoints = keypoints.copy()
    if keypoints.shape[1] == 2:
        new_keypoints = visible - origin
    else:
        new_keypoints[visible_idx, :2] = visible - origin
    return center, crop_size, new_keypoints, vis_rate


def crop_matrices_for_boxes(boxes: np.ndarray, output_size,
                            target_ar: float, enlarge: float = 1.1):
    """Forward+inverse affine matrices for a stack of detection boxes.

    For the rot=0, shift=0 crops of inference the 3-point construction
    reduces to a uniform scale k = dst_w / (s_x * SIZE) about the box
    center: M = [[k, 0, dw/2 - k*cx], [0, k, dh/2 - k*cy]].

    Returns dict with 'fwd' [N,2,3], 'inv' [N,2,3], 'center' [N,2],
    'scale' [N,2], 'bbox_resize' [N,4]."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    n = len(boxes)
    dst_h, dst_w = float(output_size[0]), float(output_size[1])

    w = (boxes[:, 2] - boxes[:, 0]) * enlarge
    h = (boxes[:, 3] - boxes[:, 1]) * enlarge
    cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
    cy = 0.5 * (boxes[:, 1] + boxes[:, 3])

    ar = h / w
    taller = ar > target_ar
    new_w = np.where(taller, h / target_ar, w)
    new_h = np.where(taller, h, w * target_ar)
    rbs = np.stack([cx - 0.5 * new_w, cy - 0.5 * new_h,
                    cx + 0.5 * new_w, cy + 0.5 * new_h], axis=1)
    scales = np.stack([new_w / SIZE, new_h / SIZE], axis=1)
    centers = np.stack([cx, cy], axis=1)

    k = dst_w / new_w
    fwd = np.zeros((n, 2, 3))
    fwd[:, 0, 0] = k
    fwd[:, 1, 1] = k
    fwd[:, 0, 2] = dst_w * 0.5 - k * cx
    fwd[:, 1, 2] = dst_h * 0.5 - k * cy
    ki = new_w / dst_w
    inv = np.zeros((n, 2, 3))
    inv[:, 0, 0] = ki
    inv[:, 1, 1] = ki
    inv[:, 0, 2] = cx - ki * dst_w * 0.5
    inv[:, 1, 2] = cy - ki * dst_h * 0.5
    return {"fwd": fwd, "inv": inv, "center": centers, "scale": scales,
            "bbox_resize": rbs}


def save_cropped_patches(img_path: str, keypoints, save_dir: str = "./",
                         threshold: float = 0.25, enlarge: float = 1.4,
                         target_ar=None):
    """Crop instance patches around keypoints and save them as PNGs
    (``instance_<i>.png``, by the port's encoder; the JAX package writes
    JPEGs through cv2) — the optional pre-processing workflow.

    keypoints: [N_inst, K, 2 or 3].  Returns (paths, shifted_keypoints
    [N_kept, K, *], boxes)."""
    import os
    from egonet_tpu_torch.data import png
    from egonet_tpu_torch.data.image_store import decode_image
    img = decode_image(img_path)
    os.makedirs(save_dir, exist_ok=True)
    new_paths, all_new_kpts, all_bbox = [], [], []
    for i in range(len(keypoints)):
        center, crop_size, new_kpts, vis_rate = kpts2cs(
            keypoints[i], enlarge, target_ar=target_ar)
        all_bbox.append(list(map(int, cs2bbox(center, crop_size))))
        if vis_rate < threshold:
            continue
        all_new_kpts.append(new_kpts.reshape(1, *new_kpts.shape))
        cropped = simple_crop(img, center, crop_size)
        save_path = os.path.join(save_dir, f"instance_{i:d}.png")
        new_paths.append(save_path)
        with open(save_path, "wb") as f:
            f.write(png.encode(cropped))
    if not new_paths:
        k = keypoints.shape[1] if hasattr(keypoints, "shape") else 0
        return new_paths, np.zeros((0, k, 3)), all_bbox
    return new_paths, np.concatenate(all_new_kpts, axis=0), all_bbox


# ---------------------------------------------------------------------------
# Device-side warp (torch)
# ---------------------------------------------------------------------------

def warp_affine(image: torch.Tensor, inv_mat: torch.Tensor,
                out_hw) -> torch.Tensor:
    """Bilinear affine warp of one image, on its device (a gather warp for
    any affine, not only the axis-aligned crops of the separable warp).

    image: [H, W, C] float tensor; inv_mat: [2, 3] destination pixel ->
    source pixel (``get_affine_transform(..., inv=True)``); out_hw: (height,
    width) of the patch.  Samples outside the image contribute zero
    (cv2.warpAffine's BORDER_CONSTANT(0)).  Returns [out_h, out_w, C] in
    the image's dtype."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    gy, gx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    m = torch.as_tensor(inv_mat, device=dev).to(torch.float32)
    sx = m[0, 0] * gx + m[0, 1] * gy + m[0, 2]
    sy = m[1, 0] * gx + m[1, 1] * gy + m[1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None].to(image.dtype)
    wy = (sy - y0)[..., None].to(image.dtype)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return vals * valid[..., None].to(image.dtype)

    top = gather(y0i, x0i) * (1.0 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1.0 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1.0 - wy) + bot * wy


def warp_instances(image: torch.Tensor, inv_mats: torch.Tensor, out_hw,
                   mean: torch.Tensor | None = None,
                   std: torch.Tensor | None = None) -> torch.Tensor:
    """Warp (and normalize) a batch of instance crops from one image.

    image: [H, W, 3] float in [0, 1]; inv_mats: [N, 2, 3].  Returns [N,
    out_h, out_w, 3], normalized as (crop - mean) / std when mean and std
    are given (ImageNet statistics, say)."""
    crops = torch.stack([warp_affine(image, m, out_hw) for m in inv_mats])
    if mean is not None:
        crops = (crops - mean) / std
    return crops


def _interp_weights(start: torch.Tensor, step: torch.Tensor, n_out: int,
                    n_src: int, dtype=torch.float32,
                    offset: torch.Tensor | None = None) -> torch.Tensor:
    """Batched linear-interpolation weight matrices for 1-D affine
    resamples: output sample i of instance n reads source coordinate
    ``start[n] + step[n]*i``; entry [n, i, v] is max(0, 1 - |coord - v|).
    Out-of-range coordinates get all-zero rows (BORDER_CONSTANT(0)).

    ``offset`` (ROI packing) is an integer-valued translation ADDED to the
    source indices, not subtracted from the coordinates: integer sums
    below 2^24 are exact in fp32, so packed weights are bit-identical to
    the full-canvas ones.  start/step/offset: [N] fp32.  Returns
    [N, n_out, n_src] in ``dtype``."""
    dev = start.device
    coords = (start[:, None]
              + step[:, None] * torch.arange(n_out, dtype=torch.float32,
                                             device=dev)[None])
    src = torch.arange(n_src, dtype=torch.float32, device=dev)[None]
    if offset is not None:
        src = src + offset[:, None]
    d = torch.abs(coords[:, :, None] - src[:, None, :])
    return torch.clamp_min(1.0 - d, 0.0).to(dtype)


def _separable_warp(srcs, ry: torch.Tensor, rx: torch.Tensor,
                    dtype) -> torch.Tensor:
    """out[n] = ry[n] @ srcs[n] @ rx[n]^T per channel.

    srcs: per-instance [h, C, w] views (already in the compute dtype), or
    one gathered [N, h, C, w] tensor; ry [N, out_h, h], rx [N, out_w, w].
    Column pass first: its [h, C, out_w] intermediate is smaller than a
    row-first one on wide frames.  Returns [N, out_h, out_w, C]."""
    n, out_h, h = ry.shape
    out_w = rx.shape[1]
    c = srcs[0].shape[1]
    rx_t = rx.to(dtype).transpose(1, 2)                       # [N, w, out_w]
    if isinstance(srcs, torch.Tensor):
        tmp = torch.bmm(srcs.reshape(n, h * c, srcs.shape[3]), rx_t)
    else:
        tmp = torch.empty((n, h, c, out_w), dtype=dtype, device=ry.device)
        for i, src in enumerate(srcs):
            torch.matmul(src, rx_t[i], out=tmp[i])
    out = torch.bmm(ry.to(dtype), tmp.view(n, h, c * out_w))
    return out.view(n, out_h, c, out_w).permute(0, 1, 3, 2)


def warp_affine_separable(images: torch.Tensor, inv_mats: torch.Tensor,
                          img_idx, out_hw,
                          dtype=torch.float32) -> torch.Tensor:
    """Axis-aligned affine warp as two matmuls per instance.

    images: [B, H, W, C] (uint8 or float, on the device); inv_mats:
    [N, 2, 3] patch->source affines; img_idx: the source frame of each
    instance, either [N] host ints (each frame read as a view, no gather)
    or an [N] int64 tensor on the device (frames gathered: what an exported
    program, whose indices are an input, runs).  Hat weights are built in
    bf16 as the JAX warp does; matmuls run in ``dtype`` with fp32
    accumulation.  Returns [N, out_h, out_w, C] in ``dtype``."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = images.shape[1], images.shape[2]
    mats = inv_mats.to(torch.float32)
    ry = _interp_weights(mats[:, 1, 2], mats[:, 1, 1], out_h, h,
                         dtype=torch.bfloat16)
    rx = _interp_weights(mats[:, 0, 2], mats[:, 0, 0], out_w, w,
                         dtype=torch.bfloat16)
    src = images.to(dtype).permute(0, 1, 3, 2).contiguous()   # [B, H, C, W]
    if isinstance(img_idx, torch.Tensor):
        return _separable_warp(src.index_select(0, img_idx), ry, rx, dtype)
    idx = [int(i) for i in np.asarray(img_idx).reshape(-1)]
    return _separable_warp([src[i] for i in idx], ry, rx, dtype)


def warp_affine_separable_windowed(canvas: torch.Tensor,
                                   inv_mats: torch.Tensor,
                                   offsets: torch.Tensor, win_y, out_hw,
                                   window_h: int, dtype=torch.float32, *,
                                   bounds: torch.Tensor) -> torch.Tensor:
    """Separable warp over a ROI-packed canvas (see ops/packing.py).

    canvas: [Hp, Wp, C]; inv_mats: [N, 2, 3] the ORIGINAL source-frame
    affines; offsets: [N, 2] integer-valued fp32 (x_off, y_off); win_y: [N]
    host ints, each instance's window start row; bounds: [N, 4] (x0, x1,
    y0, y1) valid-read ranges whose outside gets exact zero weights (slots
    hold only the image-clipped footprint).  Weights are bit-identical to
    :func:`warp_affine_separable`'s."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    wp = canvas.shape[1]
    dev = canvas.device
    mats = inv_mats.to(torch.float32)
    offsets = offsets.to(torch.float32)
    bounds = bounds.to(torch.float32)
    ry = _interp_weights(mats[:, 1, 2], mats[:, 1, 1], out_h, window_h,
                         dtype=torch.bfloat16, offset=offsets[:, 1])
    rx = _interp_weights(mats[:, 0, 2], mats[:, 0, 0], out_w, wp,
                         dtype=torch.bfloat16, offset=offsets[:, 0])
    cols = torch.arange(wp, dtype=torch.float32, device=dev)[None]
    rows = torch.arange(window_h, dtype=torch.float32, device=dev)[None]
    col_ok = (cols >= bounds[:, 0:1]) & (cols < bounds[:, 1:2])
    row_ok = (rows >= bounds[:, 2:3]) & (rows < bounds[:, 3:4])
    rx = rx * col_ok[:, None, :].to(rx.dtype)
    ry = ry * row_ok[:, None, :].to(ry.dtype)
    src = canvas.to(dtype).permute(0, 2, 1).contiguous()      # [Hp, C, Wp]
    ys = [int(y) for y in np.asarray(win_y).reshape(-1)]
    return _separable_warp([src[y:y + window_h] for y in ys], ry, rx, dtype)


def xy_maps_from_inv_mats(inv_mats: torch.Tensor, out_hw,
                          img_wh: torch.Tensor) -> torch.Tensor:
    """xy coordinate channels for a batch of crops (the add_xy input):
    normalized [-1, 1] source coordinates linspaced inclusively over each
    crop's box, recovered from the axis-aligned patch->source affines.

    inv_mats: [N, 2, 3]; img_wh: [N, 2] source (width, height).
    Returns [N, out_h, out_w, 2] float32."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    dev = inv_mats.device
    inv_mats = inv_mats.to(torch.float32)
    img_wh = img_wh.to(torch.float32)
    x1 = inv_mats[:, 0, 2]
    x2 = x1 + inv_mats[:, 0, 0] * out_w
    y1 = inv_mats[:, 1, 2]
    y2 = y1 + inv_mats[:, 1, 1] * out_h
    ramp_x = torch.arange(out_w, dtype=torch.float32, device=dev) / (out_w - 1)
    ramp_y = torch.arange(out_h, dtype=torch.float32, device=dev) / (out_h - 1)
    xs = x1[:, None] + (x2 - x1)[:, None] * ramp_x[None]          # [N, W]
    ys = y1[:, None] + (y2 - y1)[:, None] * ramp_y[None]          # [N, H]
    x_map = 2.0 * xs / img_wh[:, 0:1] - 1.0
    y_map = 2.0 * ys / img_wh[:, 1:2] - 1.0
    n = len(inv_mats)
    x_map = x_map[:, None, :, None].expand(n, out_h, out_w, 1)
    y_map = y_map[:, :, None, None].expand(n, out_h, out_w, 1)
    return torch.cat([x_map, y_map], dim=-1)


def normalize_crop_patches(cfgs: dict, patches: torch.Tensor,
                           inv_mats: torch.Tensor | None,
                           img_wh: torch.Tensor | None,
                           out_hw) -> torch.Tensor:
    """Warp output -> model input: round (half to even, as ``jnp.round``),
    scale by ``crop_scale_divisor``, mean/std-normalize, and for add_xy
    models concatenate the xy channels (normalized by stats entries 3:5
    when the config carries 5).

    patches: [N, H, W, 3] warp output on a 0-255 scale.
    Returns [N, H, W, 3 or 5] float32."""
    add_xy = bool(((cfgs or {}).get("heatmapModel") or {}).get("add_xy"))
    mean, std = norm_stats(cfgs)
    if len(mean) != len(std):
        raise ValueError(
            f"pth_transform mean/std length mismatch: {len(mean)} vs "
            f"{len(std)}")
    if len(mean) not in (3, 5) or (len(mean) == 5 and not add_xy):
        raise ValueError(
            f"pth_transform stats have {len(mean)} entries; expected 3, "
            "or 5 with heatmapModel.add_xy enabled")
    dev = patches.device
    mean = torch.as_tensor(mean, device=dev)
    std = torch.as_tensor(std, device=dev)
    div = crop_scale_divisor(cfgs)
    crops = (torch.round(patches.to(torch.float32))
             / div - mean[:3]) / std[:3]
    if add_xy:
        if inv_mats is None or img_wh is None:
            raise ValueError("add_xy models need inv_mats and img_wh")
        xy = xy_maps_from_inv_mats(inv_mats, out_hw, img_wh)
        if len(mean) == 5:
            xy = (xy - mean[3:]) / std[3:]
        crops = torch.cat([crops, xy.to(crops.dtype)], dim=-1)
    return crops


def batched_affine_transform(pts: torch.Tensor,
                             mats: torch.Tensor) -> torch.Tensor:
    """Apply per-instance [2,3] affines to [N, K, 2] points, in full fp32
    (TF32 is switched off by the facade)."""
    pts = pts.to(torch.float32)
    mats = mats.to(torch.float32)
    rot = torch.einsum("nkj,nij->nki", pts, mats[:, :, :2])
    return rot + mats[:, None, :, 2]
