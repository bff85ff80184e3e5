"""Training losses (port of ``egonet_tpu/train/losses.py``): the composite
keypoint loss (heatmap MSE + normalized coordinate L1 + self-supervised
cross-ratio) and the 1D regression losses of the lifter.

Every loss takes a per-instance validity mask, so the padding slots of a
fixed-shape batch contribute nothing; the cross-ratio term is one gather
and a batched expression over the 12 cuboid edges.  The losses run in the
dtype and on the device of their inputs.
"""

from __future__ import annotations

import math

import torch

from egonet_tpu_torch.constants import CR_INDICES, TARGET_CROSS_RATIO
from egonet_tpu_torch.parallel import mesh

_CR_IDX = torch.as_tensor(CR_INDICES, dtype=torch.long)     # [12, 4]


def masked_mean(values: torch.Tensor, mask: torch.Tensor | None):
    """Mean over valid entries; ``mask`` broadcasts against ``values``.  In
    a data-parallel run the sum is this rank's and the count the global
    batch's: the rank's share of the global mean (the shares sum to it)."""
    if mask is None:
        if not mesh.active():
            return values.mean()
        mask = torch.ones((), dtype=values.dtype, device=values.device)
    mask = torch.broadcast_to(mask.to(values.dtype), values.shape)
    return (values * mask).sum() / torch.clamp(
        mesh.all_reduce_count(mask.sum()), min=1.0)


def heatmap_mse_loss(pred, target, mask=None, target_weight=None):
    """0.5 x MSE over heatmaps. pred / target: [N, K, H, W]; mask: [N]."""
    se = 0.5 * (pred - target) ** 2
    if target_weight is not None:
        se = se * target_weight[..., None, None]
    m = None if mask is None else mask[:, None, None, None]
    return masked_mean(se, m)


def coordinate_l1_loss(pred_coords, gt_coords, input_size, mask=None):
    """L1 between [0, 1]-normalized predicted and gt crop coordinates.

    pred_coords: [N, K, 2] in [0, 1]; gt_coords: [N, K, 2] in input
    pixels; input_size: (width, height)."""
    size = torch.tensor([float(input_size[0]), float(input_size[1])],
                        dtype=gt_coords.dtype, device=gt_coords.device)
    err = (pred_coords - gt_coords / size).abs()
    m = None if mask is None else mask[:, None, None]
    return masked_mean(err, m)


def smooth_l1(x, beta: float = 1.0):
    absx = x.abs()
    return torch.where(absx < beta, 0.5 * x * x / beta, absx - 0.5 * beta)


def cross_ratio_loss(pred_coords, target_cr: float = TARGET_CROSS_RATIO,
                     distance_threshold: float = 0.15, mask=None):
    """Self-supervised cross-ratio consistency over the 12 cuboid edges.

    pred_coords: [N, 33, 2] normalized coordinates.  Edges whose 4
    collinear points are closer than ``distance_threshold``
    (fore-shortened; unstable gradients) are masked out, as is the
    padding mask."""
    pts = pred_coords[:, _CR_IDX.to(pred_coords.device)]     # [N, 12, 4, 2]
    # clamped denominator: degenerate (masked) edges stay finite, so no
    # NaN reaches the gradient through the unselected branch
    ac = pts[..., 2, :] - pts[..., 0, :]
    bd = pts[..., 3, :] - pts[..., 1, :]
    bc = pts[..., 2, :] - pts[..., 1, :]
    ad = pts[..., 3, :] - pts[..., 0, :]
    num = (ac * ac).sum(-1) * (bd * bd).sum(-1)
    den = torch.clamp((bc * bc).sum(-1) * (ad * ad).sum(-1), min=1e-12)
    cr = (num / den) / (target_cr ** 2)                     # [N, 12]
    per_edge = smooth_l1(cr - 1.0)

    # fore-shortening mask: it gates, it does not train
    with torch.no_grad():
        d = pts[..., :, None, :] - pts[..., None, :, :]     # [N, 12, 4, 4, 2]
        dist = torch.sqrt((d * d).sum(-1) + 1e-12)
        eye = torch.eye(4, dtype=torch.bool, device=pts.device)
        dist = dist.masked_fill(eye, math.inf)
        edge_ok = (dist.amin(dim=(-1, -2))
                   > distance_threshold).to(pred_coords.dtype)
        if mask is not None:
            edge_ok = edge_ok * mask[:, None].to(edge_ok.dtype)
    return (per_edge * edge_ok).sum() / torch.clamp(
        mesh.all_reduce_count(edge_ok.sum()), min=1.0)


class CompositeLossConfig:
    """Static configuration of the composite keypoint loss."""

    def __init__(self, cfgs: dict):
        hm = cfgs["heatmapModel"]
        spec = hm.get("loss_spec_list", ["mse", "l1", "None"])
        weights = hm.get("loss_weight_list", [1.0, 0.1, "None"])
        self.use_hm = spec[0] != "None"
        self.w_hm = float(weights[0]) if self.use_hm else 0.0
        self.use_coor = spec[1] != "None"
        self.w_coor = float(weights[1]) if self.use_coor else 0.0
        self.use_cr = (spec[2] != "None" and weights[2] != "None"
                       and weights[2] is not None)
        self.w_cr = float(weights[2]) if self.use_cr else 0.0
        self.cr_threshold = float(hm.get("cr_loss_threshold", 0.15))
        self.input_size = tuple(hm["input_size"])
        self.target_cr = TARGET_CROSS_RATIO


def composite_loss(outputs, targets, joints_gt, cfg: CompositeLossConfig,
                   mask=None, target_weight=None, apply_cr: bool = False,
                   sup_mask=None):
    """The composite loss of the 'coordinates' head.

    outputs: (heatmaps [N, K, H, W], coords [N, K, 2]); targets: Gaussian
    heatmaps [N, K, H, W]; joints_gt: [N, K, 2] crop pixels.  ``mask``
    gates padding for every term; ``sup_mask`` (default ``mask``) also
    gates the supervised terms, so self-supervised (unlabeled) instances
    train only the cross-ratio prior.  Returns (total, {component: value})."""
    heatmaps_pred, coords_pred = outputs
    if sup_mask is None:
        sup_mask = mask
    comps = {}
    total = 0.0
    if cfg.use_hm:
        comps["hm"] = heatmap_mse_loss(heatmaps_pred, targets, sup_mask,
                                       target_weight)
        total = total + cfg.w_hm * comps["hm"]
    if cfg.use_coor:
        comps["coor"] = coordinate_l1_loss(coords_pred, joints_gt,
                                           cfg.input_size, sup_mask)
        total = total + cfg.w_coor * comps["coor"]
    if cfg.use_cr and apply_cr:
        comps["cr"] = cross_ratio_loss(coords_pred, cfg.target_cr,
                                       cfg.cr_threshold, mask)
        total = total + cfg.w_cr * comps["cr"]
    return total, comps


def mse_loss_1d(pred, target, mask=None):
    m = None if mask is None else mask[:, None]
    return masked_mean((pred - target) ** 2, m)


def smooth_l1_loss_1d(pred, target, mask=None):
    m = None if mask is None else mask[:, None]
    return masked_mean(smooth_l1(pred - target), m)


# ---------------------------------------------------------------------------
# Losses the reference marks deprecated, unused by any shipped config, kept
# so that nothing of the loss registry is missing.  Each takes the padding
# mask; with mask=None they reduce like the reference.

def decoupled_smooth_l1_loss(pred, target, mask=None):
    """Translation / rotation-balanced smooth-L1: mean smooth-L1 over the
    first 3 output dims plus the mean over the rest."""
    m = None if mask is None else mask[:, None]
    loss_center = masked_mean(smooth_l1(pred[:, :3] - target[:, :3]), m)
    loss_else = masked_mean(smooth_l1(pred[:, 3:] - target[:, 3:]), m)
    return loss_center + loss_else


def joints_ohkm_mse_loss(pred, target, target_weight=None, topk: int = 8,
                         mask=None):
    """Online hard-keypoint-mining MSE: per sample, only the ``topk``
    hardest joints (largest 0.5 x per-joint pixel-mean MSE) contribute.

    pred / target: [N, K, H, W]; target_weight: [N, K] (multiplied into
    both maps before the MSE)."""
    n, k = pred.shape[:2]
    diff = pred - target
    if target_weight is not None:
        diff = diff * target_weight[..., None, None]
    per_joint = 0.5 * (diff * diff).reshape(n, k, -1).mean(dim=2)   # [N, K]
    top_vals = per_joint.topk(topk, dim=1).values                  # [N, topk]
    per_sample = top_vals.sum(dim=1) / topk
    return masked_mean(per_sample, mask)


def wing_loss(heatmaps, joints_gt, width: float = 5.0,
              curvature: float = 0.5, image_size=(384, 288), mask=None):
    """Wing loss on soft-argmax coordinates.

    heatmaps: [N, K, H, W]; joints_gt: [N, K, 2] in the reference's pixel
    units (divided by (image_size[1], image_size[0])).  Log region inside
    ``width``, linear minus the continuity constant C outside."""
    from egonet_tpu_torch.ops.keypoints import soft_argmax

    pred, _ = soft_argmax(heatmaps)
    scale = torch.tensor([image_size[1], image_size[0]],
                         dtype=heatmaps.dtype, device=heatmaps.device)
    diff_abs = (joints_gt / scale - pred / scale).abs()
    c = width - width * math.log(1.0 + width / curvature)
    per = torch.where(diff_abs < width,
                      width * torch.log1p(diff_abs / curvature),
                      diff_abs - c)
    m = None if mask is None else mask[:, None, None]
    return masked_mean(per, m)
