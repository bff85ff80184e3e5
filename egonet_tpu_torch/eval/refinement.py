"""PnP-based pose refinement (a copy of ``egonet_tpu/eval/refinement.py``):
the legacy inference extras that re-fit the predicted cuboid to the
observed 2D keypoints with iterative PnP, optionally re-using the
detector's box size.  They run on the host (OpenCV ``solvePnP``, imported
by ``common/transformation.pnp_refine``) over each instance's small point
sets, after the device pipeline.
"""

from __future__ import annotations

import numpy as np

from egonet_tpu_torch.common.transformation import pnp_refine


def refine_instance(kpts_3d: np.ndarray,
                    kpts_2d: np.ndarray,
                    K: np.ndarray,
                    dist_coeffs=None) -> np.ndarray:
    """Refine one instance: align the predicted (center-relative) cuboid to
    its observed screen keypoints via PnP.  Returns refined [N, 3] camera
    coordinates (or the input when PnP fails)."""
    pred = np.ascontiguousarray(kpts_3d, dtype=np.float64)
    obs = np.ascontiguousarray(kpts_2d.reshape(-1, 2), dtype=np.float64)
    n = min(len(pred), len(obs))
    pred_n = pred[:n]
    refined = pnp_refine(pred_n, obs[:n], np.asarray(K, np.float64),
                         dist_coeffs)
    # pnp_refine returns its [N, 3] input object on solvePnP failure and a
    # transposed [3, N] solution on success; the identity check must be
    # against the SAME slice object that was passed in
    if refined is pred_n:
        return kpts_3d
    return np.asarray(refined).T


def refine_with_perfect_size(kpts_3d_pred, kpts_2d_pred, K, gt_dims):
    """Re-scale the predicted cuboid to ground-truth dimensions before PnP
    (the 'perfect size' oracle variant of the legacy tool)."""
    pred = np.asarray(kpts_3d_pred, dtype=np.float64)
    # estimate current dims from the edge structure (first 8 = corners)
    corners = pred[:8]
    scale = np.asarray(gt_dims, dtype=np.float64)
    cur = np.array([
        corners[:, 0].max() - corners[:, 0].min(),
        corners[:, 1].max() - corners[:, 1].min(),
        corners[:, 2].max() - corners[:, 2].min(),
    ])
    cur[cur == 0] = 1.0
    centered = pred - pred.mean(axis=0, keepdims=True)
    resized = centered * (scale / cur).reshape(1, 3) \
        + pred.mean(axis=0, keepdims=True)
    return refine_instance(resized, kpts_2d_pred, K)


def refine_record(record: dict, use_gt_size: bool = False) -> dict:
    """Apply PnP refinement to every instance of a per-image record
    (in-place; adds 'kpts_3d_refined')."""
    if "kpts_3d_pred" not in record or "K" not in record:
        return record
    K = np.asarray(record["K"])
    refined = []
    for i, kpts_3d in enumerate(record["kpts_3d_pred"]):
        kpts_2d = np.asarray(record["kpts_2d_pred"][i]).reshape(-1, 2)
        # the prediction is center-relative (32 pts); observations include
        # the center keypoint first -> drop it for correspondence
        obs = kpts_2d[1:1 + len(kpts_3d)]
        refined.append(refine_instance(np.asarray(kpts_3d), obs, K))
    record["kpts_3d_refined"] = np.stack(refined) if refined else None
    return record
