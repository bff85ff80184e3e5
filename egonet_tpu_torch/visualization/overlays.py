"""Inference-time visualization (a copy of
``egonet_tpu/visualization/overlays.py``): 2D overlays (boxes, keypoints,
orientation arrows) and 3D scenes (prediction vs ground truth vs detector
input), written as PNGs.  matplotlib (Agg) is imported when a figure is
drawn (``points.pyplot``), so importing this module never needs it.
"""

from __future__ import annotations

import os

import numpy as np

from egonet_tpu_torch.visualization import points as vp


def plot_2d_objects(img, record, color_dict=None, save_path=None):
    """Overlay detected boxes + predicted keypoints on the image.

    img: [H, W, 3] RGB array; record: per-image dict with 'boxes' and
    'kpts_2d_pred' (list of [1, 66] arrays) as produced by the pipeline.
    """
    color_dict = color_dict or {"bbox_2d": "r", "kpts": ["rx", "b"]}
    plt = vp.pyplot()
    fig = plt.figure(figsize=(12, 4))
    ax = fig.add_subplot(111)
    ax.imshow(img)
    for bbox in np.asarray(record.get("boxes", np.zeros((0, 4)))):
        x1, y1, x2, y2 = bbox[:4]
        ax.plot([x1, x2, x2, x1, x1], [y1, y1, y2, y2, y1],
                color_dict["bbox_2d"], lw=1.5)
    for kp in record.get("kpts_2d_pred", []):
        pts = np.asarray(kp).reshape(-1, 2)
        ax.plot(pts[:, 0], pts[:, 1], color_dict["kpts"][0], markersize=3)
        if len(pts) >= 9:
            vp.plot_2d_bbox(ax, pts[1:9], color=color_dict["kpts"][1], lw=1)
    if "arrow" in record:
        for arrow in record["arrow"]:
            ax.plot(arrow[0], arrow[1], "y-", lw=2)
    ax.set_axis_off()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_3d_objects(record, color="r", save_path=None):
    """3D scene: predicted cuboids vs GT vs detector-input boxes.

    The lifter prediction is CENTER-RELATIVE; like the reference (which
    prepends the GT/SMOKE root before plotting, inference_legacy.py:622 +
    points.plot_scene_3dbox adding the root translation), the predicted
    corners are shifted to a known absolute root so they share the scene
    frame with the absolute GT/SMOKE boxes."""
    plt = vp.pyplot()
    fig, ax = vp.new_3d_axis()
    if record.get("kpts_3d_pred") is not None:
        preds = np.asarray(record["kpts_3d_pred"])[:, :8, :]
        if record.get("kpts_3d_abs") is not None:  # SMOKE root
            preds = preds + np.asarray(record["kpts_3d_abs"])[:, 0:1, :]
        elif (record.get("kpts_3d_gt") is not None
              and len(record["kpts_3d_gt"]) == len(preds)):
            preds = preds + np.asarray(record["kpts_3d_gt"])[:, 0:1, :]
        vp.plot_scene_3dbox(ax, list(preds), color=color)
    if record.get("kpts_3d_gt") is not None:
        gts = np.asarray(record["kpts_3d_gt"])
        vp.plot_scene_3dbox(ax, list(gts), color="k")
    if record.get("kpts_3d_before") is not None:
        before = np.asarray(record["kpts_3d_before"])
        vp.plot_scene_3dbox(ax, list(before), color="m")
    if record.get("kpts_3d_SMOKE") is not None:
        # magenta SMOKE boxes (legacy inference_legacy.py:802-809);
        # plot_scene_3dbox handles the center-first 9-point layout itself
        vp.plot_scene_3dbox(
            ax, [np.asarray(s).reshape(-1, 3)
                 for s in record["kpts_3d_SMOKE"]], color="m")
    if "pose_vecs_gt" in record:
        vp.draw_pose_vecs(ax, record["pose_vecs_gt"])
    ax.invert_yaxis()   # camera y points down
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def add_orientation_arrow(record):
    """2D arrows from the projected predicted heading (spec egonet.py:157-179)."""
    pred_kpts = record["kpts_3d_pred"]
    gt_kpts = record["kpts_3d_gt"]
    K = record["K"]
    arrows = np.zeros((len(pred_kpts), 2, 2))
    for i in range(len(pred_kpts)):
        vector_3d = pred_kpts[i][1] - pred_kpts[i][5]
        arrow_3d = np.stack([gt_kpts[i][0], gt_kpts[i][0] + vector_3d],
                            axis=1)
        projected = K @ arrow_3d
        arrows[i][0] = projected[0, :] / projected[2, :]
        arrows[i][1] = projected[1, :] / projected[2, :]
        v = arrows[i][:, 1] - arrows[i][:, 0]
        length = np.linalg.norm(v)
        if length > 50:
            v = v / length * 60
        arrows[i][:, 1] = arrows[i][:, 0] + v
    return arrows


def visualize_lifting_results(data_2d, prediction, target=None,
                              sample_num=None, intrinsics=None,
                              refine=False, save_path=None, rng=None):
    """Lifter-evaluation visualization: sampled predicted cuboids (red)
    vs ground truth (black), optionally with PnP-refined boxes (green).

    File-based twin of the reference's interactive
    ``visualize_lifting_results`` (trainer.py:323-393): data_2d [N, 2K]
    screen keypoints, prediction/target [N, 3K] flattened cuboids whose
    first point is the root/center.
    """
    plt = vp.pyplot()
    rng = rng or np.random.RandomState(0)
    n = len(prediction)
    sample_num = min(sample_num or n, n)
    chosen = rng.choice(n, sample_num, replace=False)
    p3d_pred = np.asarray(prediction)[chosen].reshape(sample_num, -1, 3)
    p3d_gt = (np.asarray(target)[chosen].reshape(sample_num, -1, 3)
              if target is not None else None)

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    vp.plot_scene_3dbox(ax, p3d_pred, color="r")
    if p3d_gt is not None:
        vp.plot_scene_3dbox(ax, p3d_gt, color="k")
    if refine:
        assert intrinsics is not None, "PnP refinement needs intrinsics"
        from egonet_tpu_torch.eval.refinement import refine_instance
        data = np.asarray(data_2d)[chosen].reshape(sample_num, -1, 2)
        for i in range(sample_num):
            absolute = p3d_pred[i].copy()
            absolute[1:] += absolute[:1]       # root-relative -> absolute
            refined = refine_instance(absolute, data[i], intrinsics)
            vp.plot_scene_3dbox(ax, [refined - refined[:1]], color="g")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return ax
