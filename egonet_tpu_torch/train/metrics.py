"""Validation metrics and the Evaluator registry (port of
``egonet_tpu/train/metrics.py``, NumPy on the host): PCK thresholds,
keypoint distance in the source image plane, angle error, 3D rotation /
translation errors through rigid alignment, and the Evaluator that
dispatches metric class names from config strings through an explicit
registry.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from egonet_tpu_torch.common import transformation as ltr
from egonet_tpu_torch.ops import affine

PCK_THRES = np.array([0.1, 0.2, 0.3])


def get_distance(gt: np.ndarray, pred: np.ndarray) -> list:
    """Per-joint 2D pixel distances, honoring a visibility column."""
    if gt.shape[1] == 2:
        sqerr = ((gt - pred) ** 2).sum(axis=1)
        return list(np.sqrt(sqerr))
    if gt.shape[1] == 3:
        sqerr = ((gt[:, :2] - pred) ** 2).sum(axis=1)
        idx = np.nonzero(gt[:, 2])[0]
        return list(np.sqrt(sqerr[idx]))
    raise ValueError("Array shape not supported.")


def get_pck(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    distance = np.array(get_distance(gt, pred))
    denominator = (gt[:, 1].max() - gt[:, 1].min()) / 3.0
    return np.array([(distance < t * denominator).sum()
                     for t in PCK_THRES], dtype=np.float64)


def get_angle_error(pred: np.ndarray, angles_gt: np.ndarray):
    """Mean |angle error| in degrees with 2pi wrapping."""
    angles_pred = np.arctan2(pred[:, 1], pred[:, 0])
    dif = np.abs(angles_gt - angles_pred) * 180 / np.pi
    dif[dif > 180] = 360 - dif[dif > 180]
    return dif.sum() / len(pred), len(pred)


def distance_in_source_image(coords, meta, input_size=(256, 256)):
    """Transform predicted local coords back to the source image and measure
    pixel error + PCK against the original joints.

    coords: [N, K, 2] normalized in [0, 1] (the 'coordinates' head output).
    meta: dict with 'center' [N,2], 'scale' [N,2], 'original_joints'
    [N, K, 2 or 3], optional 'rotation' [N].
    """
    width, height = input_size
    pred = np.asarray(coords) * np.array([width, height]).reshape(1, 1, 2)
    centers, scales = meta["center"], meta["scale"]
    rots = meta.get("rotation", [0.0] * len(centers))
    joints_orig = meta["original_joints"]
    distance_list = []
    pck = np.zeros(len(PCK_THRES))
    src_coords = []
    for i in range(len(pred)):
        trans_inv = affine.get_affine_transform(
            centers[i], scales[i], rots[i], (height, width), inv=True)
        src = affine.affine_transform_pts(pred[i], trans_inv)
        src_coords.append(src[None])
        distance_list += get_distance(joints_orig[i], src)
        pck += get_pck(src, joints_orig[i])
    cnt = len(distance_list)
    return (sum(distance_list) / cnt, cnt,
            {"src_coord": np.concatenate(src_coords),
             "correct_cnt": pck, "PCK_batch": pck / cnt})


def pixel_accuracy(heatmaps, meta, input_size=(256.0, 256.0),
                   arg_max="hard"):
    """Heatmap-decoded pixel distance in the source image (the reference's
    deprecated ``accuracy_pixel``): decode with hard or soft
    (sum-normalized) argmax, scale to input pixels by
    ``input_size[0] / W_heatmap``, inverse-affine each instance back to the
    source image and average the per-joint distances against
    ``meta['original_joints']``.

    heatmaps: [N, K, H, W] ndarray.  Returns (avg_distance, count,
    {'src_coord', 'joints_pred', 'max_vals'})."""
    import torch
    from egonet_tpu_torch.ops import keypoints as kp

    hm = torch.from_numpy(np.asarray(heatmaps, np.float32))
    if arg_max == "hard":
        pred, max_vals = kp.hard_argmax(hm)
    elif arg_max == "soft":
        pred, max_vals = kp.soft_argmax_sumnorm(hm)
    else:
        raise ValueError(f"unknown arg_max {arg_max!r}")
    pred = pred.numpy() * (float(input_size[0]) / heatmaps.shape[3])
    centers, scales = meta["center"], meta["scale"]
    rots = meta.get("rotation", [0.0] * len(centers))
    joints_orig = meta["original_joints"]
    distance_list = []
    src_coords = []
    for i in range(len(pred)):
        trans_inv = affine.get_affine_transform(
            centers[i], scales[i], rots[i],
            (float(input_size[0]), float(input_size[1])), inv=True)
        src = affine.affine_transform_pts(pred[i], trans_inv)
        src_coords.append(src[None])
        distance_list += get_distance(joints_orig[i], src)
    cnt = len(distance_list)
    return (sum(distance_list) / cnt, cnt,
            {"src_coord": np.concatenate(src_coords),
             "joints_pred": pred,
             "max_vals": max_vals.numpy()})


def rotation_errors_euler(prediction, ground_truth):
    """Per-instance |euler('xyz')| of the residual rotation after rigid
    alignment, degrees."""
    n = len(prediction)
    prediction = prediction.reshape(n, -1, 3)
    ground_truth = ground_truth.reshape(n, -1, 3)
    out = np.zeros((n, 3))
    for i in range(n):
        R, _ = ltr.compute_rigid_transform(prediction[i].T,
                                           ground_truth[i].T)
        out[i] = np.abs(Rotation.from_matrix(R).as_euler("xyz", degrees=True))
    return out


def joint_distances_3d(prediction, ground_truth, style="direct"):
    n = len(prediction)
    prediction = prediction.reshape(n, -1, 3).copy()
    ground_truth = ground_truth.reshape(n, -1, 3)
    if style == "procrustes":
        k = prediction.shape[1]
        for j in range(n):
            _, _, T, b, c = ltr.compute_similarity_transform(
                ground_truth[j], prediction[j], compute_optimal_scale=True)
            prediction[j] = ((b * prediction[j].dot(T)) + c).reshape(k, 3)
    return np.sqrt(((ground_truth - prediction) ** 2).sum(axis=2))


class _Accumulator:
    def __init__(self, shape):
        self.count = 0
        self.mean = np.zeros(shape)
        self.max = -np.ones(shape)
        self.min = np.ones(shape) * 1e16

    def update(self, values: np.ndarray):
        n = len(values)
        self.mean = (self.count * self.mean + values.sum(axis=0)) \
            / (self.count + n)
        self.count += n
        self.max = np.maximum(self.max, values.max(axis=0))
        self.min = np.minimum(self.min, values.min(axis=0))


class JointDistance2DSIP:
    """Keypoint pixel error in the source image plane + PCK."""

    def __init__(self, cfgs=None, num_joints=None):
        self.name = "Joint distance in the source image plane"
        self.input_size = tuple(
            cfgs["heatmapModel"]["input_size"]) if cfgs else (256, 256)
        self.count = 0
        self.mean = 0.0
        self.PCK_counts = np.zeros(len(PCK_THRES))

    def update(self, prediction, meta_data=None, ground_truth=None,
               logger=None):
        coords = prediction[1] if isinstance(prediction, tuple) else prediction
        avg, cnt, others = distance_in_source_image(
            np.asarray(coords), meta_data, self.input_size)
        self.mean = (self.mean * self.count + cnt * avg) / (self.count + cnt)
        self.count += cnt
        self.PCK_counts += others["correct_cnt"]

    def report(self, logger):
        logger.info(f"Error type: {self.name}\tMPJPE: {self.mean}")
        for t, v in zip(PCK_THRES, self.PCK_counts):
            logger.info(f"PCK at threshold {t:.2f}: {v / self.count:.3f}")


class AngleError:
    def __init__(self, cfgs=None, num_joints=None):
        self.name = "Angle error in degrees"
        self.count = 0
        self.mean = 0.0

    def update(self, prediction, meta_data=None, ground_truth=None,
               logger=None):
        avg, cnt = get_angle_error(np.asarray(prediction),
                                   meta_data["angles_gt"])
        self.mean = (self.mean * self.count + cnt * avg) / (self.count + cnt)
        self.count += cnt

    def report(self, logger):
        logger.info(f"Error type: {self.name}\tError: {self.mean}")


class RotationError3D:
    def __init__(self, cfgs=None, num_joints=None):
        self.name = "Rotation error"
        self.acc = _Accumulator(3)

    def update(self, prediction, ground_truth=None, meta_data=None,
               logger=None):
        self.acc.update(rotation_errors_euler(np.asarray(prediction),
                                              np.asarray(ground_truth)))

    def report(self, logger):
        logger.info(f"Error type: {self.name}\tMean: {self.acc.mean}\t"
                    f"Max: {self.acc.max}\tMin: {self.acc.min}")


class JointDistance3D:
    def __init__(self, cfgs=None, num_joints=None):
        self.name = "Joint distance"
        self.style = "direct"
        if cfgs and "metrics" in cfgs:
            self.style = cfgs["metrics"].get("JD3D", {}).get("style", "direct")
        nj = (int(cfgs["FCModel"]["output_size"] / 3)
              if cfgs and "FCModel" in cfgs else (num_joints or 32))
        self.num_joints = nj
        self.acc = _Accumulator(nj)

    def update(self, prediction, ground_truth=None, meta_data=None,
               logger=None):
        self.acc.update(joint_distances_3d(np.asarray(prediction),
                                           np.asarray(ground_truth),
                                           self.style))

    def report(self, logger):
        mpjpe = self.acc.mean.sum() / self.num_joints
        logger.info(f"Error type: {self.name}\tMPJPE: {mpjpe}")


class RError3D:
    """Relative-shape error: per-joint translation + residual rotation.

    T_style/R_style come from ``cfgs['metrics']['R3D']`` (reference
    criterions.py:397-398; shipped values 'direct'/'euler')."""

    def __init__(self, cfgs=None, num_joints=9):
        self.name = "RError3D"
        self.num_joints = num_joints - 1
        styles = (cfgs or {}).get("metrics", {}).get("R3D", {})
        self.T_style = styles.get("T_style", "direct")
        if styles.get("R_style", "euler") != "euler":
            raise NotImplementedError(styles["R_style"])
        self.rT = _Accumulator(self.num_joints)
        self.R = _Accumulator(3)

    def update(self, prediction, ground_truth=None, meta_data=None,
               logger=None):
        p = np.asarray(prediction)
        g = np.asarray(ground_truth)
        self.rT.update(joint_distances_3d(p, g, self.T_style))
        self.R.update(rotation_errors_euler(p, g))

    def report(self, logger):
        mpjpe = self.rT.mean.sum() / self.num_joints
        logger.info(f"Error type: {self.name}\tMPJPE: {mpjpe}\t"
                    f"R mean: {self.R.mean}")


class RTError3D:
    """Root translation + relative shape + rotation errors combined."""

    def __init__(self, cfgs=None, num_joints=9):
        self.name = "RTError3D"
        self.num_joints = num_joints - 1
        styles = (cfgs or {}).get("metrics", {}).get("RTError3D", {})
        self.T_style = styles.get("T_style", "direct")
        if styles.get("R_style", "euler") != "euler":
            raise NotImplementedError(styles["R_style"])
        self.T = _Accumulator(1)
        self.rT = _Accumulator(self.num_joints)
        self.R = _Accumulator(3)

    def update(self, prediction, ground_truth=None, meta_data=None,
               logger=None):
        p = np.asarray(prediction)
        g = np.asarray(ground_truth)
        self.T.update(joint_distances_3d(p[:, :3], g[:, :3], self.T_style))
        self.rT.update(joint_distances_3d(p[:, 3:], g[:, 3:], self.T_style))
        self.R.update(rotation_errors_euler(p[:, 3:], g[:, 3:]))

    def report(self, logger):
        mpjpe = self.rT.mean.sum() / self.num_joints
        logger.info(f"Error type: {self.name}\tRoot T: {self.T.mean}\t"
                    f"MPJPE: {mpjpe}\tR mean: {self.R.mean}")


METRIC_REGISTRY = {
    "JointDistance2DSIP": JointDistance2DSIP,
    "AngleError": AngleError,
    "RotationError3D": RotationError3D,
    "JointDistance3D": JointDistance3D,
    "RError3D": RError3D,
    "RTError3D": RTError3D,
}


class Evaluator:
    """Explicit-registry version of the reference's eval()-dispatched
    evaluator (criterions.py:540-573)."""

    def __init__(self, metrics, cfgs=None, num_joints=9):
        self.metrics = [METRIC_REGISTRY[m](cfgs=cfgs, num_joints=num_joints)
                        for m in metrics]

    def update(self, prediction, ground_truth=None, meta_data=None,
               logger=None):
        for m in self.metrics:
            m.update(prediction, ground_truth=ground_truth,
                     meta_data=meta_data, logger=logger)

    def report(self, logger):
        for m in self.metrics:
            m.report(logger)
