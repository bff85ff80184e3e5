"""Canonical 3D cuboid construction, camera-frame placement, projection and
the in-image visibility flag (NumPy; copy of the matching parts of
``egonet_tpu/data/cuboid.py``).  The KITTI reader projects labeled cuboids
with them; the cuboid also serves as the lifter's output mean when no
trained ``LS.npy`` is at hand."""

from __future__ import annotations

import numpy as np

from egonet_tpu_torch.constants import INTERP_DICT, DEFAULT_INTERP_COEF


def interpolate_cuboid(bbox_3d: np.ndarray,
                       style: str = "bbox12",
                       interp_coef=DEFAULT_INTERP_COEF) -> np.ndarray:
    """Append ``parent + c*(child - parent)`` for each edge and coefficient
    to [3, K] points whose columns 1..8 are the corners."""
    pidx, cidx = INTERP_DICT[style]
    parents, children = bbox_3d[:, pidx], bbox_3d[:, cidx]
    lines = children - parents
    new_joints = [parents + c * lines for c in interp_coef]
    return np.hstack([bbox_3d] + new_joints)


def construct_box_3d(l: float, h: float, w: float,
                     interpolate: bool = True,
                     style: str = "bbox12",
                     interp_coef=DEFAULT_INTERP_COEF) -> np.ndarray:
    """Canonical cuboid: center + 8 corners (+ interpolated points), bottom
    face centered at the origin, y pointing down.  Returns [3, 9] or
    [3, 9 + 12*len(coef)]."""
    # float32 shifts (halved l/w, full h), as the original dataset code does
    x_c = (np.array([0.5 * l, l, l, l, l, 0, 0, 0, 0], dtype=np.float64)
           - np.float32(l) / 2)
    y_c = (np.array([0.5 * h, 0, h, 0, h, 0, h, 0, h], dtype=np.float64)
           - np.float32(h))
    z_c = (np.array([0.5 * w, w, w, 0, 0, w, w, 0, 0], dtype=np.float64)
           - np.float32(w) / 2)
    corners = np.array([x_c, y_c, z_c])
    if interpolate:
        corners = interpolate_cuboid(corners, style, interp_coef)
    return corners


def rot_y_matrix(ry: float) -> np.ndarray:
    c, s = np.cos(ry), np.sin(ry)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotation_matrix_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rz @ Ry @ Rx."""
    cx, sx = np.cos(rx), np.sin(rx)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ rot_y_matrix(ry) @ mx


def place_cuboid(corners_canonical: np.ndarray, pose_vec: np.ndarray,
                 shift: np.ndarray, rot_xz: bool = False) -> np.ndarray:
    """Rotate + translate the canonical cuboid [3, K] into the camera frame.
    pose_vec [6] = (x, y, z, rx, ry, rz); shift [3, 1] = K^-1 @ P[:, 3].
    Returns [K, 3]."""
    x, y, z, rx, ry, rz = [float(v) for v in np.asarray(pose_vec).reshape(6)]
    rot = rotation_matrix_xyz(rx, ry, rz) if rot_xz else rot_y_matrix(ry)
    pts = rot @ corners_canonical
    pts = pts + np.array([x, y, z]).reshape(3, 1) + shift.reshape(3, 1)
    return pts.T


def project_3d_to_2d(points: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pinhole projection of [N, 3] camera points -> [3, N] rows (u, v,
    depth)."""
    projected = K @ points.T
    projected = projected.astype(np.float64).copy()
    projected[:2, :] /= projected[2, :]
    return projected


def add_visibility(joints: np.ndarray, img_width: int = 1242,
                   img_height: int = 375) -> np.ndarray:
    """Append a binary in-image flag to [N, 2] screen points."""
    assert joints.shape[1] == 2
    inside = ((joints[:, 0] > 0.0) & (joints[:, 1] > 0.0)
              & (joints[:, 0] < img_width) & (joints[:, 1] < img_height))
    return np.hstack([joints, inside.astype(np.float64).reshape(-1, 1)])
