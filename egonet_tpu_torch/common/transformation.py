"""Host-side (NumPy) 3D transformation utilities (copy of
``egonet_tpu/common/transformation.py``): world / camera frames, the
Procrustes similarity transform, the weighted Kabsch rigid transform with
the reflection fix (the metrics use them) and ``pnp_refine``, whose
OpenCV is imported inside it (an ImportError naming cv2 where it is
missing)."""

from __future__ import annotations

import numpy as np


def world_to_camera_frame(P: np.ndarray, R: np.ndarray, T: np.ndarray):
    assert P.ndim == 2 and P.shape[1] == 3
    return (R @ (P.T - T)).T


def camera_to_world_frame(P: np.ndarray, R: np.ndarray, T: np.ndarray):
    assert P.ndim == 2 and P.shape[1] == 3
    return (R.T @ P.T + T).T


def compute_similarity_transform(X: np.ndarray, Y: np.ndarray,
                                 compute_optimal_scale: bool = False):
    """Procrustes alignment of Y onto X.

    Returns (d, Z, T, b, c): squared error, transformed Y, rotation, scale,
    translation.
    """
    muX, muY = X.mean(0), Y.mean(0)
    X0, Y0 = X - muX, Y - muY
    ssX = (X0 ** 2).sum()
    ssY = (Y0 ** 2).sum()
    normX, normY = np.sqrt(ssX), np.sqrt(ssY)
    X0, Y0 = X0 / normX, Y0 / normY
    A = X0.T @ Y0
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    V = Vt.T
    T = V @ U.T
    detT = np.linalg.det(T)
    V[:, -1] *= np.sign(detT)
    s[-1] *= np.sign(detT)
    T = V @ U.T
    traceTA = s.sum()
    if compute_optimal_scale:
        b = traceTA * normX / normY
        d = 1 - traceTA ** 2
        Z = normX * traceTA * (Y0 @ T) + muX
    else:
        b = 1
        d = 1 + ssY / ssX - 2 * traceTA * normY / normX
        Z = normY * (Y0 @ T) + muX
    c = muX - b * (muY @ T)
    return d, Z, T, b, c


def compute_rigid_transform(X: np.ndarray, Y: np.ndarray, W=None):
    """Least-squares rigid transform (R, t) with R @ X + t ~= Y.

    X, Y: [d, N]; W: optional [N] weights or [N, N] matrix.
    """
    assert len(X) == len(Y)
    cX = X.mean(axis=1, keepdims=True)
    cY = Y.mean(axis=1, keepdims=True)
    Xm, Ym = X - cX, Y - cY
    if W is None:
        H = Xm @ Ym.T
    else:
        W = np.diag(W) if W.ndim == 1 else W
        H = Xm @ W @ Ym.T
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[-1, :] *= -1
        R = Vt.T @ U.T
    t = -R @ cX + cY
    return R, t


def procrustes_transform(X: np.ndarray, Y: np.ndarray):
    R, t = compute_rigid_transform(X, Y)
    return R @ X + t


def pnp_refine(prediction: np.ndarray, observation: np.ndarray,
               intrinsics: np.ndarray, dist_coeffs=None):
    """Refine a 3D prediction against 2D observations with iterative PnP
    (host-side, optional; uses OpenCV).  Returns the [3, N] refined
    points, or ``prediction`` itself where solvePnP fails."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError("pnp_refine needs cv2 (OpenCV's solvePnP), which "
                          "is not installed") from exc
    if dist_coeffs is None:
        dist_coeffs = np.zeros((4, 1))
    success, rvec, tvec = cv2.solvePnP(
        prediction, observation, intrinsics, dist_coeffs,
        flags=cv2.SOLVEPNP_ITERATIVE)
    if not success:
        return prediction
    return cv2.Rodrigues(rvec)[0] @ prediction.T + tvec
