"""Batched orientation recovery in fp32 torch: template fit, rigid
alignment (Horn quaternion with a fixed-schedule Jacobi eigensolver, or
SVD with the reflection fix), euler extraction and observation angles.
Port of ``egonet_tpu/geometry/rigid.py``.  The facade's rigid stage runs
the quaternion path as one kernel, ``ops/rigid_solve.py``; the solve here
is its tests' reference and serves the callers outside the facade.

Conventions: euler order as scipy ``as_euler('yxz')`` (R = Rz(c) Rx(b)
Ry(a)), reordered to (rx, ry, rz); template h/l/w from the 4 parallel edges
per dimension; alpha = ry - atan2(-z, x) - pi/2 wrapped to [-pi, pi].
"""

from __future__ import annotations

import math

import torch

from egonet_tpu_torch.constants import INTERP_DICT, DEFAULT_INTERP_COEF

# 0-based (parent, child) corner indices of the 12 edges within the
# 32-point center-relative prediction (corners occupy slots 0..7).
_EDGE_P = (INTERP_DICT["bbox12"][0] - 1).tolist()
_EDGE_C = (INTERP_DICT["bbox12"][1] - 1).tolist()


def _runs(idx) -> tuple:
    """``idx`` as a few slices (maximal runs of a constant positive step),
    so that :func:`_take` gathers on the device with no index tensor: a
    Python list as an index is copied to the device first, and that copy
    waits for the device."""
    out, i = [], 0
    while i < len(idx):
        j = i + 1
        step = idx[j] - idx[i] if j < len(idx) else 1
        while step > 0 and j < len(idx) and idx[j] - idx[j - 1] == step:
            j += 1
        if step <= 0:
            step, j = 1, i + 1
        out.append(slice(idx[i], idx[j - 1] + 1, step))
        i = j
    return tuple(out)


def _take(x: torch.Tensor, dim: int, runs: tuple) -> torch.Tensor:
    """``x`` indexed along ``dim`` by the indices of ``runs``."""
    pre = (slice(None),) * dim
    return torch.cat([x[pre + (r,)] for r in runs], dim=dim)


_EDGE_P_RUNS, _EDGE_C_RUNS = _runs(_EDGE_P), _runs(_EDGE_C)


def template_from_prediction(pred: torch.Tensor,
                             interp_coef=DEFAULT_INTERP_COEF) -> torch.Tensor:
    """Canonical (zero-rotation) cuboid templates sized like the
    predictions.  pred: [N, 32, 3] center-relative points.
    Returns [N, 3, 32]."""
    parents = _take(pred, 1, _EDGE_P_RUNS)
    children = _take(pred, 1, _EDGE_C_RUNS)
    lines = torch.sqrt(torch.sum((parents - children) ** 2, dim=2))  # [N, 12]
    h = torch.sum(lines[:, 0:4], dim=1) / 4.0
    l = torch.sum(lines[:, 4:8], dim=1) / 4.0
    w = torch.sum(lines[:, 8:12], dim=1) / 4.0

    z = torch.zeros_like(h)
    x_corners = torch.stack([l, l, l, l, z, z, z, z], 1) - (l / 2.0)[:, None]
    y_corners = torch.stack([z, h, z, h, z, h, z, h], 1) - h[:, None]
    z_corners = torch.stack([w, w, z, z, w, w, z, z], 1) - (w / 2.0)[:, None]
    corners = torch.stack([x_corners, y_corners, z_corners], 1)  # [N, 3, 8]

    p = _take(corners, 2, _EDGE_P_RUNS)
    c = _take(corners, 2, _EDGE_C_RUNS)
    lines3 = c - p
    new_pts = [p + coef * lines3 for coef in interp_coef]
    return torch.cat([corners] + new_pts, dim=2)                # [N, 3, 32]


def kabsch(X: torch.Tensor, Y: torch.Tensor, method: str = "svd"):
    """Least-squares rigid transform R, t with R @ X + t ~= Y; X, Y [3, N].
    'svd': SVD with the det<0 reflection fix; 'quaternion': Horn's
    closed form through :func:`rotation_from_covariance_quat`."""
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    cx = X.mean(dim=1, keepdim=True)
    cy = Y.mean(dim=1, keepdim=True)
    H = (X - cx) @ (Y - cy).T
    if method == "quaternion":
        R = rotation_from_covariance_quat(H[None])[0]
    else:
        R = rotation_from_covariance_svd(H[None])[0]
    t = -(R @ cx) + cy
    return R, t


def rotation_from_covariance_svd(H: torch.Tensor) -> torch.Tensor:
    """The SVD construction V' diag(1, 1, det) U^T for batched [N, 3, 3]
    covariances (reflection fixed by flipping the last row of V^T)."""
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(1, 2), U.transpose(1, 2)
    sign = torch.where(torch.linalg.det(V @ Ut) < 0, -1.0, 1.0)
    Vt = torch.cat([Vt[:, :-1], Vt[:, -1:] * sign[:, None, None]], dim=1)
    return Vt.transpose(1, 2) @ Ut


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _jacobi_eig4(K: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of batched symmetric 4x4 matrices by cyclic
    Jacobi rotations with a static pair schedule (sweeps * 6 rotations, no
    data-dependent control flow).

    K: [N, 4, 4].  Returns (eigenvalues [N, 4], eigenvectors [N, 4, 4] as
    columns)."""
    n = K.shape[0]
    eye = torch.eye(4, dtype=K.dtype, device=K.device)
    V = eye.expand(n, 4, 4)
    for _ in range(sweeps):
        for p, q in _PAIRS:
            kpq = K[:, p, q]
            kpp = K[:, p, p]
            kqq = K[:, q, q]
            # t = sign(tau)/(|tau| + sqrt(1+tau^2)); tau == 0 must give
            # t = 1 (a 45-degree rotation), NOT sign(0) = 0
            tau = (kqq - kpp) / (2.0 * torch.where(kpq == 0.0,
                                                   torch.ones_like(kpq), kpq))
            sgn = torch.where(tau >= 0.0, 1.0, -1.0)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(kpq == 0.0, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            ep = eye[p]
            eq = eye[q]
            G = (eye[None]
                 + (c - 1.0)[:, None, None] * (torch.outer(ep, ep)
                                               + torch.outer(eq, eq))[None]
                 + s[:, None, None] * torch.outer(ep, eq)[None]
                 - s[:, None, None] * torch.outer(eq, ep)[None])
            K = torch.einsum("nij,nik,nkl->njl", G, K, G)
            V = torch.einsum("nij,njk->nik", V, G)
    return torch.diagonal(K, dim1=1, dim2=2), V


def rotation_from_covariance_quat(H: torch.Tensor) -> torch.Tensor:
    """Optimal proper rotation maximizing tr(R @ H) for batched 3x3
    covariances (Horn 1987): the argmax eigenvector of the 4x4 symmetric
    matrix is the rotation's quaternion.  H: [N, 3, 3] -> [N, 3, 3]."""
    H = H.to(torch.float32)
    n = H.shape[0]
    trace = H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]
    d = torch.stack([H[:, 1, 2] - H[:, 2, 1],
                     H[:, 2, 0] - H[:, 0, 2],
                     H[:, 0, 1] - H[:, 1, 0]], dim=1)
    S = H + H.transpose(1, 2)
    K = torch.zeros((n, 4, 4), dtype=torch.float32, device=H.device)
    K[:, 0, 0] = trace
    K[:, 0, 1:] = d
    K[:, 1:, 0] = d
    K[:, 1:, 1:] = S - trace[:, None, None] * torch.eye(
        3, dtype=torch.float32, device=H.device)[None]
    evals, evecs = _jacobi_eig4(K)
    idx = torch.argmax(evals, dim=1)
    q = torch.gather(evecs, 2, idx[:, None, None].expand(n, 4, 1))[..., 0]
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=1),
    ], dim=1)


def euler_yxz(R: torch.Tensor) -> torch.Tensor:
    """Angles (a, b, c) with R = Rz(c) @ Rx(b) @ Ry(a), for [..., 3, 3].
    Returns [..., 3] = (y, x, z)."""
    b = torch.arcsin(torch.clamp(R[..., 2, 1], -1.0, 1.0))
    a = torch.atan2(-R[..., 2, 0], R[..., 2, 2])
    c = torch.atan2(-R[..., 0, 1], R[..., 1, 1])
    return torch.stack([a, b, c], dim=-1)


def rotation_to_xyz_angles(R: torch.Tensor) -> torch.Tensor:
    """(rx, ry, rz) ordering used by the KITTI emission path."""
    ayxz = euler_yxz(R)
    return torch.stack([ayxz[..., 1], ayxz[..., 0], ayxz[..., 2]], dim=-1)


def six_dof_from_cuboids(predictions: torch.Tensor,
                         interp_coef=DEFAULT_INTERP_COEF,
                         method: str = "quaternion"):
    """Batched 6DoF recovery from [N, 32, 3] center-relative cuboids.

    Returns (angles [N, 3] as (rx, ry, rz), translations [N, 3]); the
    translation is the first predicted point, as in the original
    pipeline (a relative point for the 'R3d' output representation)."""
    predictions = predictions.to(torch.float32)
    templates = template_from_prediction(predictions, interp_coef)  # [N,3,32]
    Y = predictions.transpose(1, 2)
    Xc = templates - templates.mean(dim=2, keepdim=True)
    Yc = Y - Y.mean(dim=2, keepdim=True)
    H = torch.einsum("nik,njk->nij", Xc, Yc)
    if method == "quaternion":
        R = rotation_from_covariance_quat(H)
    else:
        R = rotation_from_covariance_svd(H)
    angles = rotation_to_xyz_angles(R)
    translations = predictions[:, 0, :]
    return angles, translations


def wrap_to_pi(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi) with a floor modulo (as ``jnp.mod``)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def observation_angle_trans(ry: torch.Tensor,
                            translations: torch.Tensor) -> torch.Tensor:
    """alpha from a known 3D location: ry - atan2(-z, x) - pi/2."""
    x3d = translations[:, 0]
    z3d = translations[:, 2]
    return wrap_to_pi(ry - torch.atan2(-z3d, x3d) - 0.5 * math.pi)


def observation_angle_proj(ry: torch.Tensor, kpts_x: torch.Tensor,
                           f: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
    """alpha from the image-plane projection of the object center;
    kpts_x: [N] screen x of the first (center) keypoint."""
    x3d = kpts_x - cx
    z3d = torch.broadcast_to(f, x3d.shape)
    return wrap_to_pi(ry - torch.atan2(-z3d, x3d) - 0.5 * math.pi)
