"""2D/3D plotting primitives for cuboid keypoints (a copy of
``egonet_tpu/visualization/points.py``): scatter / line helpers, the
cuboid connection tables, scene-level 3D box plotting, pose-vector
labels, and the numpy geometry of cuboids (corners from a KITTI pose, ray
/ triangle tests, vertex visibility, face triangles, triangle areas).

matplotlib (Agg backend, file output) is imported inside the functions
that draw (:func:`pyplot`), so importing this module never needs it; a
host without it gets an ImportError that names it.
"""

from __future__ import annotations

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, with the 3D axes
    registered; an ImportError naming matplotlib where it is missing."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("drawing needs matplotlib, which is not "
                          "installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401
    return plt


# 0-based edges of the 8-corner cuboid (corner order of construct_box_3d)
BOX_CONNECTIONS = [
    (0, 1), (2, 3), (4, 5), (6, 7),      # height edges
    (0, 4), (1, 5), (2, 6), (3, 7),      # length edges
    (0, 2), (1, 3), (4, 6), (5, 7),      # width edges
]

# edges including the center point at index 0 (9-point layout)
BOX9_CONNECTIONS = [(a + 1, b + 1) for a, b in BOX_CONNECTIONS]


def plot_3d_points(ax, points, color="b", size=15):
    """points: [N, 3] or [3, N]."""
    pts = np.asarray(points)
    if pts.shape[0] == 3 and pts.shape[1] != 3:
        pts = pts.T
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, s=size)
    return ax


def plot_lines(ax, points, connections, dimension=2, c="r", lw=2, linestyle="-"):
    """Draw line segments given a point array and an edge list."""
    pts = np.asarray(points)
    for a, b in connections:
        if dimension == 2:
            ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                    c=c, lw=lw, linestyle=linestyle)
        else:
            ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                    [pts[a, 2], pts[b, 2]], c=c, lw=lw, linestyle=linestyle)
    return ax


def plot_2d_bbox(ax, kpts_2d, color="r", lw=2):
    """kpts_2d: [8, 2] projected cuboid corners (no center)."""
    return plot_lines(ax, kpts_2d, BOX_CONNECTIONS, dimension=2, c=color,
                      lw=lw)


def plot_3d_bbox(ax, kpts_3d, color="r", lw=2, linestyle="-"):
    """kpts_3d: [8, 3] cuboid corners in camera coordinates."""
    return plot_lines(ax, kpts_3d, BOX_CONNECTIONS, dimension=3, c=color,
                      lw=lw, linestyle=linestyle)


def get_bbox_3d(dimension, location, ry):
    """8 cuboid corners in camera coordinates from a KITTI pose."""
    l, h, w = dimension
    xs = np.array([l, l, l, l, 0, 0, 0, 0]) - l / 2.0
    ys = np.array([0, h, 0, h, 0, h, 0, h]) - h
    zs = np.array([w, w, 0, 0, w, w, 0, 0]) - w / 2.0
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pts = rot @ np.vstack([xs, ys, zs]) + np.asarray(location).reshape(3, 1)
    return pts.T


def plot_scene_3dbox(ax, kpts_3d_list, color="r"):
    """Plot a list of [8+, 3] cuboids into one 3D scene axis."""
    for kpts in kpts_3d_list:
        pts = np.asarray(kpts)
        if len(pts) >= 9:                 # includes center point
            pts = pts[1:9]
        plot_3d_bbox(ax, pts[:8], color=color)
    return ax


def draw_pose_vecs(ax, pose_vecs, color="black"):
    """Annotate translation + euler angles next to each box center."""
    if pose_vecs is None:
        return ax
    for pv in pose_vecs:
        x, y, z, rx, ry, rz = [float(v) for v in np.asarray(pv).reshape(-1)[:6]]
        ax.text(x, y, z, f"({rx:.2f},{ry:.2f},{rz:.2f})", color=color,
                fontsize=7)
    return ax


def ray_intersect_triangle(p0, p1, triangle) -> int:
    """Ray (p0 -> p1) vs triangle test (Moller-Trumbore style, matching the
    reference semantics at points.py:364-410): 0 = no hit, 1 = hit,
    2 = ray origin lies in the triangle plane point."""
    v0, v1, v2 = triangle
    u = v1 - v0
    v = v2 - v0
    normal = np.cross(u, v)
    b = np.inner(normal, p1 - p0)
    a = np.inner(normal, v0 - p0)
    if b == 0.0:
        if a != 0.0:
            return 0
        r = 0.0
    else:
        r = a / b
    if r < 0.0:
        return 0
    w = p0 + r * (p1 - p0) - v0
    uv, uu, vv = np.inner(u, v), np.inner(u, u), np.inner(v, v)
    denom = uv * uv - uu * vv
    si = (uv * np.inner(w, v) - vv * np.inner(w, u)) / denom
    if si < 0.0 or si > 1.0:
        return 0
    ti = (uv * np.inner(w, u) - uu * np.inner(w, v)) / denom
    if ti < 0.0 or si + ti > 1.0:
        return 0
    return 2 if r == 0.0 else 1


def get_visibility(box3d: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Self/scene-occlusion visibility of cuboid vertices: a vertex is
    hidden when the ray to the camera origin crosses any triangle.

    box3d: [8, 3] camera-frame corners; triangles: [N, 3, 3]."""
    visibility = np.ones(8, dtype=bool)
    origin = np.zeros(3)
    for idx, p0 in enumerate(box3d):
        for triangle in triangles:
            if ray_intersect_triangle(p0, origin, triangle) == 1:
                visibility[idx] = False
                break
    return visibility


def cuboid_triangles(box3d: np.ndarray) -> np.ndarray:
    """Triangulate the 6 faces of an 8-corner cuboid -> [12, 3, 3]."""
    faces = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
    tris = []
    for a, b, c, d in faces:
        tris.append(box3d[[a, b, c]])
        tris.append(box3d[[a, c, d]])
    return np.stack(tris)


def get_area(points: np.ndarray, indices: np.ndarray,
             preserve_points: bool = False) -> np.ndarray:
    """Signed triangle areas as a feature vector (the 'coordinates2d+area'
    lifter input representation; spec points.py:270-282)."""
    vec1 = points[indices[:, 1], :] - points[indices[:, 0], :]
    vec2 = points[indices[:, 2], :] - points[indices[:, 0], :]
    area = (np.cross(vec1, vec2) * 0.5).reshape(1, -1)
    if preserve_points:
        return np.hstack([points.reshape(1, -1), area])
    return area


def new_3d_axis(figsize=(10, 7)):
    fig = pyplot().figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    return fig, ax
