"""Constants the port reads (copy of the matching parts of
``egonet_tpu/constants.py``): the crop-scale convention, the instance cap
of a training batch, the KITTI label schema, the cuboid edge
interpolation table, the cross-ratio gather table and target, ImageNet
statistics and the add_xy 0-255 quirk."""

from __future__ import annotations

import numpy as np

# Scale convention: a crop "scale" of s covers s*SIZE source pixels.
SIZE = 200.0

# Instances per IGR training batch: the loader pads to it (duplicating real
# instances) and subsamples above it.
MAX_INS_CNT = 140

TYPE_ID_CONVERSION = {
    "Car": 0,
    "Cyclist": 1,
    "Pedestrian": 2,
}

# KITTI label txt columns (ground truth); predictions append a score column.
FIELDNAMES = [
    "type", "truncated", "occluded", "alpha",
    "xmin", "ymin", "xmax", "ymax",
    "dh", "dw", "dl",
    "lx", "ly", "lz",
    "ry",
]
FIELDNAMES_P = FIELDNAMES + ["score"]

# Cuboid corner numbering (1-based, canonical 9-point cuboid [center,
# c1..c8]).  Each of the 12 edges is a (parent, child) pair: the first 4
# run along the height, the next 4 along the length, the last 4 along the
# width.
INTERP_DICT = {
    "bbox12": (
        np.array([1, 3, 5, 7,
                  1, 2, 3, 4,
                  1, 2, 5, 6]),
        np.array([2, 4, 6, 8,
                  5, 6, 7, 8,
                  3, 4, 7, 8]),
    ),
    "bbox12l": (np.array([1, 2, 3, 4]), np.array([5, 6, 7, 8])),
    "bbox12h": (np.array([1, 3, 5, 7]), np.array([2, 4, 6, 8])),
    "bbox12w": (np.array([1, 2, 5, 6]), np.array([3, 4, 7, 8])),
}

# For each of the 12 edges: [parent, first interpolated point, second
# interpolated point, child] as 0-based indices into the 33-point keypoint
# array [center, corner1..corner8, interp1(12), interp2(12)].
CR_INDICES = np.array(
    [[1,  9, 21,  2],
     [3, 10, 22,  4],
     [5, 11, 23,  6],
     [7, 12, 24,  8],
     [1, 13, 25,  5],
     [2, 14, 26,  6],
     [3, 15, 27,  7],
     [4, 16, 28,  8],
     [1, 17, 29,  3],
     [2, 18, 30,  4],
     [5, 19, 31,  7],
     [6, 20, 32,  8]]
)

# The target cross-ratio of 4 points [p, p+0.332*(c-p), p+0.667*(c-p), c].
TARGET_CROSS_RATIO = 4.0 / 3.0

# Interpolation coefficients used by every shipped config.
DEFAULT_INTERP_COEF = (0.332, 0.667)

# ImageNet normalization used for the crop inputs.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def norm_stats(cfgs: dict | None):
    """(mean, std) float32 arrays for crop normalization, from
    ``dataset.pth_transform`` when present, else ImageNet's."""
    pth = (((cfgs or {}).get("dataset") or {}).get("pth_transform") or {})
    return (np.asarray(pth.get("mean", IMAGENET_MEAN), np.float32),
            np.asarray(pth.get("std", IMAGENET_STD), np.float32))


def crop_scale_divisor(cfgs: dict | None) -> float:
    """Divisor applied to 0-255 crop pixels before mean/std normalization:
    255 normally, 1 for ``heatmapModel.add_xy`` models, which were trained
    on 0-255-scale RGB (the float32 xy concat defeats ToTensor's /255 in
    the original pipeline, and checkpoints depend on it)."""
    hm = (cfgs or {}).get("heatmapModel") or {}
    return 1.0 if hm.get("add_xy") else 255.0


def compute_cr_indices() -> np.ndarray:
    """``CR_INDICES`` derived from the interpolation table: for each of the
    12 box edges, (parent, its two interpolated points, child) (the
    reference's construction, car_instance.py:99-119)."""
    num_base_pts = 9
    parents, children = INTERP_DICT["bbox12"]
    return np.array([[parents[i], num_base_pts + i, num_base_pts + 12 + i,
                      children[i]] for i in range(12)])
