"""Constants the inference slice reads (copy of the matching parts of
``egonet_tpu/constants.py``): the crop-scale convention, the KITTI label
schema, the cuboid edge interpolation table, ImageNet statistics and the
add_xy 0-255 quirk."""

from __future__ import annotations

import numpy as np

# Scale convention: a crop "scale" of s covers s*SIZE source pixels.
SIZE = 200.0

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
