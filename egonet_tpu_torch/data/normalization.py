"""1D data standardization, the LS.npy statistics contract (copy of
``egonet_tpu/data/normalization.py``): dataset-level mean / std
standardization plus the per-instance (translation- and scale-invariant)
variant."""

from __future__ import annotations

import numpy as np


def get_statistics_1d(data: np.ndarray):
    assert data.ndim == 2
    return data.mean(axis=0, keepdims=True), data.std(axis=0, keepdims=True)


def normalize_1d(data, mean, std, individual: bool = False):
    if not individual:
        return (data - mean) / std
    data = np.array(data, dtype=np.float64)
    n = len(data)
    pts = data.reshape(n, -1, 2)
    mean_x = pts[:, :, 0].mean(axis=1).reshape(n, 1)
    mean_y = pts[:, :, 1].mean(axis=1).reshape(n, 1)
    denom = (0.5 * (pts[:, :, 0].std(axis=1)
                    + pts[:, :, 1].std(axis=1))).reshape(n, 1)
    pts[:, :, 0] = (pts[:, :, 0] - mean_x) / denom
    pts[:, :, 1] = (pts[:, :, 1] - mean_y) / denom
    return pts.reshape(n, -1)


def unnormalize_1d(normalized, mean, std):
    return normalized * std + mean
