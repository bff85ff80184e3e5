"""Heatmap-model selection by ``heatmapModel.name`` (explicit registry, as
``egonet_tpu/models/factory.py``):

  hrnet / pose_hrnet           -> models/hrnet.py       (W48 / W32)
  resnet / pose_resnet         -> models/resnet.py      (Simple-Baselines)
  tpu_native / posenet_tpu     -> models/tpu_native.py  (PoseNetTPU)
"""

from __future__ import annotations

import torch

from egonet_tpu_torch.models.hrnet import build_hrnet
from egonet_tpu_torch.models.resnet import build_pose_resnet
from egonet_tpu_torch.models.tpu_native import build_tpu_native

_REGISTRY = {
    "hrnet": build_hrnet,
    "pose_hrnet": build_hrnet,
    "resnet": build_pose_resnet,
    "pose_resnet": build_pose_resnet,
    "tpu_native": build_tpu_native,
    "posenet_tpu": build_tpu_native,
}


def build_heatmap_model(cfgs: dict, dtype=torch.float32):
    """Build the configured heatmap backbone (default: hrnet)."""
    name = str(cfgs.get("heatmapModel", {}).get("name", "hrnet")).lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"heatmapModel.name {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfgs, dtype=dtype)
