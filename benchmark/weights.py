"""Seeded weights for a configuration, made by the benchmark and handed
alike to the program (``EgoNet.load_state``) and to the plain reference.

Every tensor is drawn on the run's device from one ``torch.Generator``
seeded by ``--seed``, in two calls (one normal, one uniform draw, sliced
per tensor).  Conv and linear weights are LeCun normal; batch-norm scales
are uniform in ``bn_gamma`` (``bn_gamma_residual`` for the norm that
closes a residual branch), shifts and biases normal with ``bias_std``.
The keypoint model is the configuration's family
(``reference/keypoint_<name>.py``, by ``heatmapModel.name``): its
``shapes`` give the tensors to draw, and its ``fit_head`` sets the
running statistics from a calibration batch of the cell's own crops
through the reference (``calibrate=True``), so each layer's output has a
known scale and the trunk's work reaches the keypoints (with raw random
weights the activations grow through HRNet's 104 residual blocks and the
head's sigmoids saturate), then rescales the head's last layer so its
logits have standard deviation ``logit_std``.  The lifter's input
statistics come from the same batch.  The lifter's output statistics
decode its outputs into a cuboid of the configuration's dimensions
(``cuboid_lhw``) at a seeded yaw, with ``std_out`` metres of spread, so
the rigid solve is well conditioned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import egonet_ref as ref


def _draw(shapes: dict, gen, device, params) -> dict:
    """State tensors for ``shapes`` ({key: shape}), drawn in one normal
    and one uniform call."""
    normal_keys = [k for k, s in shapes.items()
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked"))
                   and not (k.endswith(".weight") and len(s) == 1)]
    gamma_keys = [k for k, s in shapes.items()
                  if k.endswith(".weight") and len(s) == 1]
    n_normal = sum(math.prod(shapes[k]) for k in normal_keys)
    n_gamma = sum(math.prod(shapes[k]) for k in gamma_keys)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_gamma, generator=gen, device=device)
    state, at = {}, 0
    for k in normal_keys:
        s = shapes[k]
        v = normal[at:at + math.prod(s)].view(s)
        at += math.prod(s)
        if len(s) >= 2:
            v = v / math.sqrt(math.prod(s[1:]))
        else:
            v = v * float(params["bias_std"])
        state[k] = v
    at = 0
    for k in gamma_keys:
        s = shapes[k]
        closing = k.endswith((".bn2.weight", ".bn3.weight"))
        lo, hi = params["bn_gamma_residual" if closing else "bn_gamma"]
        state[k] = lo + (hi - lo) * uniform[at:at + s[0]]
        at += s[0]
    for k, s in shapes.items():
        if k.endswith("running_mean"):
            state[k] = torch.zeros(s, device=device)
        elif k.endswith("running_var"):
            state[k] = torch.ones(s, device=device)
        elif k.endswith("num_batches_tracked"):
            state[k] = torch.zeros(s, dtype=torch.long, device=device)
    return state


def cuboid_points(l, h, w, yaw):
    """The 32 points of a cuboid of length, height, width (metres), centred
    on its centroid and turned by ``yaw`` about the vertical axis:
    [32, 3]."""
    corners = np.stack([
        np.array([l, l, l, l, 0, 0, 0, 0]) - l / 2,
        np.array([0, h, 0, h, 0, h, 0, h]) - h,
        np.array([w, w, 0, 0, w, w, 0, 0]) - w / 2], 1)
    p = corners[list(ref.EDGE_PARENT)]
    c = corners[list(ref.EDGE_CHILD)]
    pts = np.concatenate([corners] + [p + s * (c - p) for s in ref.INTERP])
    pts = pts - pts.mean(0)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rot = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return pts @ rot.T


def make(cfg: dict, seed: int, device, frames, items) -> tuple:
    """(keypoint_state, lifter_state, ls_stats) for configuration ``cfg``
    (its ``weights`` block holds the draw's parameters), calibrated on the
    crops ``items`` ({'frame', 'box'}) of ``frames`` (uint8 [B, H, W, 3]
    on ``device``)."""
    params = cfg["weights"]
    keypoints = ref.keypoint_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kstate = _draw(keypoints.shapes(cfg), gen, device, params)
    lstate = _draw(ref.lifter_shapes(cfg), gen, device, params)
    yaw = float(torch.rand(1, generator=gen, device=device)) * 2 * math.pi \
        - math.pi
    hm = cfg["heatmapModel"]
    in_w, in_h = hm["input_size"]
    pth = cfg["dataset"]["pth_transform"]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            inv, _ = ref.crop_affines(items["box"], (in_h, in_w))
            x = ref.normalize_crops(
                ref.sample_crops(frames, items["frame"], inv, (in_h, in_w)),
                pth["mean"], pth["std"])
            keypoints.fit_head(kstate, x, cfg, params)
            coords = keypoints.forward(kstate, x, cfg).double()
            inv_t = torch.as_tensor(inv, device=device)
            local = coords * torch.tensor([in_w, in_h], dtype=torch.float64,
                                          device=device)
            screen = (torch.einsum("nkj,nij->nki", local, inv_t[:, :, :2])
                      + inv_t[:, None, :, 2]).reshape(len(x), -1)
            mean_in = screen.mean(0, keepdim=True)
            std_in = screen.std(0, keepdim=True).clamp_min(1.0)
            ref.lifter_forward(lstate, ((screen - mean_in) / std_in).float(),
                               cfg, calibrate=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    l, h, w = params["cuboid_lhw"]
    out = int(cfg["FCModel"]["output_size"])
    ls_stats = {
        "mean_in": mean_in.float().cpu().numpy(),
        "std_in": std_in.float().cpu().numpy(),
        "mean_out": cuboid_points(l, h, w, yaw).reshape(1, out).astype(
            np.float32),
        "std_out": np.full((1, out), float(params["std_out"]), np.float32),
    }
    kstate = {k: v.contiguous() for k, v in kstate.items()}
    lstate = {k: v.contiguous() for k, v in lstate.items()}
    return kstate, lstate, ls_stats
