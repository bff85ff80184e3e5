"""The plain reference (``benchmark/reference/egonet_ref.py``) against
the port, stage by stage, in fp32 on the CPU at a shrunk width: the crop
affines, the bilinear samples, the keypoint model, the lifter and the
rigid solve each agree to rounding."""

import json
import os

import numpy as np
import torch

from benchmark import run, traffic, weights
from benchmark.reference import egonet_ref as ref
from benchmark.tests import tiny


def _setup(name="egonet_w32_ped", seed=7):
    with open(os.path.join(run.ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        cfg = tiny.shrink_config(json.load(f))
    with open(os.path.join(run.ROOT, "benchmark/traffic/offline_batch64_car.json")) as f:
        tr = tiny.shrink_traffic(json.load(f))
    wl = traffic.make(tr, seed, "cpu")
    items = wl.items([0, 1, 2, 3])
    hs, lst, ls_stats = weights.make(cfg, seed, "cpu", wl.frames, items)
    return cfg, wl, items, hs, lst, ls_stats


def test_stages_match_the_port():
    from egonet_tpu_torch.geometry import rigid
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.ops import affine
    cfg, wl, items, hs, lst, ls_stats = _setup()
    w, h = cfg["heatmapModel"]["input_size"]
    inv, crop_w = ref.crop_affines(items["box"], (h, w))
    mats = affine.crop_matrices_for_boxes(items["box"], (h, w), h / w, 1.1)
    np.testing.assert_allclose(inv, mats["inv"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(crop_w, mats["bbox_resize"][:, 2]
                               - mats["bbox_resize"][:, 0], rtol=1e-12)
    samples = ref.sample_crops(wl.frames, items["frame"], inv, (h, w))
    for i in (0, len(inv) - 1):
        port = affine.warp_affine(wl.frames[items["frame"][i]].float(),
                                  torch.as_tensor(inv[i]), (h, w))
        torch.testing.assert_close(samples[i], port, rtol=0, atol=1e-3)
    pth = cfg["dataset"]["pth_transform"]
    x = ref.normalize_crops(samples, pth["mean"], pth["std"])
    model = EgoNet({k: v for k, v in cfg.items()
                    if k not in ("weights", "limits")},
                   dtype=torch.float32, device="cpu")
    model.load_state(hs, lst, ls_stats)
    with torch.no_grad():
        _maps, coords = model.hrnet(x)
        torch.testing.assert_close(
            ref.keypoint_model(cfg).forward(hs, x, cfg), coords, rtol=0,
            atol=1e-5)
        z = torch.randn(5, cfg["FCModel"]["input_size"])
        torch.testing.assert_close(ref.lifter_forward(lst, z, cfg),
                                   model.lifter(z), rtol=1e-5, atol=1e-5)
    k3d = (weights.cuboid_points(3.9, 1.5, 1.7, 0.7)[None]
           + 0.05 * np.random.default_rng(0).normal(size=(6, 32, 3)))
    angles, _ = rigid.six_dof_from_cuboids(torch.as_tensor(k3d).float())
    R = ref.kabsch_rotation(ref.cuboid_template(k3d), k3d)
    np.testing.assert_allclose(ref.euler_xyz(R), angles.double().numpy(),
                               atol=2e-5)


def test_whole_reference_matches_the_port_fp32(monkeypatch):
    """The facade end to end in fp32, its warp's bf16 hat weights made
    fp32 too."""
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.ops import affine
    weights_of = affine._interp_weights
    monkeypatch.setattr(affine, "_interp_weights", lambda *a, **k: weights_of(
        *a, **dict(k, dtype=torch.float32)))
    cfg, wl, items, hs, lst, ls_stats = _setup()
    out = ref.run(wl.frames, items, hs, lst, ls_stats, cfg)
    model = EgoNet({k: v for k, v in cfg.items()
                    if k not in ("weights", "limits")},
                   dtype=torch.float32, device="cpu")
    model.load_state(hs, lst, ls_stats)
    frames = wl.frames_host()
    recs = model.forward_annot_dict({
        "path": [f"{s}" for s in range(4)], "images": frames[:4],
        "boxes": [wl.boxes[s] for s in range(4)], "K": [wl.K] * 4})
    k2 = np.concatenate([np.concatenate(recs[f"{s}"]["kpts_2d_pred"])
                         .reshape(-1, 33, 2) for s in range(4)])
    ry = np.concatenate([recs[f"{s}"]["euler_angles"][:, 1]
                         for s in range(4)])
    gap = np.abs(k2 - out["kpts_2d"]).max(axis=(1, 2)) / out["crop_w"]
    assert gap.max() < 1e-4
    assert np.degrees(np.abs(ry - out["euler"][:, 1])).max() < 1e-3
