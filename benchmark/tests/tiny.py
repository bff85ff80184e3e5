"""A checkout-shaped directory holding the benchmark's cells at a size a
CPU test run can hold: the same ``BENCHMARK.json``, each configuration's
keypoint model cut by its family's ``shrink`` (HRNet: widths 8/16/32/64,
one block a branch and one module a stage at 64x64 crops, 16x16
heatmaps), a 64-wide lifter, each mix cut to a few frames."""

from __future__ import annotations

import json
import os

from benchmark import run
from benchmark.reference import egonet_ref as ref

# limits of the comparison at this size (the chip's are in the
# configuration files), from CPU readings over seeds 1-6 of the three
# cells: the program's widest kpts_2d gap 0.088 (its int8
# control's narrowest 0.240), kpts_3d_m 0.028, ry_deg 0.250, alpha_deg
# 0.565.  At this size the control fails by kpts_2d alone.
TINY_LIMITS = {"missing": 0, "kpts_2d": 0.15, "kpts_3d_m": 0.06,
               "ry_deg": 0.5, "alpha_deg": 1.2}


def shrink_config(cfg: dict) -> dict:
    ref.keypoint_model(cfg).shrink(cfg)
    cfg["FCModel"]["num_neurons"] = 64
    cfg["limits"] = dict(TINY_LIMITS)
    return cfg


def shrink_traffic(traffic: dict) -> dict:
    traffic["frame_hw"] = [96, 320]
    traffic["K"] = [[180.0, 0.0, 160.0], [0.0, 180.0, 48.0],
                    [0.0, 0.0, 1.0]]
    traffic["objects"]["height_px"] = [12.0, 80.0]
    traffic["objects"]["center_row"] = 48.0
    traffic["working_set_frames"] = 4
    if "frames_per_dispatch" in traffic:
        traffic["frames_per_dispatch"] = min(
            2, traffic["frames_per_dispatch"])
    traffic["calibration_crops"] = 8
    traffic["compare_crops"] = 12
    traffic["trace_seconds"] = 0.5
    return traffic


def make_root(tmp: str) -> str:
    """Write the tiny checkout under ``tmp``; returns its path."""
    root = os.path.join(tmp, "tiny")
    spec = run.load_spec()
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for conf in spec["configs"]:
        with open(os.path.join(run.ROOT, conf["file"])) as f:
            cfg = shrink_config(json.load(f))
        path = os.path.join(root, conf["file"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for cell in spec["workloads"]:
        name = cell["traffic"] + ".json"
        with open(os.path.join(run.ROOT, "benchmark", "traffic", name)) as f:
            tr = shrink_traffic(json.load(f))
        with open(os.path.join(root, "benchmark", "traffic", name), "w") as f:
            json.dump(tr, f)
    return root
