"""What the benchmark's drivers share: the run's context, the program
under test built from a configuration and seeded weights, and the
answers a driver hands to the comparison."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from benchmark import traffic as traffic_mod
from benchmark import weights

# configuration keys that belong to the benchmark, not to the program
HARNESS_KEYS = ("source", "about", "reduced", "weights", "limits")


@dataclasses.dataclass
class Context:
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float              # time.monotonic() when the run began
    control: bool = False       # the program's int8 activation path

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    """What a driver measured and what it hands to the comparison."""
    e2e: dict                   # end-to-end metric name -> value
    window_s: float
    crops: int                  # real crops completed in the window
    attempted: int
    failed: int
    missing: int                # answers due that never came or are wrong
    port: dict                  # sampled answers of the program
    items: dict                 # their crops ({'frame', 'box', 'K'})
    frames: list                # host frames the items index
    weights: tuple              # the seeded (keypoint, lifter, LS) states, on
    #                             the host: what the reference is handed
    trace: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0


def program_config(ctx: Context) -> dict:
    """The configuration as the program reads it."""
    cfg = {k: copy.deepcopy(v) for k, v in ctx.cfg.items()
           if k not in HARNESS_KEYS}
    if ctx.control:
        cfg["heatmapModel"]["act_quant"] = "int8"
    return cfg


def prepare(ctx: Context):
    """(workload, keypoint_state, lifter_state, ls_stats): the traffic's
    frames and boxes and the seeded, calibrated weights, made on the run's
    device."""
    wl = traffic_mod.make(ctx.traffic, ctx.seed, ctx.device)
    slots = [s for g in wl.groups for s in g]
    items = wl.items(slots)
    n = int(ctx.traffic["calibration_crops"])
    calib = {k: v[:n] for k, v in items.items()}
    hs, lst, ls_stats = weights.make(ctx.cfg, ctx.seed, ctx.device,
                                     wl.frames, calib)
    return wl, hs, lst, ls_stats


def build_model(ctx: Context, hs, lst, ls_stats):
    """(the program's facade with its default (tiled) kernel and the
    seeded weights, the weights moved to the host for the reference)."""
    from egonet_tpu_torch.config import config_dtype
    from egonet_tpu_torch.models.egonet import EgoNet
    cfg = program_config(ctx)
    model = EgoNet(cfg, dtype=config_dtype(cfg), device=ctx.device)
    if ctx.control and getattr(model.hrnet, "act_quant", None) != "int8":
        # a control at full precision would read as the program does
        raise SystemExit(f"--control: the keypoint model "
                         f"{type(model.hrnet).__name__} did not take "
                         "act_quant 'int8'")
    model.prepare_inference(stencil="0")
    model.load_state(hrnet_state=hs, lifter_state=lst, ls_stats=ls_stats)
    kept = ({k: v.cpu() for k, v in hs.items()},
            {k: v.cpu() for k, v in lst.items()}, ls_stats)
    return model, kept


def answers_of_record(rec: dict) -> tuple:
    """A facade record's per-crop answers: (kpts_2d [n, K, 2], kpts_3d
    [n, P, 3], euler [n, 3], alpha [n])."""
    k2 = np.stack([np.asarray(v, np.float64).reshape(-1, 2)
                   for v in rec["kpts_2d_pred"]]) if len(
                       rec["kpts_2d_pred"]) else np.zeros((0, 1, 2))
    return (k2, np.asarray(rec["kpts_3d_pred"], np.float64),
            np.asarray(rec["euler_angles"], np.float64),
            np.asarray(rec["alphas"], np.float64))


def stack_answers(rows: list) -> dict:
    """[(kpts_2d, kpts_3d, euler, alpha) of one crop] -> arrays."""
    return {"kpts_2d": np.stack([r[0] for r in rows]),
            "kpts_3d": np.stack([r[1] for r in rows]),
            "euler": np.stack([r[2] for r in rows]),
            "alpha": np.asarray([r[3] for r in rows], np.float64)}


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``n`` indices, drawn from the run's seed, in order."""
    rng = np.random.default_rng([int(seed), 2])
    return np.sort(rng.choice(n, size=min(n, k), replace=False))
