"""The from-scratch trained closed loop of both shrunk heatmap families,
scored by the official evaluator (port of the fixture and both tests of
``tests/test_trained_closed_loop.py``, the JAX package's golden metric).

For each family -- the reference-parity HRNet shrunk to widths 8/16/32/64,
and PoseNetTPU at depths (1, 1, 2), widths (16, 32, 64), head 48, stride 8
(``synthetic_world.gate_shrink``) -- the heatmap model trains from scratch
on a world of keypoint-drawn frames of 3 random cars each
(``synthetic_world.make_cars_world``; the first half trains, the second is
scored): ``KITTI_train_IGRs.yml`` with no donor, crops enlarged 1.32x (the
submission's 1.2 x 1.1) with scale and shift jitter, a constant rate,
batches of 6 frames and 16 instances, the cross-ratio on from epoch 1
(:func:`heatmap_config`, ``synthetic_world.train_heatmap``).  The lifter
(``synthetic_world.lifter_config``) trains once a run and serves both
families: its recipe and its world are the same for both, so the JAX
fixture, which trains it once per family, trains the same lifter twice
(each line says ``"lifter_shared": true``).  Training runs in fp32 with
TF32 off.

``HC.pth`` / ``L.pth`` / ``LS.npy`` then go through the inference CLI on the
detector-box path, batch 4 (:func:`inference_config`), once per leg
(``LEGS``): fp32, as the JAX test runs it (no fused kernel: the kernels
take bf16 only), and bf16 -- the HRNet family once through the tiled
kernel (``egonet::fused_basic_block``) and once through the stencil
(``EGONET_PALLAS_STENCIL=1``, ``egonet::fused_basic_block_stencil``),
PoseNetTPU (MBConv blocks, no BasicBlock) once.  Every leg is scored by
the port's evaluator and, where it builds, by the C++ one.

The bars are the JAX test's: the heatmap loss halves and the lifter's
falls to a third; on every leg AP_R11 easy > 99 and AOS_R11 easy at least
``--aos-min`` (85); the C++ AOS equal to the Python one within 1e-4.  On
the card each bf16 HRNet leg launches its kernel as many times as the
model routes blocks to it in a forward times its forwards, at least once,
and the other kernel never; on the CPU a wrapper runs its plain version
and counts no launch.

Prints one JSON line per family (the card's name and power limit, the
seconds of training and of each leg, AP / AOS per leg, launches per
forward per kernel), checks the bars after the last line, and returns the
lines::

    python -m egonet_tpu_torch.tools.trained_closed_loop \\
        [--families hrnet tpu_native] [--images 256] [--epochs 60] \\
        [--out DIR] [--aos-min 85]

Runs on CUDA (raises without a card); ``main(argv, device="cpu")`` runs on
the CPU.  ``--out DIR`` keeps the world, the checkpoints
(``DIR/<family>/ckpt``) and each leg's output (``DIR/<family>/<leg>``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

from egonet_tpu_torch.tools import synthetic_world as sw

# the JAX test's recipe and bars
N_IMAGES = 256                  # 128 train / 128 scored
CARS_PER_IMAGE = sw.CARS_PER_IMAGE
HC_EPOCHS = 60
AOS_EASY_MIN = 85.0
AP_EASY_MIN = 99.0
CPP_AOS_TOL = 1e-4

FAMILIES = ("hrnet", "tpu_native")
KERNELS = ("fused_basic_block", "fused_basic_block_stencil")
# (leg, bf16, EGONET_PALLAS_STENCIL, the fused kernel the leg runs)
LEGS = {"hrnet": (("fp32", False, "0", None),
                  ("tiled", True, "0", "fused_basic_block"),
                  ("stencil", True, "1", "fused_basic_block_stencil")),
        "tpu_native": (("fp32", False, "0", None),
                       ("bf16", True, "0", None))}


def heatmap_config(family, root):
    """The heatmap model's training config on ``root``, shrunk as
    ``family``."""
    from egonet_tpu_torch import config as tcfg
    cfg = tcfg.train_igrs_config()
    cfg["dataset"]["root"] = root
    sw.gate_shrink(family)(cfg)
    cfg["heatmapModel"]["pretrained"] = ""
    sw.gate_train_stanza(cfg)
    # training crops aligned with the submission crop chain (1.2 x 1.1 ==
    # one 1.32x enlargement)
    cfg["dataset"]["enlarge_factor"] = 1.32
    return cfg


def inference_config(family, root, pred_dir, ckpt_dir, out_dir, fc_model,
                     device, bf16):
    """The inference CLI's config for ``family``'s checkpoints in
    ``ckpt_dir``: the shipped demo config, shrunk, on the detector-box path
    only, batch 4."""
    from egonet_tpu_torch import config as tcfg
    cfg = tcfg.demo_config()
    cfg["dataset"]["root"] = root
    sw.gate_shrink(family)(cfg)
    cfg["heatmapModel"]["init_weights"] = False
    cfg["FCModel"] = dict(fc_model)
    cfg["dirs"] = {"output": out_dir, "ckpt": ckpt_dir,
                   "load_prediction_file": pred_dir}
    cfg.update(pre_trained=True, bf16=bool(bf16), use_gt_box=False,
               device=str(device))
    cfg["testing_settings"]["batch_size"] = 4
    return cfg


def fused_blocks(family, stencil):
    """How many blocks of ``family``'s shrunk bf16 model the chosen kernel
    runs in a forward, from the model's own routing (built on the meta
    device); PoseNetTPU has none."""
    if family != "hrnet":
        return 0
    from egonet_tpu_torch import config as tcfg
    from egonet_tpu_torch.models.hrnet import build_hrnet
    cfg = sw.gate_shrink("hrnet")(tcfg.demo_config())
    with torch.device("meta"):
        net = build_hrnet(cfg, dtype=torch.bfloat16)
    return sum(1 for _ in net._fusable_blocks(stencil))


def run_leg(cfg, stencil):
    """The inference CLI on ``cfg`` with EGONET_PALLAS_STENCIL=``stencil``,
    both kernels' launch counts set to 0 before it.  Returns (seconds,
    {kernel: launches}, HRNet forwards)."""
    from egonet_tpu_torch.models.hrnet import PoseHighResolutionNet
    from egonet_tpu_torch.ops import fused_block as fb
    from egonet_tpu_torch.ops import fused_block_stencil as st
    from egonet_tpu_torch.tools import inference
    kernels = {"fused_basic_block": fb.fused_basic_block,
               "fused_basic_block_stencil": st.fused_basic_block_stencil}
    forwards = [0]

    def count(module, _args):
        if isinstance(module, PoseHighResolutionNet):
            forwards[0] += 1
    for k in kernels.values():
        k.launches = 0
    old = os.environ.get("EGONET_PALLAS_STENCIL")
    os.environ["EGONET_PALLAS_STENCIL"] = stencil
    hook = torch.nn.modules.module.register_module_forward_pre_hook(count)
    t0 = time.perf_counter()
    try:
        inference.main(cfgs=cfg)
    finally:
        hook.remove()
        if old is None:
            os.environ.pop("EGONET_PALLAS_STENCIL")
        else:
            os.environ["EGONET_PALLAS_STENCIL"] = old
    seconds = time.perf_counter() - t0
    return seconds, {n: k.launches for n, k in kernels.items()}, forwards[0]


def score(label_dir, sub_dir, binary):
    """(AP_R11, AOS_R11) of the car class, easy, by the port's evaluator,
    and the C++ evaluator's AOS_R11 easy (None without its binary)."""
    from egonet_tpu_torch.eval import kitti_eval as ke
    easy = ke.evaluate(label_dir, sub_dir, metrics=("image",),
                       write_stats=False)["car"]["image"]["easy"]
    cpp = None
    if binary is not None:
        out = subprocess.check_output([binary, label_dir, sub_dir],
                                      timeout=300).decode()
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("car_orientation AP_R11"))
        cpp = float(line.split(":")[1].split()[0])
    return easy["ap_r11"], easy["aos_r11"], cpp


def run_family(family, args, world, lifter, device, binary, out, card):
    """Train ``family``'s heatmap model, write its checkpoints beside the
    shared lifter's, and run and score every leg.  Returns its line."""
    from egonet_tpu_torch.io import checkpoint
    root, pred_dir, label_dir = world
    cfg = heatmap_config(family, root)
    t0 = time.perf_counter()
    state, losses = sw.train_heatmap(cfg, args.epochs, device)
    train_s = time.perf_counter() - t0
    ck = os.path.join(out, family, "ckpt")
    checkpoint.save_torch_state_dict(os.path.join(ck, "HC.pth"), state.model)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for name in ("L.pth", "LS.npy"):
        shutil.copyfile(os.path.join(lifter["dir"], name),
                        os.path.join(ck, name))
    line = {"family": family, "images": args.images, "epochs": args.epochs,
            "ap_r11_easy": {}, "aos_r11_easy": {}, "cpp_aos_r11_easy": {},
            "launches_per_forward": {}, "launches": {},
            "heatmap_loss": [losses[0], losses[-1]],
            "lifter_loss": lifter["loss"], "lifter_shared": True,
            "train_s": train_s, "lifter_s": lifter["seconds"],
            "infer_s": {}}
    for leg, bf16, stencil, kernel in LEGS[family]:
        icfg = inference_config(family, root, pred_dir, ck,
                                os.path.join(out, family, leg),
                                lifter["fc"], device, bf16)
        seconds, launches, forwards = run_leg(icfg, stencil)
        ap, aos, cpp = score(label_dir, os.path.join(out, family, leg,
                                                     "submission"), binary)
        line["ap_r11_easy"][leg] = ap
        line["aos_r11_easy"][leg] = aos
        line["cpp_aos_r11_easy"][leg] = cpp
        line["infer_s"][leg] = seconds
        line["launches"][leg] = {
            "forwards": forwards, **launches,
            "routed_per_forward": fused_blocks(family, stencil == "1")
            if kernel else 0}
        if kernel:
            line["launches_per_forward"][kernel] = launches[kernel] / max(
                forwards, 1)
    line["device"] = card
    return line


def check(line, device, aos_min):
    """The bars of one family's legs (raises AssertionError); the loss
    bars hold already (``synthetic_world.train_heatmap`` /
    ``train_lifter``)."""
    fam = line["family"]
    bad = []
    for leg, _bf16, _stencil, kernel in LEGS[fam]:
        ap, aos = line["ap_r11_easy"][leg], line["aos_r11_easy"][leg]
        cpp = line["cpp_aos_r11_easy"][leg]
        if not ap > AP_EASY_MIN:
            bad.append(f"{leg}: AP_R11 easy {ap} <= {AP_EASY_MIN}")
        if not aos >= aos_min:
            bad.append(f"{leg}: AOS_R11 easy {aos} < {aos_min}")
        if cpp is not None and not abs(cpp - aos) <= CPP_AOS_TOL:
            bad.append(f"{leg}: C++ AOS {cpp} != Python {aos}")
        n = line["launches"][leg]
        want = dict.fromkeys(KERNELS, 0)
        if kernel and device.type == "cuda":
            want[kernel] = n["routed_per_forward"] * n["forwards"]
            if not want[kernel] > 0:
                bad.append(f"{leg}: no {kernel} launch ({n})")
        got = {k: n[k] for k in KERNELS}
        if got != want:
            bad.append(f"{leg}: launches {got}, expected {want}")
    if bad:
        raise AssertionError(f"{fam}: " + "; ".join(bad))


def main(argv=None, device=None) -> list:
    """Run the loop; returns the printed lines as dicts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", nargs="+", choices=FAMILIES,
                    default=list(FAMILIES))
    ap.add_argument("--images", type=int, default=N_IMAGES)
    ap.add_argument("--epochs", type=int, default=HC_EPOCHS)
    ap.add_argument("--out", help="keep the world, checkpoints and "
                                  "submissions here (default: a temporary "
                                  "directory)")
    ap.add_argument("--aos-min", type=float, default=AOS_EASY_MIN,
                    help="AOS_R11 easy every leg must reach")
    args = ap.parse_args(argv)

    from egonet_tpu_torch.device import full_precision_fp32, resolve_device
    from egonet_tpu_torch.eval.native import ensure_evaluator
    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.ops import _build
    dev = resolve_device(device)
    full_precision_fp32()
    if dev.type == "cuda":
        from egonet_tpu_torch.tools.bench import card_line
        card = card_line()
        # both kernels and the operators first, so that no leg's seconds
        # hold a build
        _build.build(_build.ops_libs("cuda"))
    else:
        card = "cpu"
    print(f"device: {card}", flush=True)
    binary = ensure_evaluator()
    with contextlib.ExitStack() as stack:
        out = args.out or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="trained_loop_"))
        root, pred_dir = sw.make_cars_world(os.path.join(out, "world"),
                                            args.images)
        world = (root, pred_dir, os.path.join(root, "training", "label_2"))
        t0 = time.perf_counter()
        lstate, lcfg, train_set, lhist = sw.train_lifter(root, dev)
        lifter = {"dir": os.path.join(out, "lifter"), "fc": lcfg["FCModel"],
                  "seconds": time.perf_counter() - t0,
                  "loss": [lhist[0]["loss"], lhist[-1]["loss"]]}
        checkpoint.save_torch_state_dict(
            os.path.join(lifter["dir"], "L.pth"), lstate.model)
        checkpoint.save_lifter_stats(os.path.join(lifter["dir"], "LS.npy"),
                                     train_set.statistics)
        lines = []
        for family in args.families:
            lines.append(run_family(family, args, world, lifter, dev, binary,
                                    out, card))
            print(json.dumps(lines[-1]), flush=True)
    for line in lines:
        check(line, dev, args.aos_min)
    return lines


if __name__ == "__main__":
    main()
