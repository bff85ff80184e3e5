"""Closed-loop accuracy of the shipped full-width PoseNetTPU, trained from
scratch (port of ``tools/record_native_fullwidth.py``).

The gate trains a shrunk PoseNetTPU (widths 16/32/64); this tool runs the
same train -> checkpoint -> inference CLI -> evaluator loop at the width
users run (``KITTI_tpu_native.yml``: depths [1, 3, 9], widths
[256, 512, 1024], head 128, stride-8 grid, 256x256 crops) on a synthetic
world of keypoint-drawn frames with 3 cars each (``synthetic_world``,
seed 3), and prints the official AOS beside the AP as one JSON line at the
end: the JAX tool's keys (``family``, ``config``, ``epochs``, ``images``,
``ap_r11_easy``, ``aos_r11_easy``), the card (``device``: name and power
limit) and the seconds of training (``train_s`` the heatmap model,
``lifter_s`` the lifter).

    python -m egonet_tpu_torch.tools.record_native_fullwidth [--epochs 60] \\
        [--images 256]

Trains and infers on CUDA in fp32 with TF32 off (raises without a card);
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from egonet_tpu_torch.tools import synthetic_world as sw


def main(argv=None, device=None) -> dict:
    """Run the loop; returns the printed line as a dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--images", type=int, default=256)
    args = ap.parse_args(argv)

    from egonet_tpu_torch import config as tcfg
    from egonet_tpu_torch.device import full_precision_fp32, resolve_device
    from egonet_tpu_torch.eval import kitti_eval as ke
    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.tools import inference
    dev = resolve_device(device)
    full_precision_fp32()
    if dev.type == "cuda":
        from egonet_tpu_torch.tools.bench import card_line
        card = card_line()
    else:
        card = "cpu"
    print(f"device: {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="native_fw_") as tmp:
        root, pred_dir = sw.make_cars_world(tmp, args.images)

        # ---- heatmap model: the shipped config, backbone verbatim -------
        cfg = tcfg.tpu_native_config()
        cfg["dataset"]["root"] = root
        sw.gate_train_stanza(cfg)     # crop chain aligned with submission
        t0 = time.time()
        state, _losses = sw.train_heatmap(cfg, args.epochs, dev)
        train_s = time.time() - t0
        ck = os.path.join(tmp, "ckpt")
        checkpoint.save_torch_state_dict(os.path.join(ck, "HC.pth"),
                                         state.model)
        del state

        # ---- lifter -----------------------------------------------------
        t0 = time.time()
        lstate, lcfg, train_set, _lhist = sw.train_lifter(root, dev)
        lifter_s = time.time() - t0
        checkpoint.save_torch_state_dict(os.path.join(ck, "L.pth"),
                                         lstate.model)
        checkpoint.save_lifter_stats(os.path.join(ck, "LS.npy"),
                                     train_set.statistics)

        # ---- the product path: inference CLI + evaluator ----------------
        icfg = tcfg.demo_config()
        icfg["dataset"]["root"] = root
        icfg["heatmapModel"] = dict(cfg["heatmapModel"])
        icfg["heatmapModel"]["init_weights"] = False
        icfg["heatmapModel"]["jitter_bbox"] = False
        icfg["heatmapModel"]["augment_input"] = False
        icfg["FCModel"] = dict(lcfg["FCModel"])
        icfg["dirs"] = {"output": os.path.join(tmp, "out"), "ckpt": ck,
                        "load_prediction_file": pred_dir}
        icfg.update(pre_trained=True, bf16=False, use_gt_box=False,
                    device=str(dev))
        icfg["testing_settings"]["batch_size"] = 4
        inference.main(cfgs=icfg)

        label_dir = os.path.join(root, "training", "label_2")
        res = ke.evaluate(label_dir, os.path.join(tmp, "out", "submission"),
                          write_stats=False)
    easy = res["car"]["image"]["easy"]
    line = {"family": "tpu_native_fullwidth",
            "config": "KITTI_tpu_native.yml",
            "epochs": args.epochs, "images": args.images,
            "ap_r11_easy": round(easy["ap_r11"], 2),
            "aos_r11_easy": round(easy["aos_r11"], 2),
            "device": card, "train_s": train_s, "lifter_s": lifter_s}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
