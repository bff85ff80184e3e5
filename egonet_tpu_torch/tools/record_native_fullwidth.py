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

import numpy as np

from egonet_tpu_torch.tools import synthetic_world as sw


def _train_heatmap(cfg, epochs, device):
    """The IGR model trained from the JAX package's seed-0 initial values,
    the cross-ratio on from epoch 1; returns its train state."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.train.igrs import IGRTrainer
    ds = kitti.KITTIDataset(cfg, "train")
    loader = IGRBatchLoader(ds.records, cfg, train=True, max_instances=16,
                            seed=0)
    trainer = IGRTrainer(cfg, steps_per_epoch=len(loader), device=device)
    state = trainer.init_state(0)
    t0 = time.time()
    first = last = None
    for ep in range(epochs):
        for batch in loader.epoch():
            state, metrics = trainer.train_step(state, batch,
                                                apply_cr=ep >= 1)
        last = float(metrics["loss"])
        first = first if first is not None else last
        if ep < 2 or ep % 10 == 9:
            print(f"epoch {ep}: loss {last:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
    assert last < first * 0.5, (first, last)
    return state


def _train_lifter(root, device):
    """The lifter (66 -> 96, 256 neurons, x40 pose augmentation, 150
    epochs); returns (state, its config, the training set)."""
    from egonet_tpu_torch import config as tcfg
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.train.lifting import LiftingTrainer
    lcfg = tcfg.train_lifting_config()
    lcfg["dataset"]["root"] = root
    lcfg["training_settings"].update({"total_epochs": 150,
                                      "batch_size": 128,
                                      "lft_aug_times": 40})
    lcfg["FCModel"].update({"input_size": 66, "output_size": 96,
                            "num_neurons": 256, "dropout": 0.0})
    lcfg["optimizer"]["milestones"] = [60, 100]
    train_set, _valid = kitti.prepare_data(lcfg)
    lt = LiftingTrainer(lcfg,
                        steps_per_epoch=max(1, len(train_set.input) // 128),
                        device=device)
    lstate, lhist = lt.fit(train_set)
    assert lhist[-1]["loss"] < lhist[0]["loss"] * 0.33
    return lstate, lcfg, train_set


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
        rng = np.random.RandomState(3)
        scenes = [sw.random_cars(rng, 3) for _ in range(args.images)]
        root, pred_dir = sw.make_kitti_root(
            tmp, n_images=args.images, with_predictions=True,
            classes_per_image=scenes)

        # ---- heatmap model: the shipped config, backbone verbatim -------
        cfg = tcfg.tpu_native_config()
        cfg["dataset"]["root"] = root
        sw.gate_train_stanza(cfg)     # crop chain aligned with submission
        t0 = time.time()
        state = _train_heatmap(cfg, args.epochs, dev)
        train_s = time.time() - t0
        ck = os.path.join(tmp, "ckpt")
        checkpoint.save_torch_state_dict(os.path.join(ck, "HC.pth"),
                                         state.model)
        del state

        # ---- lifter -----------------------------------------------------
        t0 = time.time()
        lstate, lcfg, train_set = _train_lifter(root, dev)
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
