"""Train the closed-loop gate's warm-start donors from scratch (port of
``tools/make_gate_artifacts.py``).

The gate (``tests/torch_gate.py``) fine-tunes small heatmap models from
donors instead of training them from scratch: the coordinate-readout
trunk of the 'coordinates' head has a long optimization plateau (~1k
steps), while a short fine-tune from a donor re-proves the whole
train -> checkpoint -> infer -> eval loop at high AOS.  This tool trains
those donors on a large synthetic world (``synthetic_world``: seed-3
scenes of 2 cars and 1 pedestrian) and writes into ``--out``:

    gate_hrnet_car.pth / .json    the shrunk HRNet donor (Car + Pedestrian)
    gate_native_car.pth / .json   the shrunk PoseNetTPU donor (Car)

each ``.pth`` with the keys, shapes and dtypes of the committed
``tests/data/gate_*.pth``, and each ``.json`` sidecar with the donor's
zero-shot val px on the gate's seed-7 world.  The committed files are
never written: pass ``donors={...}`` to the gate to run it on these.

    python -m egonet_tpu_torch.tools.make_gate_artifacts [--epochs 150] \\
        [--images 512] [--milestones 90 130] [--families hrnet tpu_native] \\
        [--out outputs/gate_donors] [--sidecar-only]

Trains on CUDA (raises without a card; ``main(..., device="cpu")`` runs on
the CPU) in fp32 with TF32 off: the coordinate readout needs full-precision
matmuls to generalize.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from egonet_tpu_torch.tools import synthetic_world as sw

# outputs/gate_donors/ of the checkout (git-ignored)
DEFAULT_OUT = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "outputs",
    "gate_donors"))
# (family, file name) of each donor
DONORS = (("hrnet", "gate_hrnet_car.pth"),
          ("tpu_native", "gate_native_car.pth"))


def donor_classes(backbone: str) -> tuple:
    """Training classes per donor family: the hrnet donor seeds both the
    Car and the Pedestrian gate legs, the native donor only the Car leg."""
    return ("Car", "Pedestrian") if backbone == "hrnet" else ("Car",)


def donor_config(backbone: str, root, milestones=None) -> dict:
    """The donor recipe's config: ``KITTI_train_IGRs.yml`` (its YAML-free
    copy, ``config.train_igrs_config()``: the card's host may lack PyYAML)
    on ``root`` with the family's classes, shrunk as the gate shrinks it,
    from no pretrained weights, under the gate's training stanza at the
    config's base LR with real decay ``milestones``."""
    from egonet_tpu_torch import config as tcfg
    cfg = tcfg.train_igrs_config()
    cfg["dataset"]["root"] = root
    # the hrnet donor warm-starts both the Car / W48 and the Ped / W32 legs,
    # and a Car-only donor does not transfer to pedestrians (zero-shot 46 px
    # on peds against 7.9 on cars)
    cfg["dataset"]["detect_classes"] = list(donor_classes(backbone))
    sw.gate_shrink(backbone)(cfg)
    cfg["heatmapModel"]["pretrained"] = ""
    sw.gate_train_stanza(cfg)
    cfg["optimizer"]["milestones"] = list(milestones or [100000])
    return cfg


def train_donor(backbone: str, root, epochs: int, seed: int = 0,
                milestones=None, device=None):
    """Train one family's donor (:func:`donor_config`) on the world at
    ``root`` in fp32, from the JAX package's initial values for ``seed``,
    the cross-ratio on from epoch 1.  Returns (state, {"losses": each
    epoch's last loss, "val_px": on the world's val half, "seconds"})."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.device import full_precision_fp32
    from egonet_tpu_torch.train.igrs import IGRTrainer

    full_precision_fp32()
    cfg = donor_config(backbone, root, milestones)
    classes = donor_classes(backbone)
    ds = kitti.KITTIDataset(cfg, "train")
    print(f"  [{backbone}] {len(ds.records)} train records "
          f"(classes {classes})", flush=True)
    # the scenes hold 2 cars + 1 ped; 6 images a batch must not drop
    # instances at the cap
    loader = IGRBatchLoader(ds.records, cfg, train=True,
                            max_instances=18 if len(classes) > 1 else 12,
                            seed=seed)
    trainer = IGRTrainer(cfg, steps_per_epoch=len(loader), device=device)
    state = trainer.init_state(seed)
    t0 = time.time()
    losses = []
    for ep in range(epochs):
        for batch in loader.epoch():
            state, metrics = trainer.train_step(state, batch,
                                                apply_cr=ep >= 1)
        losses.append(float(metrics["loss"]))
        if ep < 2 or ep % 10 == 9:
            print(f"  [{backbone}] epoch {ep}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    seconds = time.time() - t0
    first, last = losses[0], losses[-1]
    assert last < first * 0.5, (first, last)
    # transfer quality on the world's own val half
    vs = kitti.KITTIDataset(cfg, "valid")
    px = float(trainer.evaluate(state, vs.records[:20]).metrics[0].mean)
    print(f"  [{backbone}] val px {px:.2f} (AOS-grade needs < ~12)",
          flush=True)
    return state, {"losses": losses, "val_px": px, "seconds": seconds}


def write_sidecar(backbone: str, donor_path: str, device=None):
    """Measure the donor's zero-shot val px on the gate's probe world
    (``synthetic_world.make_gate_fixture``: fresh seed-7 scenes the donor
    never saw) and write it beside the donor as ``<name>.json``.  The gate
    holds the donor to it at setup.  Returns the sidecar dict."""
    import datetime

    with tempfile.TemporaryDirectory() as tmp:
        root, _ = sw.make_gate_fixture(tmp)
        px = sw.measure_donor_zero_shot(backbone, donor_path, root,
                                        device=device)
        side = {"val_px": round(px, 3),
                "probe": {"fixture": "egonet_tpu_torch.tools."
                                     "synthetic_world.make_gate_fixture",
                          "seed": sw.GATE_SEED,
                          "n_images": sw.GATE_N_IMAGES,
                          "metric": "JointDistance2DSIP val px, per class"},
                "date": datetime.date.today().isoformat()}
        if "Pedestrian" in donor_classes(backbone):
            side["val_px_ped"] = round(sw.measure_donor_zero_shot(
                backbone, donor_path, root, classes=("Pedestrian",),
                device=device), 3)
    out = donor_path[:-len(".pth")] + ".json"
    with open(out, "w") as f:
        json.dump(side, f, indent=1)
    print(f"wrote {out}: zero-shot val px {side['val_px']:.2f}"
          + (f" / ped {side['val_px_ped']:.2f}" if "val_px_ped" in side
             else ""), flush=True)
    return side


def main(argv=None, device=None) -> dict:
    """Run the tool; returns {family: {"donor", "sidecar", and, unless
    ``--sidecar-only``, "losses", "val_px", "seconds"}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--milestones", type=int, nargs="*", default=[90, 130])
    ap.add_argument("--sidecar-only", action="store_true",
                    help="skip training; (re)measure the donors in --out "
                         "and rewrite their sidecars")
    ap.add_argument("--families", nargs="*", default=["hrnet", "tpu_native"],
                    help="subset of donor families to (re)generate")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory the donors and sidecars are written to")
    args = ap.parse_args(argv)

    from egonet_tpu_torch.device import resolve_device
    from egonet_tpu_torch.io import checkpoint
    dev = resolve_device(device)
    if dev.type == "cuda":
        from egonet_tpu_torch.tools.bench import card_line
        card = card_line()
    else:
        card = "cpu"
    print(f"device: {card}", flush=True)
    donors = [(b, os.path.join(args.out, f)) for b, f in DONORS
              if b in args.families]
    out = {}
    if args.sidecar_only:
        for backbone, path in donors:
            out[backbone] = {"donor": path,
                             "sidecar": write_sidecar(backbone, path, dev)}
        return out
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(3)
        scenes = [sw.random_scene(rng, n_cars=2, n_peds=1)
                  for _ in range(args.images)]
        t0 = time.time()
        root, _ = sw.make_kitti_root(tmp, n_images=args.images,
                                     classes_per_image=scenes)
        print(f"world: {args.images} images in {time.time() - t0:.0f}s",
              flush=True)
        for backbone, path in donors:
            state, report = train_donor(backbone, root, args.epochs,
                                        milestones=args.milestones,
                                        device=dev)
            checkpoint.save_torch_state_dict(path, state.model)
            print(f"wrote {path} ({os.path.getsize(path) / 1e6:.2f} MB)",
                  flush=True)
            out[backbone] = {"donor": path, **report,
                             "sidecar": write_sidecar(backbone, path, dev)}
            print(json.dumps({"family": backbone, "device": card,
                              "epochs": args.epochs,
                              "images": args.images,
                              "train_s": report["seconds"],
                              "first_loss": report["losses"][0],
                              "last_loss": report["losses"][-1],
                              "val_px": report["val_px"],
                              "sidecar": out[backbone]["sidecar"]}),
                  flush=True)
    return out


if __name__ == "__main__":
    main()
