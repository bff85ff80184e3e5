"""The port's synthetic KITTI world: keypoint-drawn frames with labels,
calibrations, splits and detector txts, plus the closed-loop gate's
recipes (its world, shrink and training stanza) and the donor probe.

The from-scratch tools (``make_gate_artifacts``,
``record_native_fullwidth``, ``trained_closed_loop``) train on it with the
recipes below, and the gate
(``tests/torch_gate.py``) fine-tunes and scores on it.  It writes the same
files as the JAX package's test fixture (``tests/fixtures.py``): the
same scenes, label lines, calibrations, splits and detector txts byte for
byte, and frames of the same pixels (PNGs from the port's writer; the
fixture's cv2 stores its drawing's channels as BGR, so they are reversed
here).  The key points are drawn as ``cv2.circle`` fills its discs,
without cv2: the card's host need not have it.
"""

from __future__ import annotations

import colorsys
import os
import time

import numpy as np

K_FIXED = np.array([[707.0493, 0.0, 604.0814],
                    [0.0, 707.0493, 180.5066],
                    [0.0, 0.0, 1.0]], dtype=np.float64)

T_SHIFT = np.array([44.857, 0.216, 0.0027])

IMG_W, IMG_H = 1242, 375


def _projected_bbox(dims, loc, ry):
    """2D box from projecting the 8 cuboid corners."""
    h, w, l = dims
    # bottom-centered canonical corners
    xs = np.array([l, l, l, l, 0, 0, 0, 0]) - l / 2
    ys = np.array([0, h, 0, h, 0, h, 0, h]) - h
    zs = np.array([w, w, 0, 0, w, w, 0, 0]) - w / 2
    c, s = np.cos(ry), np.sin(ry)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pts = R @ np.vstack([xs, ys, zs]) + np.asarray(loc).reshape(3, 1)
    pts = pts + (np.linalg.inv(K_FIXED) @ T_SHIFT).reshape(3, 1)
    proj = K_FIXED @ pts
    u = proj[0] / proj[2]
    v = proj[1] / proj[2]
    return (float(np.clip(u.min(), 0, IMG_W - 1)),
            float(np.clip(v.min(), 0, IMG_H - 1)),
            float(np.clip(u.max(), 0, IMG_W - 1)),
            float(np.clip(v.max(), 0, IMG_H - 1)))


def _rec(cls, alpha, dims, loc, ry, trunc=0.0, occ=0):
    return (cls, trunc, occ, alpha, _projected_bbox(dims, loc, ry),
            dims, loc, ry)


# (class, truncation, occlusion, alpha, bbox, (h, w, l), (x, y, z), ry)
CARS = [
    _rec("Car", -1.58, (1.48, 1.60, 3.69), (-2.11, 1.94, 13.4), -1.73),
    _rec("Car", 1.85, (1.50, 1.62, 3.88), (-8.1, 1.90, 19.3), 1.46, occ=0),
    _rec("Car", -1.65, (1.40, 1.51, 3.70), (2.4, 1.85, 21.2), -1.55, occ=1),
]
PEDS = [
    _rec("Pedestrian", 0.4, (1.78, 0.6, 0.9), (4.2, 1.7, 15.5), 0.6),
]


def wrap_angle(a: float) -> float:
    return float(np.arctan2(np.sin(a), np.cos(a)))


def random_cars(rng, n=3, z_range=(8.0, 22.0)):
    """Randomized, non-overlapping car records with KITTI-consistent alpha
    (= ry - atan2(x, z)); z <= 22 m keeps boxes > 40 px tall, i.e. 'easy'
    difficulty for the evaluator."""
    recs = []
    # separated lateral slots so instances (and their drawn keypoints)
    # don't overlap in the image
    slots = np.linspace(-7.0, 7.0, n + 1)
    for i in range(n):
        dims = (rng.uniform(1.40, 1.60), rng.uniform(1.50, 1.70),
                rng.uniform(3.5, 4.2))                       # h, w, l
        x = rng.uniform(slots[i] + 1.0, slots[i + 1] - 1.0)
        z = rng.uniform(*z_range)
        y = 1.65 + rng.uniform(-0.05, 0.05)
        ry = rng.uniform(-np.pi, np.pi)
        alpha = wrap_angle(ry - np.arctan2(x, z))
        recs.append(_rec("Car", alpha, dims, (x, y, z), ry))
    return recs


def random_scene(rng, n_cars=2, n_peds=1, z_range=(8.0, 20.0),
                 ped_z_range=(7.0, 12.0)):
    """Randomized mixed Car+Pedestrian scene with KITTI-consistent alpha.
    Instances occupy disjoint lateral slots so their drawn keypoints never
    overlap; z <= 20 m keeps everything 'easy' difficulty.  Pedestrians
    get their own nearer depth range: a 0.5-0.7 m-wide pedestrian at
    z = 20 m projects ~16 px wide, so its 33 keypoint dots alias into each
    other after the crop downscale and its orientation cannot be read from
    the pixels."""
    n = n_cars + n_peds
    recs = []
    slots = np.linspace(-7.0, 7.0, n + 1)
    order = rng.permutation(n)
    for i in range(n):
        is_car = order[i] < n_cars
        if is_car:
            dims = (rng.uniform(1.40, 1.60), rng.uniform(1.50, 1.70),
                    rng.uniform(3.5, 4.2))                    # h, w, l
        else:
            dims = (rng.uniform(1.65, 1.85), rng.uniform(0.5, 0.7),
                    rng.uniform(0.8, 1.0))
        x = rng.uniform(slots[i] + 1.0, slots[i + 1] - 1.0)
        z = rng.uniform(*(z_range if is_car else ped_z_range))
        y = 1.65 + rng.uniform(-0.05, 0.05)
        ry = rng.uniform(-np.pi, np.pi)
        alpha = wrap_angle(ry - np.arctan2(x, z))
        recs.append(_rec("Car" if is_car else "Pedestrian", alpha, dims,
                         (x, y, z), ry))
    return recs


def _disc(img, cx, cy, r, color):
    """A filled disc as ``cv2.circle(img, (cx, cy), r, color, -1)`` draws
    it (8-connected, no shift: OpenCV's integer midpoint walk, each step
    filling four horizontal spans, clipped to the image)."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_instance_keypoints(img, recs):
    """Each instance's 33 projected cuboid keypoints as discs, one hue per
    keypoint index, the radius scaled with the box height so the dots
    survive the crop's downscale to the model input: the geometry the
    heatmap model learns to read from the pixels."""
    from egonet_tpu_torch.data import cuboid as cb
    shift = (np.linalg.inv(K_FIXED) @ T_SHIFT).reshape(3, 1)
    for _cls, _t, _o, _a, bbox, (h, w, l), loc, ry in recs:
        r = int(np.clip(round((bbox[3] - bbox[1]) / 24.0), 2, 8))
        pts = cb.construct_box_3d(l, h, w)                   # [3, 33]
        placed = cb.place_cuboid(pts, np.array([*loc, 0.0, ry, 0.0]), shift)
        proj = cb.project_3d_to_2d(placed, K_FIXED)          # [3, 33]
        for k in range(proj.shape[1]):
            u, v = int(round(proj[0, k])), int(round(proj[1, k]))
            if 0 <= u < IMG_W and 0 <= v < IMG_H:
                col = tuple(int(255 * c) for c in
                            colorsys.hsv_to_rgb(k / 33.0, 1.0, 1.0))
                _disc(img, u, v, r, col)
    return img


def _label_line(rec, score=None):
    cls, trunc, occ, alpha, bbox, dims, loc, ry = rec
    s = (f"{cls} {trunc:.2f} {occ} {alpha:.2f} "
         f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} "
         f"{dims[0]:.2f} {dims[1]:.2f} {dims[2]:.2f} "
         f"{loc[0]:.2f} {loc[1]:.2f} {loc[2]:.2f} {ry:.2f}")
    if score is not None:
        s += f" {score:.4f}"
    return s


def make_kitti_root(tmpdir, n_images=2, with_predictions=False,
                    classes_per_image=None):
    """A KITTI-layout directory of ``n_images`` keypoint-drawn frames of
    375x1242 (``classes_per_image[i]``'s instances, else ``CARS``), with
    labels, calibrations and the train / val / trainval splits (the first
    half trains); with ``with_predictions``, detector txts beside it (the
    GT boxes with a score ladder).  Returns (root, prediction dir or
    None)."""
    from egonet_tpu_torch.data import png
    root = os.path.join(str(tmpdir), "KITTI")
    train = os.path.join(root, "training")
    for sub in ("image_2", "label_2", "calib", "ImageSets"):
        os.makedirs(os.path.join(train, sub), exist_ok=True)
    names = [f"{i:06d}" for i in range(n_images)]
    scenes = [classes_per_image[i] if classes_per_image else CARS
              for i in range(n_images)]
    p_line = "P2: " + " ".join(str(v) for v in np.hstack(
        [K_FIXED, T_SHIFT.reshape(3, 1)]).reshape(-1))
    for name, recs in zip(names, scenes):
        img = np.full((IMG_H, IMG_W, 3), 60, dtype=np.uint8)
        draw_instance_keypoints(img, recs)
        with open(os.path.join(train, "image_2", name + ".png"), "wb") as f:
            f.write(png.encode(np.ascontiguousarray(img[..., ::-1])))
        with open(os.path.join(train, "label_2", name + ".txt"), "w") as f:
            f.write("\n".join(_label_line(r) for r in recs) + "\n")
        with open(os.path.join(train, "calib", name + ".txt"), "w") as f:
            f.write("P0: " + " ".join(["0"] * 12) + "\n")
            f.write("P1: " + " ".join(["0"] * 12) + "\n")
            f.write(p_line + "\n")
            f.write("P3: " + " ".join(["0"] * 12) + "\n")
    half = max(1, n_images // 2)
    for split, part in (("train", names[:half]),
                        ("val", names[half:] if n_images > 1 else names),
                        ("trainval", names)):
        with open(os.path.join(train, "ImageSets", split + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    pred_dir = None
    if with_predictions:
        pred_dir = os.path.join(str(tmpdir), "preds")
        os.makedirs(pred_dir, exist_ok=True)
        for name, recs in zip(names, scenes):
            with open(os.path.join(pred_dir, name + ".txt"), "w") as f:
                f.write("\n".join(_label_line(r, score=0.9 - 0.1 * j)
                                  for j, r in enumerate(recs)) + "\n")
    return root, pred_dir


# --------------------------------------------------------------------------
# The from-scratch closed loops' world and training recipes
# (``record_native_fullwidth``, ``trained_closed_loop``): the JAX package's
# trained-loop fixture (tests/test_trained_closed_loop.py) and its
# full-width tool train the same way.
# --------------------------------------------------------------------------

CARS_SEED = 3
CARS_PER_IMAGE = 3


def make_cars_world(tmpdir, n_images):
    """``n_images`` keypoint-drawn frames of ``CARS_PER_IMAGE`` random cars
    each (``random_cars`` on ``RandomState(CARS_SEED)``), with detector
    txts.  Returns (root, pred_dir)."""
    rng = np.random.RandomState(CARS_SEED)
    scenes = [random_cars(rng, CARS_PER_IMAGE) for _ in range(n_images)]
    return make_kitti_root(tmpdir, n_images=n_images, with_predictions=True,
                           classes_per_image=scenes)


def train_heatmap(cfg, epochs, device):
    """The IGR model of ``cfg`` trained from the JAX package's seed-0
    initial values (loader seed 0, 16 instances a batch), the cross-ratio
    on from epoch 1; asserts that the last epoch's loss is under half the
    first's.  Returns (its train state, each epoch's last loss)."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.train.igrs import IGRTrainer
    ds = kitti.KITTIDataset(cfg, "train")
    loader = IGRBatchLoader(ds.records, cfg, train=True, max_instances=16,
                            seed=0)
    trainer = IGRTrainer(cfg, steps_per_epoch=len(loader), device=device)
    state = trainer.init_state(0)
    t0 = time.time()
    losses = []
    for ep in range(epochs):
        for batch in loader.epoch():
            state, metrics = trainer.train_step(state, batch,
                                                apply_cr=ep >= 1)
        losses.append(float(metrics["loss"]))
        if ep < 2 or ep % 10 == 9:
            print(f"epoch {ep}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    return state, losses


def lifter_config(root):
    """The lifter recipe on ``root``: 66 -> 96, 256 neurons, no dropout,
    x40 pose augmentation, 150 epochs of 128, milestones [60, 100]."""
    from egonet_tpu_torch import config as tcfg
    lcfg = tcfg.train_lifting_config()
    lcfg["dataset"]["root"] = root
    lcfg["training_settings"].update({"total_epochs": 150,
                                      "batch_size": 128,
                                      "lft_aug_times": 40})
    lcfg["FCModel"].update({"input_size": 66, "output_size": 96,
                            "num_neurons": 256, "dropout": 0.0})
    lcfg["optimizer"]["milestones"] = [60, 100]
    return lcfg


def train_lifter(root, device):
    """The lifter of :func:`lifter_config` trained on ``root``'s train
    split; asserts that the last epoch's loss is under a third of the
    first's.  Returns (state, its config, the training set, the
    history)."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.train.lifting import LiftingTrainer
    lcfg = lifter_config(root)
    train_set, _valid = kitti.prepare_data(lcfg)
    lt = LiftingTrainer(lcfg,
                        steps_per_epoch=max(1, len(train_set.input) // 128),
                        device=device)
    lstate, lhist = lt.fit(train_set)
    assert lhist[-1]["loss"] < lhist[0]["loss"] * 0.33
    return lstate, lcfg, train_set, lhist


# --------------------------------------------------------------------------
# The closed-loop gate's world and recipes.  The donor sidecars record the
# zero-shot error on exactly this world, so the donor tool, the gate and
# the JAX package's fixture build it identically.
# --------------------------------------------------------------------------

GATE_SEED = 7          # donors train on seed 3: the gate's scenes are fresh
GATE_N_IMAGES = 40     # 20 train / 20 valid


def make_gate_fixture(tmpdir):
    """The gate's world: 40 keypoint-drawn frames, 2 cars + 1 pedestrian
    each, with detector txts (GT boxes and a score ladder).  Returns
    (root, pred_dir)."""
    rng = np.random.RandomState(GATE_SEED)
    scenes = [random_scene(rng, n_cars=2, n_peds=1)
              for _ in range(GATE_N_IMAGES)]
    return make_kitti_root(tmpdir, n_images=GATE_N_IMAGES,
                           with_predictions=True, classes_per_image=scenes)


# The gate fine-tunes converged donors (trained through LR decay to a final
# 2.5e-4); at the config's base LR (1e-3) ~24 Adam steps on 20 images kick
# them out of their minimum (donor zero-shot val px 5.8 -> 29.8).  The
# fine-tune proves the train step runs and stays converged, so it runs at
# 2e-5: a broken step still diverges loudly, a working one keeps the
# donor's generalization.
GATE_FINETUNE_LR = 2e-5


def gate_train_stanza(cfg, lr=None):
    """The donor-training / gate-fine-tune recipe, shared by both.

    The crop-scale distribution is centered between the two product crop
    chains: the detector-submission path crops at 1.2 x 1.1 = 1.32x, the
    GT-box path at a fixed 1.1x, and 1.21 * [0.8, 1.2] = [0.97, 1.45] puts
    both at +-0.45 sigma.  Centering on the submission chain flips ry on
    ~25% of the GT path's instances; widening the jitter instead costs too
    much precision at a fixed number of epochs.  Modifies ``cfg`` in place
    and returns it."""
    cfg["dataset"]["enlarge_factor"] = 1.21
    cfg["heatmapModel"]["jitter_params"] = {"scaling": [0.2, 0.2],
                                            "shift": [0.05, 0.05]}
    cfg["optimizer"]["milestones"] = [100000]
    if lr is not None:
        cfg["optimizer"]["lr"] = lr
    cfg["training_settings"].update({"batch_size": 6, "total_epochs": 1})
    return cfg


GATE_NATIVE_SHRINK = dict(depths=(1, 1, 2), widths=(16, 32, 64),
                          head_width=48, grid_stride=8)


def gate_shrink(backbone):
    """The gate's shrink recipe for a family: the donor tool, the probe and
    the gate shrink identically, or the donor's weights would not fit the
    model the gate builds."""
    if backbone == "hrnet":
        return shrink_hrnet
    return lambda cfg: shrink_tpu_native(cfg, **GATE_NATIVE_SHRINK)


def igr_config(name, root, classes, backbone, donor):
    """The shipped IGR config ``config.<name>()`` on ``root``'s
    ``classes``, shrunk as the gate shrinks ``backbone``, warm-started in
    every layer from ``donor`` (the donor's readout trunk is
    class-agnostic)."""
    from egonet_tpu_torch import config as tcfg
    cfg = getattr(tcfg, name)()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["detect_classes"] = list(classes)
    gate_shrink(backbone)(cfg)
    hm = cfg["heatmapModel"]
    hm["pretrained"] = donor
    hm["init_weights"] = True
    hm["extra"]["pretrained_layers"] = ["*"]
    return cfg


def warm_trainer(cfg, device, steps_per_epoch=1):
    """An IGRTrainer on ``device`` warm-started from the config's donor;
    returns (trainer, state, the warm-start state_dict)."""
    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.models.init import numpy_init
    from egonet_tpu_torch.train.igrs import IGRTrainer
    trainer = IGRTrainer(cfg, steps_per_epoch=steps_per_epoch, device=device)
    variables = checkpoint.warm_start_variables(
        cfg, numpy_init(trainer.model, 0))
    assert variables is not None, cfg["heatmapModel"]["pretrained"]
    return trainer, trainer.init_state(0, variables=variables), variables


def measure_donor_zero_shot(backbone, donor_path, root, classes=("Car",),
                            device=None):
    """Zero-shot val px (JointDistance2DSIP mean over ``classes``) of a
    donor on the gate world rooted at ``root``, through the port's forward
    on ``device`` (CUDA unless asked).  The donor sidecars record it when a
    donor is made and the gate re-measures it at setup, so a model or
    trainer change that degrades a donor fails this cheap probe with a
    legible message instead of an AOS miss three stages later."""
    from egonet_tpu_torch.data import kitti
    cfg = igr_config("train_igrs_config", root, classes, backbone,
                     donor_path)
    gate_train_stanza(cfg)
    trainer, state, _ = warm_trainer(cfg, device)
    records = kitti.KITTIDataset(cfg, "valid").records
    return float(trainer.evaluate(state, records).metrics[0].mean)


def shrink_hrnet(cfg, num_blocks=1, num_modules=(1, 1, 1),
                 input_size=64, heatmap_size=16):
    """Scale an HRNet config down (channels [8, 16, 32, 64], a small input
    and heatmap).  Modifies ``cfg`` in place and returns it."""
    extra = cfg["heatmapModel"]["extra"]
    chans = {"stage2": [8, 16], "stage3": [8, 16, 32],
             "stage4": [8, 16, 32, 64]}
    for i, s in enumerate(("stage2", "stage3", "stage4")):
        extra[s].update({"num_channels": chans[s],
                         "num_blocks": [num_blocks] * len(chans[s]),
                         "num_modules": num_modules[i]})
    cfg["heatmapModel"]["input_size"] = [input_size, input_size]
    cfg["heatmapModel"]["heatmap_size"] = [heatmap_size, heatmap_size]
    return cfg


def shrink_tpu_native(cfg, depths=(1, 1, 1), widths=(8, 16, 32),
                      input_size=64, heatmap_size=16, head_width=8,
                      grid_stride=4):
    """Switch a config to a small PoseNetTPU.  Modifies ``cfg`` in place
    and returns it."""
    hm = cfg["heatmapModel"]
    hm["name"] = "tpu_native"
    hm["pretrained"] = ""
    hm["extra"] = {"depths": list(depths), "widths": list(widths),
                   "expansion": 2, "head_width": int(head_width),
                   "grid_stride": int(grid_stride)}
    hm["input_size"] = [input_size, input_size]
    hm["heatmap_size"] = [heatmap_size, heatmap_size]
    return cfg
