"""The closed-loop gate's pipeline on the port (no jax: ``chip_smoke.py``'s
``gate`` phase runs it on the card, ``tests/test_torch_closed_loop_gate.py``
on the CPU).  It is the JAX gate's (``tests/test_closed_loop_gate.py``) with
the port in every stage: fine-tune a shrunk heatmap model from a committed
donor (every layer warm-started, the donor's batch-norm statistics exported
with the fine-tuned parameters), train an 'R3d+T' lifter, run the port's
inference CLI on the GT-box and submission paths, and score with the C++
evaluator (``make -C tools/kitti-eval``) or, where it cannot build, the
port's Python evaluator.  The recipes, the world and the floors are the JAX
gate's: ``fixtures.gate_shrink``, ``gate_train_stanza`` at
``GATE_FINETUNE_LR``, the seed-7 world of 40 images, and the AOS / AP
ratios below (the CPU test holds them equal to the JAX gate's).

:func:`write_world` draws that world without cv2 or the JAX package: the
fixture's scenes and label lines, the port's cuboid, and discs rasterized
as ``cv2.circle`` fills them (the CPU test holds every file to
``fixtures.make_gate_fixture``'s).
"""

import colorsys
import copy
import importlib.util
import os
import re
import shutil
import subprocess

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_by_path(name, path):
    """A module from its file: a host may have another package named
    ``tests`` installed, which ``from tests import ...`` would find."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fixtures = load_by_path("egonet_gate_fixtures",
                        os.path.join(HERE, "fixtures.py"))
DATA = os.path.join(HERE, "data")
HRNET_DONOR = os.path.join(DATA, "gate_hrnet_car.pth")
NATIVE_DONOR = os.path.join(DATA, "gate_native_car.pth")

CAR_EPOCHS = 6
PED_EPOCHS = 8
NATIVE_EPOCHS = 6
LIFTER_EPOCHS = 100

CAR_AOS_RATIO = 0.93
PED_AOS_RATIO = 0.85
NATIVE_AOS_RATIO = 0.89
CAR_GT_RATIO = 0.93
PED_GT_RATIO = 0.80
SIDECAR_TOL = lambda px: px * 1.3 + 2.0  # noqa: E731

# (tag, config, classes, epochs, max instances a batch, donor)
JOBS = (("car", "train_igrs_config", ("Car",), CAR_EPOCHS, 12, HRNET_DONOR),
        ("ped", "train_igrs_ped_config", ("Pedestrian",), PED_EPOCHS, 6,
         HRNET_DONOR),
        ("native", "train_igrs_config", ("Car",), NATIVE_EPOCHS, 12,
         NATIVE_DONOR))
BACKBONE = {"car": "hrnet", "ped": "hrnet", "native": "tpu_native"}
# (leg, tag, path, class, floor): what each leg of the gate asserts
LEGS = (("car submission", "car", "sub", "car", CAR_AOS_RATIO),
        ("car gt-path", "car", "gt", "car", CAR_GT_RATIO),
        ("ped submission", "ped", "sub", "pedestrian", PED_AOS_RATIO),
        ("ped gt-path", "ped", "gt", "pedestrian", PED_GT_RATIO),
        ("native submission", "native", "sub", "car", NATIVE_AOS_RATIO))


# ---------------------------------------------------------------- world

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


def draw_keypoints(img, recs):
    """``fixtures.draw_instance_keypoints`` with the port's cuboid: each
    instance's 33 projected keypoints as discs, one hue per index, radius
    scaled with the box height."""
    from egonet_tpu_torch.data import cuboid as cb
    shift = (np.linalg.inv(fixtures.K_FIXED) @ fixtures.T_SHIFT).reshape(3, 1)
    for _cls, _t, _o, _a, bbox, (h, w, l), loc, ry in recs:
        r = int(np.clip(round((bbox[3] - bbox[1]) / 24.0), 2, 8))
        pts = cb.construct_box_3d(l, h, w)
        placed = cb.place_cuboid(pts, np.array([*loc, 0.0, ry, 0.0]), shift)
        proj = cb.project_3d_to_2d(placed, fixtures.K_FIXED)
        for k in range(proj.shape[1]):
            u, v = int(round(proj[0, k])), int(round(proj[1, k]))
            if 0 <= u < fixtures.IMG_W and 0 <= v < fixtures.IMG_H:
                col = tuple(int(255 * c) for c in
                            colorsys.hsv_to_rgb(k / 33.0, 1.0, 1.0))
                _disc(img, u, v, r, col)
    return img


def write_world(tmpdir):
    """``fixtures.make_gate_fixture``'s KITTI root and detector txts under
    ``tmpdir``: the same scenes, label, calibration, split and prediction
    files, and frames of the same pixels (PNGs from the port's writer; the
    fixture's cv2 stores its drawing's channels as BGR, so they are
    reversed here).  Returns (root, pred_dir)."""
    from egonet_tpu_torch.data import png
    rng = np.random.RandomState(fixtures.GATE_SEED)
    scenes = [fixtures.random_scene(rng, n_cars=2, n_peds=1)
              for _ in range(fixtures.GATE_N_IMAGES)]
    root = os.path.join(str(tmpdir), "KITTI")
    train = os.path.join(root, "training")
    for sub in ("image_2", "label_2", "calib", "ImageSets"):
        os.makedirs(os.path.join(train, sub), exist_ok=True)
    pred_dir = os.path.join(str(tmpdir), "preds")
    os.makedirs(pred_dir, exist_ok=True)
    names = [f"{i:06d}" for i in range(len(scenes))]
    p_line = "P2: " + " ".join(str(v) for v in np.hstack(
        [fixtures.K_FIXED, fixtures.T_SHIFT.reshape(3, 1)]).reshape(-1))
    for name, recs in zip(names, scenes):
        img = np.full((fixtures.IMG_H, fixtures.IMG_W, 3), 60, np.uint8)
        draw_keypoints(img, recs)
        with open(os.path.join(train, "image_2", name + ".png"), "wb") as f:
            f.write(png.encode(np.ascontiguousarray(img[..., ::-1])))
        with open(os.path.join(train, "label_2", name + ".txt"), "w") as f:
            f.write("\n".join(fixtures._label_line(r) for r in recs) + "\n")
        with open(os.path.join(train, "calib", name + ".txt"), "w") as f:
            f.write("P0: " + " ".join(["0"] * 12) + "\n")
            f.write("P1: " + " ".join(["0"] * 12) + "\n")
            f.write(p_line + "\n")
            f.write("P3: " + " ".join(["0"] * 12) + "\n")
        with open(os.path.join(pred_dir, name + ".txt"), "w") as f:
            f.write("\n".join(fixtures._label_line(r, score=0.9 - 0.1 * j)
                              for j, r in enumerate(recs)) + "\n")
    half = len(names) // 2
    for split, part in (("train", names[:half]), ("val", names[half:]),
                        ("trainval", names)):
        with open(os.path.join(train, "ImageSets", split + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    return root, pred_dir


# ---------------------------------------------------------------- stages

def _igr_cfg(name, root, classes, backbone, donor):
    from egonet_tpu_torch import config as tcfg
    cfg = getattr(tcfg, name)()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["detect_classes"] = list(classes)
    fixtures.gate_shrink(backbone)(cfg)
    hm = cfg["heatmapModel"]
    hm["pretrained"] = donor
    hm["init_weights"] = True
    # the donor's readout trunk is class-agnostic: warm-start every layer
    hm["extra"]["pretrained_layers"] = ["*"]
    return cfg


def _warm_trainer(cfg, device, steps_per_epoch=1):
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


def donor_px(backbone, donor, root, classes, device):
    """Zero-shot val px (JointDistance2DSIP mean over ``classes``) of a
    donor through the port's forward: ``fixtures.measure_donor_zero_shot``
    on the port."""
    from egonet_tpu_torch.data import kitti
    cfg = _igr_cfg("train_igrs_config", root, classes, backbone, donor)
    fixtures.gate_train_stanza(cfg)
    trainer, state, _ = _warm_trainer(cfg, device)
    records = kitti.KITTIDataset(cfg, "valid").records
    return float(trainer.evaluate(state, records).metrics[0].mean)


def check_donors(root, device):
    """Failure mode 1 of the JAX gate: each donor's zero-shot val px on
    this world against its sidecar.  Returns {donor/class: (px, recorded)}
    and raises naming a stale donor."""
    import json
    out = {}
    for backbone, donor in (("hrnet", HRNET_DONOR),
                            ("tpu_native", NATIVE_DONOR)):
        with open(donor[:-len(".pth")] + ".json") as f:
            side = json.load(f)
        probes = [("val_px", ("Car",))]
        if "val_px_ped" in side:
            probes.append(("val_px_ped", ("Pedestrian",)))
        for key, classes in probes:
            px = donor_px(backbone, donor, root, classes, device)
            name = f"{os.path.basename(donor)}/{classes[0]}"
            out[name] = (px, side[key])
            assert px <= SIDECAR_TOL(side[key]), (
                f"STALE DONOR {name}: zero-shot val px {px:.2f} vs recorded "
                f"{side[key]:.2f} (regenerate via "
                f"tools/make_gate_artifacts.py)")
    return out


def fine_tune(root, tag, ck_dir, device):
    """Fine-tune the ``tag`` job's shrunk model from its donor with the
    port's IGRTrainer (cross-ratio from epoch 1) and write ``HC.pth``: the
    fine-tuned parameters with the donor's batch-norm statistics (the JAX
    gate's export: ~24 steps re-estimate them too noisily for the
    sigmoid readout).  Returns (first epoch's last loss, last loss)."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.io import checkpoint
    _, name, classes, epochs, max_instances, donor = \
        next(j for j in JOBS if j[0] == tag)
    cfg = _igr_cfg(name, root, classes, BACKBONE[tag], donor)
    fixtures.gate_train_stanza(cfg, lr=fixtures.GATE_FINETUNE_LR)
    ds = kitti.KITTIDataset(cfg, "train")
    loader = IGRBatchLoader(ds.records, cfg, train=True,
                            max_instances=max_instances, seed=0)
    trainer, state, variables = _warm_trainer(cfg, device, len(loader))
    first = last = None
    for ep in range(epochs):
        for batch in loader.epoch():
            state, metrics = trainer.train_step(state, batch,
                                                apply_cr=ep >= 1)
        last = float(metrics["loss"])
        first = last if first is None else first
    # converged on the fresh scenes and not diverging (the JAX gate's bar)
    assert np.isfinite(last) and last < 0.05 and last <= first * 1.5, \
        (tag, first, last)
    state_dict = {k: v.detach().cpu() for k, v in
                  state.model.state_dict().items()}
    for k in state_dict:
        if k.endswith(("running_mean", "running_var")):
            state_dict[k] = variables[k].clone()
    checkpoint.save_torch_state_dict(os.path.join(ck_dir, "HC.pth"),
                                     state_dict)
    return first, last


def train_lifter(root, classes, ck_dir, device):
    """The 'R3d+T' lifter of one class set, x100 pose augmentation, 100
    epochs (the JAX gate's); writes ``L.pth`` + ``LS.npy`` and returns the
    FCModel stanza the inference config takes."""
    from egonet_tpu_torch import config as tcfg
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.train.lifting import LiftingTrainer
    cfg = tcfg.train_lifting_config()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["detect_classes"] = list(classes)
    cfg["dataset"]["lft_out_rep"] = "R3d+T"
    cfg["training_settings"].update({"total_epochs": LIFTER_EPOCHS,
                                     "batch_size": 128,
                                     "lft_aug_times": 100})
    cfg["FCModel"].update({"input_size": 66, "output_size": 99,
                           "num_neurons": 256, "dropout": 0.0})
    cfg["optimizer"]["milestones"] = [50, 80]
    train_set, _valid = kitti.prepare_data(cfg)
    trainer = LiftingTrainer(
        cfg, steps_per_epoch=max(1, len(train_set.input) // 128),
        device=device)
    state, hist = trainer.fit(train_set)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.5, (hist[0], hist[-1])
    os.makedirs(ck_dir, exist_ok=True)
    checkpoint.save_torch_state_dict(os.path.join(ck_dir, "L.pth"),
                                     state.model)
    checkpoint.save_lifter_stats(os.path.join(ck_dir, "LS.npy"),
                                 train_set.statistics)
    return cfg["FCModel"]


def train_all(root, tmp, device):
    """Every job's HC.pth and its class's lifter (the native job reuses the
    Car lifter).  Returns {tag: {"ck", "fc", "loss": (first, last)}}."""
    out, lifters = {}, {}
    for tag, _, classes, *_ in JOBS:
        ck = os.path.join(str(tmp), f"ckpt_{tag}")
        os.makedirs(ck, exist_ok=True)
        loss = fine_tune(root, tag, ck, device)
        if classes not in lifters:
            lifters[classes] = (train_lifter(root, classes, ck, device), ck)
        else:
            for name in ("L.pth", "LS.npy"):
                shutil.copyfile(os.path.join(lifters[classes][1], name),
                                os.path.join(ck, name))
        out[tag] = {"ck": ck, "fc": lifters[classes][0], "loss": loss}
    return out


def run_inference(root, pred_dir, trained, tag, out_dir, device,
                  bf16=False, stencil=None):
    """The port's inference CLI with the ``tag`` job's checkpoints on both
    paths: GT boxes (alpha 'trans') -> ``gt_box_test/``, detector boxes
    (alpha 'proj') -> ``submission/``; ``stencil`` sets
    EGONET_PALLAS_STENCIL for the run.  Returns (gt dir, submission
    dir)."""
    from egonet_tpu_torch import config as tcfg
    from egonet_tpu_torch.tools import inference
    classes = next(j[2] for j in JOBS if j[0] == tag)
    cfg = tcfg.demo_config()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["detect_classes"] = list(classes)
    fixtures.gate_shrink(BACKBONE[tag])(cfg)
    cfg["heatmapModel"]["init_weights"] = False
    cfg["FCModel"] = copy.deepcopy(trained[tag]["fc"])
    cfg["dirs"] = {"output": out_dir, "ckpt": trained[tag]["ck"],
                   "load_prediction_file": pred_dir}
    cfg.update(pre_trained=True, bf16=bool(bf16), use_gt_box=True,
               use_pred_box=True, device=str(device))
    cfg["testing_settings"]["batch_size"] = 4
    old = os.environ.get("EGONET_PALLAS_STENCIL")
    if stencil is not None:
        os.environ["EGONET_PALLAS_STENCIL"] = stencil
    try:
        inference.main(cfgs=cfg)
    finally:
        if old is None:
            os.environ.pop("EGONET_PALLAS_STENCIL", None)
        else:
            os.environ["EGONET_PALLAS_STENCIL"] = old
    return (os.path.join(out_dir, "gt_box_test"),
            os.path.join(out_dir, "submission"))


# ---------------------------------------------------------------- scoring

def score(label_dir, result_dir):
    """{(label, 'AP' or 'AP_R11'): (easy, moderate, hard)} of a result
    directory: the C++ evaluator's summary lines, or the port's Python
    evaluator's numbers where the binary cannot build."""
    from egonet_tpu_torch.eval.native import ensure_evaluator
    binary = ensure_evaluator()
    res = {}
    if binary is not None:
        out = subprocess.check_output([binary, label_dir, result_dir],
                                      timeout=300).decode()
        for ln in out.splitlines():
            m = re.match(r"(\w+) (AP|AP_R11): ([\d.]+) ([\d.]+) ([\d.]+)", ln)
            if m:
                res[(m.group(1), m.group(2))] = tuple(
                    float(m.group(i)) for i in (3, 4, 5))
        return res
    from egonet_tpu_torch.eval import kitti_eval as ke
    for cls, metrics in ke.evaluate(label_dir, result_dir).items():
        diffs = metrics["image"]
        for label, key in ((f"{cls}_detection", "ap"),
                           (f"{cls}_orientation", "aos")):
            for tag, style in (("AP", "r40"), ("AP_R11", "r11")):
                res[(label, tag)] = tuple(diffs[d][f"{key}_{style}"]
                                          for d in ke.DIFFICULTIES)
    return res


def ceiling(label_dir, pred_dir, names, out_dir):
    """The protocol ceiling: the detector's own boxes (GT geometry, the
    score ladder) scored over the evaluated frames."""
    data = os.path.join(out_dir, "data")
    os.makedirs(data, exist_ok=True)
    for n in names:
        shutil.copyfile(os.path.join(pred_dir, n), os.path.join(data, n))
    return score(label_dir, out_dir)


def leg(res, ceil, cls):
    """(AP_R11, AOS_R11, the class's ceiling, AOS / ceiling) of a scored
    result (easy difficulty)."""
    c = ceil[(f"{cls}_detection", "AP_R11")][0]
    ap = res[(f"{cls}_detection", "AP_R11")][0]
    aos = res[(f"{cls}_orientation", "AP_R11")][0]
    return ap, aos, c, aos / c


def merge_submissions(dirs, out_dir):
    """One submission of the lines of several (the combined multiclass
    run)."""
    data = os.path.join(out_dir, "data")
    os.makedirs(data, exist_ok=True)
    names = set()
    for d in dirs:
        names.update(os.listdir(os.path.join(d, "data")))
    for n in sorted(names):
        lines = []
        for d in dirs:
            p = os.path.join(d, "data", n)
            if os.path.exists(p):
                with open(p) as f:
                    lines.extend(ln for ln in f.read().splitlines() if ln)
        with open(os.path.join(data, n), "w") as f:
            f.write("\n".join(lines) + "\n")
    return out_dir


def fused_blocks_per_forward(tag, stencil):
    """How many blocks of the ``tag`` job's shrunk bf16 model the chosen
    kernel runs (the native family has none), from the model's own
    routing (built on the meta device)."""
    if BACKBONE[tag] != "hrnet":
        return 0
    from egonet_tpu_torch import config as tcfg
    from egonet_tpu_torch.models.hrnet import build_hrnet
    cfg = fixtures.gate_shrink("hrnet")(tcfg.demo_config())
    with torch.device("meta"):
        net = build_hrnet(cfg, dtype=torch.bfloat16)
    return sum(1 for _ in net._fusable_blocks(stencil))
