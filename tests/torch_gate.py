"""The closed-loop gate's pipeline on the port (no jax: ``chip_smoke.py``'s
``gate`` phase runs it on the card, ``tests/test_torch_closed_loop_gate.py``
on the CPU).  It is the JAX gate's (``tests/test_closed_loop_gate.py``) with
the port in every stage: fine-tune a shrunk heatmap model from a donor
(every layer warm-started, the donor's batch-norm statistics exported
with the fine-tuned parameters), train an 'R3d+T' lifter, run the port's
inference CLI on the GT-box and submission paths, and score with the C++
evaluator (``make -C tools/kitti-eval``) or, where it cannot build, the
port's Python evaluator.  The recipes, the world and the floors are the JAX
gate's: the port's copies of them in ``egonet_tpu_torch.tools.
synthetic_world`` (``gate_shrink``, ``gate_train_stanza`` at
``GATE_FINETUNE_LR``, the seed-7 world of 40 images) and the AOS / AP
ratios below (the CPU test holds them equal to the JAX gate's).

The donors default to the committed ones (``tests/data/gate_*.pth``, made
by the JAX package); ``donors=`` takes others of the same format, such as
those ``python -m egonet_tpu_torch.tools.make_gate_artifacts`` trains.
"""

import copy
import os
import re
import shutil
import subprocess

import numpy as np

from egonet_tpu_torch.tools import synthetic_world as sw
from egonet_tpu_torch.tools.make_gate_artifacts import DONORS as DONOR_FILES

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
DONORS = {fam: os.path.join(DATA, name) for fam, name in DONOR_FILES}

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

# (tag, config, classes, epochs, max instances a batch)
JOBS = (("car", "train_igrs_config", ("Car",), CAR_EPOCHS, 12),
        ("ped", "train_igrs_ped_config", ("Pedestrian",), PED_EPOCHS, 6),
        ("native", "train_igrs_config", ("Car",), NATIVE_EPOCHS, 12))
BACKBONE = {"car": "hrnet", "ped": "hrnet", "native": "tpu_native"}
# (leg, tag, path, class, floor): what each leg of the gate asserts
LEGS = (("car submission", "car", "sub", "car", CAR_AOS_RATIO),
        ("car gt-path", "car", "gt", "car", CAR_GT_RATIO),
        ("ped submission", "ped", "sub", "pedestrian", PED_AOS_RATIO),
        ("ped gt-path", "ped", "gt", "pedestrian", PED_GT_RATIO),
        ("native submission", "native", "sub", "car", NATIVE_AOS_RATIO))


# ---------------------------------------------------------------- stages

def check_donors(root, device, donors=DONORS):
    """Failure mode 1 of the JAX gate: each donor's zero-shot val px on
    this world against its sidecar (``<donor>.json`` beside it).  Returns
    {donor/class: (px, recorded)} and raises naming a stale donor."""
    import json
    out = {}
    for backbone, donor in donors.items():
        with open(donor[:-len(".pth")] + ".json") as f:
            side = json.load(f)
        probes = [("val_px", ("Car",))]
        if "val_px_ped" in side:
            probes.append(("val_px_ped", ("Pedestrian",)))
        for key, classes in probes:
            px = sw.measure_donor_zero_shot(backbone, donor, root, classes,
                                            device)
            name = f"{os.path.basename(donor)}/{classes[0]}"
            out[name] = (px, side[key])
            assert px <= SIDECAR_TOL(side[key]), (
                f"STALE DONOR {name}: zero-shot val px {px:.2f} vs recorded "
                f"{side[key]:.2f} (regenerate via python -m "
                f"egonet_tpu_torch.tools.make_gate_artifacts)")
    return out


def fine_tune(root, tag, ck_dir, device, donors=DONORS):
    """Fine-tune the ``tag`` job's shrunk model from its family's donor in
    ``donors`` with the
    port's IGRTrainer (cross-ratio from epoch 1) and write ``HC.pth``: the
    fine-tuned parameters with the donor's batch-norm statistics (the JAX
    gate's export: ~24 steps re-estimate them too noisily for the
    sigmoid readout).  Returns (first epoch's last loss, last loss)."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.io import checkpoint
    _, name, classes, epochs, max_instances = \
        next(j for j in JOBS if j[0] == tag)
    cfg = sw.igr_config(name, root, classes, BACKBONE[tag],
                        donors[BACKBONE[tag]])
    sw.gate_train_stanza(cfg, lr=sw.GATE_FINETUNE_LR)
    ds = kitti.KITTIDataset(cfg, "train")
    loader = IGRBatchLoader(ds.records, cfg, train=True,
                            max_instances=max_instances, seed=0)
    trainer, state, variables = sw.warm_trainer(cfg, device, len(loader))
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


def train_all(root, tmp, device, donors=DONORS):
    """Every job's HC.pth, fine-tuned from ``donors``, and its class's
    lifter (the native job reuses the Car lifter).  Returns {tag: {"ck",
    "fc", "loss": (first, last)}}."""
    out, lifters = {}, {}
    for tag, _, classes, *_ in JOBS:
        ck = os.path.join(str(tmp), f"ckpt_{tag}")
        os.makedirs(ck, exist_ok=True)
        loss = fine_tune(root, tag, ck, device, donors)
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
    sw.gate_shrink(BACKBONE[tag])(cfg)
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
    routing (``trained_closed_loop.fused_blocks``: the same shrink)."""
    from egonet_tpu_torch.tools.trained_closed_loop import fused_blocks
    return fused_blocks(BACKBONE[tag], stencil)
