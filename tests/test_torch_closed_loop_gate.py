"""The closed-loop gate's port leg: the six tests of
``tests/test_closed_loop_gate.py`` with the port in every stage, on the CPU
in fp32, at the JAX gate's floors unchanged.

The world is the JAX gate's (``fixtures.make_gate_fixture``: seed 7, 40
keypoint-rendered frames, 2 cars and 1 pedestrian each, detector txts with
GT geometry and a score ladder), the shrink recipes and the fine-tune
stanza too.  Each committed donor (``tests/data/gate_*.pth``) is first
probed through the port's forward against its sidecar (a stale donor
fails there, not three stages later).  Then ``tests/torch_gate.py`` runs
the pipeline: the port's IGRTrainer fine-tunes the car (W48 config
family), pedestrian (W32 family: freeze_layers) and native models from
their donors, exporting the donor's BN statistics; the port's lifter
trains 'R3d+T' per class; the port's inference CLI writes both paths; the
C++ evaluator (built by make, as the JAX gate builds it) scores them
against the protocol ceiling measured in-run.  ``chip_smoke.py``'s
``gate`` phase runs the same pipeline on the card, in bf16 through both
fused kernels.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from tests import fixtures
from tests import test_closed_loop_gate as jax_gate
from tests import torch_gate as tg

torch.set_num_threads(2)


def test_floors_and_recipe_are_the_jax_gates():
    """The port leg's bars and epochs are the JAX gate's, unchanged."""
    for name in ("CAR_AOS_RATIO", "PED_AOS_RATIO", "NATIVE_AOS_RATIO",
                 "CAR_GT_RATIO", "PED_GT_RATIO", "CAR_EPOCHS", "PED_EPOCHS",
                 "NATIVE_EPOCHS", "LIFTER_EPOCHS"):
        assert getattr(tg, name) == getattr(jax_gate, name), name
    for px in (0.0, 4.9, 14.7):
        assert tg.SIDECAR_TOL(px) == jax_gate.SIDECAR_TOL(px)


@pytest.fixture(scope="module")
def gate_world(tmp_path_factory):
    """Build the world and the C++ binary, probe the donors, fine-tune the
    three heatmap models, train both lifters, run the three inference CLIs
    and measure the protocol ceiling, once."""
    subprocess.check_call(["make", "-C", os.path.dirname(jax_gate.CPP_BIN)],
                          stdout=subprocess.DEVNULL)
    tmp = tmp_path_factory.mktemp("torch_gate")
    root, pred_dir = fixtures.make_gate_fixture(tmp)
    label_dir = os.path.join(root, "training", "label_2")
    donors = tg.check_donors(root, "cpu")
    for name, (px, recorded) in donors.items():
        print(f"port gate donor {name}: zero-shot val px {px:.2f} "
              f"(sidecar {recorded:.2f})")
    trained = tg.train_all(root, tmp, "cpu")
    world = {"root": root, "label_dir": label_dir, "pred_dir": pred_dir,
             "dirs": {}}
    for tag in trained:
        gt, sub = tg.run_inference(root, pred_dir, trained, tag,
                                   str(tmp / f"out_{tag}"), "cpu")
        world["dirs"][tag] = {"gt": gt, "sub": sub}
    names = sorted(os.listdir(os.path.join(world["dirs"]["car"]["sub"],
                                           "data")))
    for tag in ("ped", "native"):
        assert sorted(os.listdir(os.path.join(
            world["dirs"][tag]["sub"], "data"))) == names, tag
    world["ceiling"] = tg.ceiling(label_dir, pred_dir, names,
                                  str(tmp / "ceiling"))
    return world


def _leg_check(world, res, cls, aos_ratio, leg):
    """Detection AP at the protocol ceiling (no line dropped or mangled),
    then AOS at or above ``aos_ratio`` of it."""
    ap, aos, ceil, ratio = tg.leg(res, world["ceiling"], cls)
    print(f"port gate {leg}: AP_R11 {ap:.2f} (ceiling {ceil:.2f}) "
          f"AOS_R11 {aos:.2f} (floor {aos_ratio * ceil:.2f}, ratio "
          f"{ratio:.4f})")
    assert abs(ap - ceil) < 0.2, (
        f"{leg}: detection AP {ap} != protocol ceiling {ceil}", res)
    assert aos >= aos_ratio * ceil, (
        f"{leg}: AOS {aos} below {aos_ratio} x ceiling {ceil}", res)


def _score(world, tag, path):
    return tg.score(world["label_dir"], world["dirs"][tag][path])


def test_gate_car_submission_aos(gate_world):
    """Detector-submission path (alpha 'proj'), car on the W48 family."""
    _leg_check(gate_world, _score(gate_world, "car", "sub"), "car",
               tg.CAR_AOS_RATIO, "car submission")


def test_gate_car_gt_path_trans_alpha(gate_world):
    """GT-box path (fixed alpha 'trans', reading the lifter's root)."""
    _leg_check(gate_world, _score(gate_world, "car", "gt"), "car",
               tg.CAR_GT_RATIO, "car gt-path")


def test_gate_ped_w32_family(gate_world):
    """Pedestrian on the W32 config family: submission, then GT path."""
    _leg_check(gate_world, _score(gate_world, "ped", "sub"), "pedestrian",
               tg.PED_AOS_RATIO, "ped submission")
    _leg_check(gate_world, _score(gate_world, "ped", "gt"), "pedestrian",
               tg.PED_GT_RATIO, "ped gt-path")


def test_gate_ped_submission_line_parity(gate_world):
    """Every Pedestrian detector line reappears, in order, with every field
    but alpha and rot_y unchanged, and some refined."""
    sub_data = os.path.join(gate_world["dirs"]["ped"]["sub"], "data")
    refined = checked = 0
    for name in sorted(os.listdir(sub_data)):
        with open(os.path.join(gate_world["pred_dir"], name)) as f:
            ped = [ln.split() for ln in f.read().splitlines()
                   if ln.startswith("Pedestrian")]
        with open(os.path.join(sub_data, name)) as f:
            sub = [ln.split() for ln in f.read().splitlines() if ln]
        assert len(sub) == len(ped), name
        for orig, new in zip(ped, sub):
            assert new[0] == "Pedestrian" and len(new) == 16, (name, new)
            for i in range(1, 16):
                if i not in (3, 14):
                    assert abs(float(new[i]) - float(orig[i])) < 1e-6, \
                        (name, i, orig, new)
            refined += (abs(float(new[3]) - float(orig[3])) > 1e-9 or
                        abs(float(new[14]) - float(orig[14])) > 1e-9)
            checked += 1
    assert checked >= 10, checked
    assert refined > 0


def test_gate_native_family(gate_world):
    """The PoseNetTPU family clears its floor too."""
    _leg_check(gate_world, _score(gate_world, "native", "sub"), "car",
               tg.NATIVE_AOS_RATIO, "native submission")


def test_gate_combined_multiclass_eval(gate_world, tmp_path):
    """One evaluator run over the merged car + pedestrian submission: both
    classes at their floors, and all four stats files written."""
    merged = tg.merge_submissions(
        [gate_world["dirs"]["car"]["sub"], gate_world["dirs"]["ped"]["sub"]],
        str(tmp_path / "combined"))
    res = tg.score(gate_world["label_dir"], merged)
    _leg_check(gate_world, res, "car", tg.CAR_AOS_RATIO, "combined car")
    _leg_check(gate_world, res, "pedestrian", tg.PED_AOS_RATIO,
               "combined ped")
    for stats in ("stats_car_detection.txt", "stats_car_orientation.txt",
                  "stats_pedestrian_detection.txt",
                  "stats_pedestrian_orientation.txt"):
        assert os.path.exists(os.path.join(merged, stats)), stats


def test_card_world_equals_the_fixture(tmp_path):
    """The port's ``synthetic_world.make_gate_fixture`` (what the card's
    gate phase draws, without cv2 or the JAX package) writes the fixture's
    files: every label, calibration, split and detector txt byte for byte,
    every frame pixel for pixel."""
    from egonet_tpu_torch.data.png import decode
    from egonet_tpu_torch.tools import synthetic_world as sw
    root, pred = fixtures.make_gate_fixture(tmp_path / "fixture")
    oroot, opred = sw.make_gate_fixture(tmp_path / "card")
    train, otrain = (os.path.join(r, "training") for r in (root, oroot))
    for sub in ("label_2", "calib", "ImageSets"):
        names = sorted(os.listdir(os.path.join(train, sub)))
        assert names == sorted(os.listdir(os.path.join(otrain, sub))), sub
        for n in names:
            with open(os.path.join(train, sub, n), "rb") as a, \
                    open(os.path.join(otrain, sub, n), "rb") as b:
                assert a.read() == b.read(), (sub, n)
    for n in sorted(os.listdir(pred)):
        with open(os.path.join(pred, n), "rb") as a, \
                open(os.path.join(opred, n), "rb") as b:
            assert a.read() == b.read(), n
    frames = sorted(os.listdir(os.path.join(train, "image_2")))
    assert len(frames) == fixtures.GATE_N_IMAGES
    for n in frames:
        np.testing.assert_array_equal(
            decode(os.path.join(otrain, "image_2", n)),
            decode(os.path.join(train, "image_2", n)), err_msg=n)
