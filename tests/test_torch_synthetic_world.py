"""The port's synthetic world (``egonet_tpu_torch/tools/synthetic_world.py``)
against the JAX package's test fixture (``tests/fixtures.py``): the same
scenes and label lines, the same KITTI directory file for file (labels,
calibrations, splits and detector txts byte for byte, frames pixel for
pixel: the port writes its PNGs with its own encoder and draws the
key-point discs without cv2), the gate's constants and its recipes (the
shrink and the training stanza) giving the same config dicts.  The gate
world itself is held to ``fixtures.make_gate_fixture`` by
``tests/test_torch_closed_loop_gate.py::test_card_world_equals_the_fixture``.
"""

import os

import numpy as np
import pytest

from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.data.png import decode
from egonet_tpu_torch.tools import synthetic_world as sw
from tests import fixtures


def _scenes(kind, module, n):
    rng = np.random.RandomState(3)
    if kind == "random_scene":
        return [module.random_scene(rng, n_cars=2, n_peds=1)
                for _ in range(n)]
    return [module.random_cars(rng, 3) for _ in range(n)]


def _same_tree(a_root, a_pred, b_root, b_pred):
    """Every txt of two KITTI roots (and their detector txts) byte for
    byte, every frame pixel for pixel."""
    for sub in ("label_2", "calib", "ImageSets"):
        a, b = (os.path.join(r, "training", sub) for r in (a_root, b_root))
        names = sorted(os.listdir(a))
        assert names and names == sorted(os.listdir(b)), sub
        for n in names:
            with open(os.path.join(a, n), "rb") as fa, \
                    open(os.path.join(b, n), "rb") as fb:
                assert fa.read() == fb.read(), (sub, n)
    names = sorted(os.listdir(a_pred))
    assert names and names == sorted(os.listdir(b_pred))
    for n in names:
        with open(os.path.join(a_pred, n), "rb") as fa, \
                open(os.path.join(b_pred, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    a, b = (os.path.join(r, "training", "image_2") for r in (a_root, b_root))
    frames = sorted(os.listdir(a))
    assert frames == sorted(os.listdir(b))
    for n in frames:
        np.testing.assert_array_equal(decode(os.path.join(b, n)),
                                      decode(os.path.join(a, n)), err_msg=n)
    return frames


@pytest.mark.parametrize("kind", ["random_scene", "random_cars"])
def test_kitti_root_equals_the_fixtures(kind, tmp_path):
    """4 keypoint-drawn frames with detector txts: the scenes of the
    donor tool (``random_scene``) and of the full-width tool
    (``random_cars``), both from ``RandomState(3)``."""
    scenes = _scenes(kind, sw, 4)
    assert scenes == _scenes(kind, fixtures, 4)
    root, pred = fixtures.make_kitti_root(
        tmp_path / "fixture", n_images=4, with_predictions=True,
        classes_per_image=_scenes(kind, fixtures, 4), draw_keypoints=True)
    oroot, opred = sw.make_kitti_root(tmp_path / "port", n_images=4,
                                      with_predictions=True,
                                      classes_per_image=scenes)
    assert len(_same_tree(root, pred, oroot, opred)) == 4
    # the frames carry the drawing: the background and every hue's dots
    img = decode(os.path.join(oroot, "training", "image_2", "000000.png"))
    assert (img != 60).any(axis=-1).mean() > 1e-3


def test_default_scene_and_single_frame_split(tmp_path):
    """Without scenes every frame holds ``CARS``; one frame is both the
    train and the val split (the fixture's rule)."""
    root, pred = fixtures.make_kitti_root(tmp_path / "fixture", n_images=1,
                                          with_predictions=True,
                                          draw_keypoints=True)
    oroot, opred = sw.make_kitti_root(tmp_path / "port", n_images=1,
                                      with_predictions=True)
    _same_tree(root, pred, oroot, opred)
    assert sw.make_kitti_root(tmp_path / "bare", n_images=2)[1] is None


def test_records_and_label_lines_equal_the_fixtures():
    assert sw.CARS == fixtures.CARS and sw.PEDS == fixtures.PEDS
    np.testing.assert_array_equal(sw.K_FIXED, fixtures.K_FIXED)
    np.testing.assert_array_equal(sw.T_SHIFT, fixtures.T_SHIFT)
    assert (sw.IMG_W, sw.IMG_H) == (fixtures.IMG_W, fixtures.IMG_H)
    for rec in sw.CARS + sw.PEDS + _scenes("random_scene", sw, 3)[0]:
        for score in (None, 0.7):
            assert sw._label_line(rec, score) == \
                fixtures._label_line(rec, score)
    for a in (-7.0, -np.pi, 0.3, 4.0):
        assert sw.wrap_angle(a) == fixtures.wrap_angle(a)


def test_gate_constants_and_scenes_equal_the_fixtures():
    for name in ("GATE_SEED", "GATE_N_IMAGES", "GATE_FINETUNE_LR",
                 "GATE_NATIVE_SHRINK"):
        assert getattr(sw, name) == getattr(fixtures, name), name
    rng, jrng = (np.random.RandomState(sw.GATE_SEED) for _ in range(2))
    assert [sw.random_scene(rng) for _ in range(sw.GATE_N_IMAGES)] == \
        [fixtures.random_scene(jrng) for _ in range(fixtures.GATE_N_IMAGES)]


# (family, config) pairs the gate shrinks: the HRNet shrink needs an
# HRNet config's stages
SHRUNK = [("hrnet", "train_igrs_config"), ("hrnet", "train_igrs_ped_config"),
          ("hrnet", "demo_config"), ("tpu_native", "train_igrs_config"),
          ("tpu_native", "tpu_native_config"), ("tpu_native", "demo_config")]


@pytest.mark.parametrize("backbone,name", SHRUNK)
def test_gate_recipes_give_the_fixtures_configs(backbone, name):
    """``gate_shrink`` leaves every config as the fixture's does, and on
    the training configs so does ``gate_train_stanza`` (at the config's LR
    and at the fine-tune's)."""
    ours = sw.gate_shrink(backbone)(getattr(tcfg, name)())
    assert ours == fixtures.gate_shrink(backbone)(getattr(tcfg, name)())
    if "optimizer" not in ours:
        return
    for lr in (None, sw.GATE_FINETUNE_LR):
        assert sw.gate_train_stanza(
            sw.gate_shrink(backbone)(getattr(tcfg, name)()), lr=lr) == \
            fixtures.gate_train_stanza(
                fixtures.gate_shrink(backbone)(getattr(tcfg, name)()), lr=lr)


@pytest.mark.parametrize("kwargs", [
    {}, {"num_blocks": 4, "num_modules": (1, 4, 3)},
    {"input_size": 96, "heatmap_size": 24}])
def test_shrink_hrnet_equals_the_fixtures(kwargs):
    assert sw.shrink_hrnet(tcfg.demo_config(), **kwargs) == \
        fixtures.shrink_hrnet(tcfg.demo_config(), **kwargs)


@pytest.mark.parametrize("kwargs", [
    {}, {"widths": (16, 32, 64), "head_width": 16, "grid_stride": 8},
    {"depths": (1, 1, 2), "input_size": 128, "heatmap_size": 32}])
def test_shrink_tpu_native_equals_the_fixtures(kwargs):
    assert sw.shrink_tpu_native(tcfg.tpu_native_config(), **kwargs) == \
        fixtures.shrink_tpu_native(tcfg.tpu_native_config(), **kwargs)


def test_igr_config_is_the_gates_warm_start_recipe():
    """The gate's per-job config: the shipped config on the root's
    classes, shrunk, warm-started in every layer from the donor."""
    cfg = sw.igr_config("train_igrs_ped_config", "world", ("Pedestrian",),
                        "hrnet", "donor.pth")
    want = fixtures.gate_shrink("hrnet")(tcfg.train_igrs_ped_config())
    want["dataset"].update(root="world", detect_classes=["Pedestrian"])
    want["heatmapModel"].update(pretrained="donor.pth", init_weights=True)
    want["heatmapModel"]["extra"]["pretrained_layers"] = ["*"]
    assert cfg == want
