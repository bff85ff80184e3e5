"""The port's refinement, visualization and host / gather crop helpers
against the JAX package's on the CPU (cv2 and matplotlib are installed
here; the card's machine lacks both):

- ``common/transformation.pnp_refine``, ``eval/refinement.refine_record``
  and the geometry of ``visualization/points.py``: equal to the JAX
  functions (the same NumPy / OpenCV code);
- ``ops/affine.warp_affine`` / ``warp_instances`` against the JAX ones run
  eagerly, within 1e-4 on a 0-255 scale; ``simple_crop`` bit-equal;
  ``save_cropped_patches`` writing the same crops (PNGs here, JPEGs
  there);
- ``EgoNet.post_process(visualize=True, refine=True)`` and the inference
  CLI's ``--visualize true`` writing the ``_2d.png`` / ``_3d.png`` files
  the JAX package writes, and txts equal to the JAX CLI's outside the
  angles.
"""

import copy
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from egonet_tpu.common import transformation as jtr
from egonet_tpu.eval import refinement as jref
from egonet_tpu.ops import affine as jaff
from egonet_tpu.visualization import points as jpts
from egonet_tpu_torch.common import transformation as ttr
from egonet_tpu_torch.data import cuboid as cb
from egonet_tpu_torch.data import png
from egonet_tpu_torch.eval import refinement as tref
from egonet_tpu_torch.ops import affine as taff
from egonet_tpu_torch.visualization import points as tpts
from tests import fixtures

torch.set_num_threads(1)

K = np.array([[707.0, 0.0, 604.0], [0.0, 707.0, 180.0], [0.0, 0.0, 1.0]])


def _cuboid(rng):
    """A placed car cuboid [32, 3] (center excluded) and its noisy screen
    projection [32, 2]."""
    box = cb.construct_box_3d(3.9, 1.5, 1.6)[:, 1:]
    placed = (cb.rot_y_matrix(rng.uniform(-np.pi, np.pi)) @ box
              + np.array([rng.uniform(-5, 5), 1.6, rng.uniform(8, 30)])[
                  :, None]).T
    proj = placed @ K.T
    return placed, proj[:, :2] / proj[:, 2:] + rng.randn(32, 2) * 0.5


def test_pnp_refine_equals_jax(rng):
    placed, obs = _cuboid(rng)
    pred = placed + rng.randn(*placed.shape) * 0.05
    np.testing.assert_array_equal(ttr.pnp_refine(pred, obs, K),
                                  jtr.pnp_refine(pred, obs, K))


def test_refine_record_equals_jax(rng):
    preds, kpts = [], []
    for _ in range(3):
        placed, obs = _cuboid(rng)
        preds.append(placed - placed.mean(0))
        kpts.append(np.concatenate([obs.mean(0, keepdims=True), obs])
                    .reshape(1, -1))
    rec = {"kpts_3d_pred": np.stack(preds), "kpts_2d_pred": kpts, "K": K}
    ours = tref.refine_record(copy.deepcopy(rec))["kpts_3d_refined"]
    theirs = jref.refine_record(copy.deepcopy(rec))["kpts_3d_refined"]
    assert ours.shape == (3, 32, 3)
    np.testing.assert_array_equal(ours, theirs)
    sized = tref.refine_with_perfect_size(preds[0], kpts[0][0, 2:], K,
                                          (3.9, 1.5, 1.6))
    np.testing.assert_array_equal(sized, jref.refine_with_perfect_size(
        preds[0], kpts[0][0, 2:], K, (3.9, 1.5, 1.6)))


@pytest.mark.parametrize("fn", ["get_bbox_3d", "cuboid_triangles",
                                "get_visibility", "ray_intersect_triangle",
                                "get_area"])
def test_points_geometry_equals_jax(rng, fn):
    box = tpts.get_bbox_3d((3.9, 1.5, 1.6), (1.0, 1.6, 12.0), 0.7)
    np.testing.assert_array_equal(box, jpts.get_bbox_3d(
        (3.9, 1.5, 1.6), (1.0, 1.6, 12.0), 0.7))
    tris = tpts.cuboid_triangles(box)
    if fn == "cuboid_triangles":
        np.testing.assert_array_equal(tris, jpts.cuboid_triangles(box))
        assert tris.shape == (12, 3, 3)
    elif fn == "get_visibility":
        vis = tpts.get_visibility(box, tris)
        np.testing.assert_array_equal(vis, jpts.get_visibility(box, tris))
        assert 0 < vis.sum() < 8
    elif fn == "ray_intersect_triangle":
        for p0 in rng.randn(20, 3) * 3 + [0, 0, 12]:
            for tri in tris:
                assert (tpts.ray_intersect_triangle(p0, np.zeros(3), tri)
                        == jpts.ray_intersect_triangle(p0, np.zeros(3), tri))
    elif fn == "get_area":
        pts = rng.randn(9, 2)
        idx = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8], [1, 3, 8]])
        for keep in (False, True):
            np.testing.assert_array_equal(
                tpts.get_area(pts, idx, keep), jpts.get_area(pts, idx, keep))


MATS = {"scale": [[0.5, 0.0, 20.0], [0.0, 0.5, 10.0]],
        "rotate": [[0.8, -0.3, 40.0], [0.25, 0.9, -5.0]],
        "outside": [[1.3, 0.1, -30.0], [-0.1, 1.2, 50.0]]}


@pytest.mark.parametrize("name", sorted(MATS))
def test_warp_affine_equals_jax(rng, name):
    img = rng.uniform(0, 255, (60, 90, 3)).astype(np.float32)
    mat = np.asarray(MATS[name], np.float32)
    ours = taff.warp_affine(torch.from_numpy(img), torch.from_numpy(mat),
                            (40, 48)).numpy()
    theirs = np.asarray(jaff.warp_affine(jnp.asarray(img), jnp.asarray(mat),
                                         (40, 48)))
    assert ours.shape == (40, 48, 3)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
    if name == "outside":
        assert (ours == 0).any()


def test_warp_instances_equals_jax(rng):
    img = rng.uniform(0, 1, (50, 70, 3)).astype(np.float32)
    mats = np.asarray([MATS[k] for k in sorted(MATS)], np.float32)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    ours = taff.warp_instances(torch.from_numpy(img), torch.from_numpy(mats),
                               (32, 32), torch.from_numpy(mean),
                               torch.from_numpy(std)).numpy()
    theirs = np.asarray(jaff.warp_instances(
        jnp.asarray(img), jnp.asarray(mats), (32, 32), jnp.asarray(mean),
        jnp.asarray(std)))
    # 1e-4 on a 0-255 scale, through the normalization's 1/std
    np.testing.assert_allclose(ours, theirs, atol=1e-4 / 255 / std.min())


@pytest.mark.parametrize("center,size", [((30, 20), (10, 8)),
                                         ((2, 3), (12, 9)),
                                         ((85, 55), (20, 15))])
def test_simple_crop_bit_equal(rng, center, size):
    img = rng.randint(0, 255, (60, 90, 3), np.uint8)
    ours = taff.simple_crop(img, center, size)
    np.testing.assert_array_equal(ours, jaff.simple_crop(img, center, size))
    assert ours.shape == (2 * size[1], 2 * size[0], 3)


def test_save_cropped_patches_same_crops(rng, tmp_path):
    import cv2
    img = rng.randint(0, 255, (80, 120, 3), np.uint8)
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(png.encode(img))
    kpts = np.concatenate([rng.uniform(5, 110, (3, 9, 1)),
                           rng.uniform(5, 75, (3, 9, 1)),
                           (rng.rand(3, 9, 1) > 0.3).astype(float)], axis=2)
    kpts[:2, :3, 2] = 1.0
    kpts[2, :, 2] = 0.0                       # 1 of 9 visible: skipped
    kpts[2, 0, 2] = 1.0
    ours = taff.save_cropped_patches(path, kpts, str(tmp_path / "t"))
    theirs = jaff.save_cropped_patches(path, kpts, str(tmp_path / "j"))
    assert [os.path.basename(p)[:-4] for p in ours[0]] == [
        os.path.basename(p)[:-4] for p in theirs[0]] == [
        "instance_0", "instance_1"]
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2]
    for i, p in enumerate(ours[0]):
        center, size, _, _ = jaff.kpts2cs(kpts[i], 1.4)
        np.testing.assert_array_equal(
            png.decode(p), jaff.simple_crop(cv2.imread(path)[:, :, ::-1],
                                            center, size))


@pytest.fixture(scope="module")
def records():
    """Per-image records of the port's shrunk fp32 facade on two frames
    (with GT cuboids, so the 2D overlay draws orientation arrows)."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    cfg = fixtures.shrink_hrnet(demo_config())
    cfg["bf16"] = False
    model = EgoNet(cfg, device="cpu")
    rng = np.random.RandomState(2)
    annot = {"path": [], "boxes": [], "K": [], "raw_txt_format": [],
             "kpts_3d_gt": []}
    for i in range(2):
        placed = [_cuboid(rng)[0] for _ in range(2)]
        proj = [p @ K.T for p in placed]
        uv = [q[:, :2] / q[:, 2:] for q in proj]
        boxes = np.asarray([[u[:, 0].min(), u[:, 1].min(), u[:, 0].max(),
                             u[:, 1].max()] for u in uv])
        annot["path"].append(f"{i:06d}.png")
        annot["boxes"].append(boxes)
        annot["K"].append(K)
        annot["kpts_3d_gt"].append(np.stack(
            [np.concatenate([p.mean(0, keepdims=True), p]) for p in placed]))
        annot["raw_txt_format"].append([
            {"class": "Car", "truncation": 0.0, "occlusion": 0.0,
             "alpha": -1.0, "bbox": list(b), "dimensions": [1.5, 1.6, 3.9],
             "locations": [1.0, 1.6, 12.0], "rot_y": 0.0, "score": 0.9}
            for b in boxes])
    annot["images"] = [rng.randint(0, 255, (375, 1242, 3), np.uint8)
                       for _ in range(2)]
    return model, annot, model(annot)


def test_post_process_visualize_refine_matches_jax(records, tmp_path,
                                                   monkeypatch):
    """The same records through both packages' post_process with
    visualize and refine: the same txts, the same refined cuboids, and
    both overlays written."""
    from egonet_tpu.config import default_demo_config
    from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
    model, annot, recs = records
    frames = {}
    for p, img in zip(annot["path"], annot["images"]):
        frames[p] = str(tmp_path / p)
        with open(frames[p], "wb") as f:
            f.write(png.encode(img))
    jmodel = JaxEgoNet(fixtures.shrink_hrnet(default_demo_config()))
    out = {}
    for name, m in (("torch", model), ("jax", jmodel)):
        d = tmp_path / name
        d.mkdir()
        rs = {frames[p]: copy.deepcopy(r) for p, r in recs.items()}
        out[name] = m.post_process(
            rs, save_dict={"flag": True, "save_dir": str(d)},
            visualize=True, refine=True)
    for p in annot["path"]:
        stem = p[:-4]
        for name in ("torch", "jax"):
            d = tmp_path / name
            for suffix in ("_2d.png", "_3d.png"):
                assert os.path.getsize(d / (stem + suffix)) > 1000
        assert ((tmp_path / "torch" / (stem + ".txt")).read_text()
                == (tmp_path / "jax" / (stem + ".txt")).read_text())
        a, b = out["torch"][frames[p]], out["jax"][frames[p]]
        np.testing.assert_array_equal(a["kpts_3d_refined"],
                                      b["kpts_3d_refined"])
        np.testing.assert_array_equal(a["arrow"], b["arrow"])
    # the 2D overlay is the port's PNG of the frame it was given
    assert png.image_size(str(tmp_path / "torch" / "000000_2d.png"))[0] > 0


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_inference_vis",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "inference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli_cfg(cfg, root, pred_dir, out):
    cfg = fixtures.shrink_hrnet(cfg)
    cfg["dataset"]["root"] = root
    cfg["dirs"] = {"output": out, "ckpt": out + "_ckpt",
                   "load_prediction_file": pred_dir}
    cfg["pre_trained"] = False
    cfg["bf16"] = False
    cfg["testing_settings"]["batch_size"] = 2
    return cfg


def test_cli_visualize_writes_overlays_like_jax(tmp_path):
    """The inference CLI with --visualize true: both packages write the
    same overlay files beside the txts, and txts equal outside the
    angles."""
    from egonet_tpu.config import default_demo_config
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.tools import inference
    root, pred_dir = fixtures.make_kitti_root(tmp_path, n_images=4,
                                              with_predictions=True,
                                              smooth=True)
    jcfg = _cli_cfg(default_demo_config(), root, pred_dir,
                    str(tmp_path / "out_jax"))
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({k: v for k, v in jcfg.items()
                        if k != "config_path"}, f)
    _jax_cli().main(["--cfg", cfg_path, "--visualize", "true"])
    tcfg = _cli_cfg(demo_config(), root, pred_dir, str(tmp_path / "out_t"))
    tcfg.update(device="cpu", visualize=True)
    inference.main(cfgs=tcfg)
    for path in ("gt_box_test", "submission"):
        dj = tmp_path / "out_jax" / path / "data"
        dt = tmp_path / "out_t" / path / "data"
        names = sorted(os.listdir(dj))
        assert names == sorted(os.listdir(dt))
        assert sum(n.endswith("_2d.png") for n in names) == 2
        assert sum(n.endswith("_3d.png") for n in names) == 2
        for n in names:
            if not n.endswith(".txt"):
                continue
            for a, b in zip((dj / n).read_text().split("\n"),
                            (dt / n).read_text().split("\n")):
                fa, fb = a.split(" "), b.split(" ")
                assert len(fa) == len(fb)
                for i, (x, y) in enumerate(zip(fa, fb)):
                    if i in (3, 14):
                        d = abs(float(x) - float(y)) % (2 * np.pi)
                        assert min(d, 2 * np.pi - d) < 1e-3
                    else:
                        assert x == y, (n, i, x, y)
