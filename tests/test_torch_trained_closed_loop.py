"""The port's from-scratch trained closed loop
(``egonet_tpu_torch/tools/trained_closed_loop.py``) against the JAX
package's (``tests/test_trained_closed_loop.py``, read and not run here: it
trains for ~1 h), on the CPU:

* the tool's recipe constants are the JAX test module's;
* its world (``synthetic_world.make_cars_world``) is the JAX fixture's:
  labels, calibrations, splits and detector txts byte for byte, frames
  pixel for pixel, on a few frames;
* for each family, its heatmap config is the JAX fixture's, and its first
  step equals the JAX ``IGRTrainer``'s in float64 (the bars and method of
  tests/test_torch_train.py).  The donor test of
  tests/test_torch_scratch_tools.py holds another stanza (enlargement
  1.21, cars and pedestrians, 18 instances) in fp32 only;
* the tool end to end on the CPU for both families at a tiny size
  (TINY_ARGS): its files, KITTI lines that parse, its launch-count
  plumbing and its bars;
* the checkpoints that run wrote load into the JAX ``EgoNet`` through
  ``egonet_tpu/io/torch_convert.py``, and both packages' fp32 inference on
  them agrees within the slice bars (kpts 1e-3 px, angles 1e-4 rad; the
  JAX ``_core`` run eagerly: under ``jit`` its CPU warp rounds a few crop
  pixels differently, ROADMAP section 3);
* the slow leg: the full recipe on the CPU at the JAX bars, only with
  EGONET_SLOW_TESTS set, as the JAX test.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.tools import synthetic_world as sw
from egonet_tpu_torch.tools import trained_closed_loop as tcl
from egonet_tpu_torch.train import igrs as tigrs
from tests import fixtures
from tests import test_trained_closed_loop as jtest
from tests.test_torch_train import (LOSS_TOL, STATS_TOL, TENSOR_TOL,
                                    _compare, _compare_grads, _f64,
                                    _igr_batch)

torch.set_num_threads(2)
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "egonet_tpu",
                       "configs")
# 32 frames: the fewest at which the detector-box path's AP_R11 easy is the
# protocol's 100 on this world (24 give 81.8: too few thresholds); 14
# epochs of 3 steps: the heatmap loss halves in both families (the tool's
# own bar).  AOS is far from 85 at this length, so its bar is lowered
TINY_ARGS = ["--images", "32", "--epochs", "14", "--aos-min", "0"]
WORLD_FRAMES = 6
KPTS_PX, ANGLE_RAD = 1e-3, 1e-4


def test_recipe_constants_are_the_jax_tests():
    assert tcl.N_IMAGES == jtest.N_IMAGES
    assert tcl.CARS_PER_IMAGE == jtest.CARS_PER_IMAGE
    assert tcl.HC_EPOCHS == jtest.HC_EPOCHS
    assert tcl.AOS_EASY_MIN == jtest.AOS_EASY_MIN


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)), (a, b)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), (a, n)
    return names


def test_world_equals_the_jax_fixture(tmp_path):
    from egonet_tpu_torch.data.png import decode
    rng = np.random.RandomState(3)
    scenes = [fixtures.random_cars(rng, jtest.CARS_PER_IMAGE)
              for _ in range(WORLD_FRAMES)]
    root, pred = fixtures.make_kitti_root(
        tmp_path / "fixture", n_images=WORLD_FRAMES, with_predictions=True,
        classes_per_image=scenes, draw_keypoints=True)
    oroot, opred = sw.make_cars_world(tmp_path / "port", WORLD_FRAMES)
    train, otrain = (os.path.join(r, "training") for r in (root, oroot))
    for sub in ("label_2", "calib", "ImageSets"):
        _same_files(os.path.join(train, sub), os.path.join(otrain, sub))
    assert len(_same_files(pred, opred)) == WORLD_FRAMES
    frames = sorted(os.listdir(os.path.join(train, "image_2")))
    assert frames == sorted(os.listdir(os.path.join(otrain, "image_2")))
    for n in frames:
        got = decode(os.path.join(otrain, "image_2", n))
        np.testing.assert_array_equal(
            got, decode(os.path.join(train, "image_2", n)), err_msg=n)
        assert (got != 60).any(), n              # the key points are drawn


def _jax_heatmap_config(family, root):
    """The JAX fixture's heatmap config (tests/test_trained_closed_loop.py,
    stage 2)."""
    from egonet_tpu.config import load_config
    cfg = load_config(os.path.join(CONFIGS, "KITTI_train_IGRs.yml"))
    cfg["dataset"]["root"] = root
    jtest._shrink_backbone(cfg, family)
    cfg["heatmapModel"]["pretrained"] = ""
    cfg["dataset"]["enlarge_factor"] = 1.32
    cfg["heatmapModel"]["jitter_params"] = {"scaling": [0.2, 0.2],
                                            "shift": [0.05, 0.05]}
    cfg["optimizer"]["milestones"] = [100000]
    cfg["training_settings"].update({"batch_size": 6, "total_epochs": 1})
    return cfg


def _same_config(port, jax_cfg):
    """The port's config is the JAX one but for the keys its YAML loader
    adds."""
    assert set(jax_cfg) - set(port) <= {"config_path", *tcfg._DEFAULTS}
    assert port == {k: v for k, v in jax_cfg.items() if k in port}


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    root, _ = sw.make_cars_world(tmp_path_factory.mktemp("tcl_world"),
                                 WORLD_FRAMES)
    return root


@pytest.mark.parametrize("family", tcl.FAMILIES)
def test_first_heatmap_step_equals_jax_in_float64(small_world, family):
    """The recipe's first step (Adam at 1e-3, cross-ratio off, the
    loader's first batch of 16 instances) from the same initial values:
    the loss and its components, every gradient, the stepped parameters
    and the BN running statistics."""
    from egonet_tpu.models.initialization import numpy_init as jinit
    from egonet_tpu.train.igrs import IGRTrainer as JT
    cfg = tcl.heatmap_config(family, small_world)
    _same_config(cfg, _jax_heatmap_config(family, small_world))
    assert cfg["optimizer"]["optim_type"] == "adam"
    batch, crops = _igr_batch(cfg, max_instances=16)
    pt = tigrs.IGRTrainer(cfg, dtype=torch.float64, device="cpu")
    state = pt.init_state(0)
    got = pt._crops_from_batch(pt._device_batch(batch)).numpy()
    np.testing.assert_array_equal(got, crops)
    size = cfg["heatmapModel"]["input_size"][0]
    with jax.enable_x64(True):
        jt = JT(cfg, dtype=jnp.float64)
        var = _f64(jinit(jt.model, 0, jnp.zeros((1, size, size, 3))))
        params, bs = var["params"], var["batch_stats"]
        opt = jt.tx.init(params)
        jt._crops_from_batch = lambda b: b["crops"]
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}
        jb["crops"] = jnp.asarray(crops)
        (loss, (bs, comps)), g = jax.jit(
            jax.value_and_grad(jt._loss_fn, has_aux=True),
            static_argnums=3)(params, bs, jb, False)
        u, opt = jax.jit(jt.tx.update)(g, opt, params)
        params = jax.tree_util.tree_map(lambda p, d: p + d, params, u)
        state, metrics = pt.train_step(state, batch, False)
        for k in ("loss", *comps):
            want = float(loss if k == "loss" else comps[k])
            err = abs(float(metrics[k]) - want) / abs(float(loss))
            assert err <= LOSS_TOL, (k, err)
        _compare_grads(state.model, g, bs)
        _compare(state.model, {"params": params, "batch_stats": bs},
                 TENSOR_TOL, STATS_TOL, what=f"{family} step 0")


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tool on the CPU, both families, at TINY_ARGS, keeping its files;
    (its lines, what it printed last, its directory)."""
    import contextlib
    import io
    out = str(tmp_path_factory.mktemp("tcl_run"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        lines = tcl.main(TINY_ARGS + ["--out", out], device="cpu")
    return {"lines": {ln["family"]: ln for ln in lines}, "out": out,
            "printed": printed.getvalue().strip().splitlines()}


@pytest.mark.parametrize("family", tcl.FAMILIES)
def test_tool_end_to_end_on_the_cpu(tiny_run, family):
    """Files, KITTI lines, the line's keys and the launch plumbing: on the
    CPU each wrapper runs its plain version (no launch), while the line
    still says how many blocks the card would launch per forward; the bars
    fail a card's line that launched no kernel."""
    line = tiny_run["lines"][family]
    assert json.loads([p for p in tiny_run["printed"]
                       if f'"family": "{family}"' in p][0]) == line
    legs = [leg for leg, *_ in tcl.LEGS[family]]
    for key in ("ap_r11_easy", "aos_r11_easy", "cpp_aos_r11_easy",
                "infer_s", "launches"):
        assert sorted(line[key]) == sorted(legs), key
    assert (line["images"], line["epochs"], line["device"]) == (32, 14, "cpu")
    assert line["lifter_shared"] and line["train_s"] > 0
    assert line["lifter_loss"] == tiny_run["lines"]["hrnet"]["lifter_loss"]
    assert line["heatmap_loss"][1] < 0.5 * line["heatmap_loss"][0]
    out = tiny_run["out"]
    ck = os.path.join(out, family, "ckpt")
    assert sorted(os.listdir(ck)) == ["HC.pth", "L.pth", "LS.npy"]
    pred_dir = os.path.join(out, "world", "preds")
    val = sorted(os.listdir(pred_dir))[16:]
    for leg in legs:
        assert line["ap_r11_easy"][leg] == 100.0
        assert 0 < line["aos_r11_easy"][leg] <= 100.0
        sub = os.path.join(out, family, leg, "submission", "data")
        assert sorted(os.listdir(sub)) == val
        for name in val:
            with open(os.path.join(pred_dir, name)) as f:
                det = [ln.split() for ln in f.read().splitlines() if ln]
            with open(os.path.join(sub, name)) as f:
                got = [ln.split() for ln in f.read().splitlines() if ln]
            assert len(got) == len(det) == tcl.CARS_PER_IMAGE
            for g, d in zip(got, det):
                assert len(g) == 16 and g[0] == "Car"
                vals = np.array(g[1:], np.float64)
                assert np.isfinite(vals).all()
                # only alpha (3) and rot_y (14) are the model's
                for i in set(range(1, 15)) - {3, 14}:
                    assert float(g[i]) == pytest.approx(float(d[i]),
                                                        abs=1e-2), (i, g, d)
        n = line["launches"][leg]
        hr = family == "hrnet"
        assert n["forwards"] == (4 if hr else 0)       # 16 frames, batch 4
        assert n["fused_basic_block"] == n["fused_basic_block_stencil"] == 0
        assert n["routed_per_forward"] == (6 if hr and leg != "fp32" else 0)
    if family == "hrnet":
        assert line["launches_per_forward"] == dict.fromkeys(tcl.KERNELS, 0.0)
        # the model's own routing: the width-8 blocks run unfused
        from egonet_tpu_torch.models.hrnet import build_hrnet
        net = build_hrnet(sw.gate_shrink("hrnet")(tcfg.demo_config()),
                          dtype=torch.bfloat16)
        for stencil in (False, True):
            assert [blk.conv2.out_channels
                    for blk in net._fusable_blocks(stencil)] \
                == [16, 16, 32, 16, 32, 64]
    tcl.check(line, torch.device("cpu"), 0.0)
    with pytest.raises(AssertionError, match="AOS"):
        tcl.check(line, torch.device("cpu"), 100.5)
    if family == "hrnet":
        with pytest.raises(AssertionError, match="expected .*24"):
            tcl.check(line, torch.device("cuda"), 0.0)
    else:
        tcl.check(line, torch.device("cuda"), 0.0)


@pytest.mark.parametrize("family", tcl.FAMILIES)
def test_port_checkpoint_runs_alike_in_both_packages(tiny_run, family):
    """The tool's HC.pth / L.pth / LS.npy through the JAX EgoNet (its
    torch_convert loader and check_conversion) and the port's EgoNet, both
    fp32, on two validation frames of the detector-box path."""
    from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.tools.inference import gather_dict
    out = tiny_run["out"]
    root = os.path.join(out, "world", "KITTI")
    pred_dir = os.path.join(out, "world", "preds")
    fc = sw.lifter_config(root)["FCModel"]
    cfg = tcl.inference_config(family, root, pred_dir,
                               os.path.join(out, family, "ckpt"),
                               os.path.join(out, "unused"), fc, "cpu", False)
    ds = kitti.get_dataset(cfg, None, "valid")
    preds = ds.read_predictions(pred_dir)
    annot = gather_dict({"path": [ds.paths.image_path(n)
                                  for n in ds.image_names[:2]]}, preds,
                        target_ar=1.0, enlarge=1.2)
    jcfg = dict(cfg)
    jcfg.pop("device")
    j = JaxEgoNet(jcfg, pre_trained=True, dtype=jnp.float32)
    j._get_jitted = lambda alpha_mode, packed=False: functools.partial(
        j._core_packed if packed else j._core, alpha_mode=alpha_mode)
    t = EgoNet(cfg, pre_trained=True, device="cpu")
    assert t.dtype == torch.float32
    rj = j.forward_annot_dict(annot, enlarge=1.1)
    rt = t.forward_annot_dict(annot, enlarge=1.1)
    assert list(rj) == list(rt) and len(rj) == 2
    worst = {"kpts": 0.0, "angles": 0.0}
    for p in rj:
        kj = np.concatenate(rj[p]["kpts_2d_pred"])
        kt = np.concatenate(rt[p]["kpts_2d_pred"])
        assert kj.shape == kt.shape and kj.size == tcl.CARS_PER_IMAGE * 66
        worst["kpts"] = max(worst["kpts"], float(np.abs(kj - kt).max()))
        for key in ("euler_angles", "alphas"):
            d = np.abs(np.asarray(rj[p][key], np.float64)
                       - np.asarray(rt[p][key], np.float64)) % (2 * np.pi)
            worst["angles"] = max(worst["angles"],
                                  float(np.minimum(d, 2 * np.pi - d).max()))
    print(f"{family}: port vs JAX on the port's checkpoint {worst}")
    assert worst["kpts"] < KPTS_PX and worst["angles"] < ANGLE_RAD, worst


@pytest.mark.skipif(
    not os.environ.get("EGONET_SLOW_TESTS"),
    reason="trained closed loop trains for ~1 h; set EGONET_SLOW_TESTS=1")
def test_full_recipe_scores_high_aos_on_the_cpu(tmp_path):
    """The full recipe (256 frames, 60 epochs, both families) at the JAX
    test's bars: the tool holds AP_R11 easy > 99 and AOS_R11 easy >= 85 on
    every leg, and the C++ AOS equal to the Python one where the binary
    builds."""
    from egonet_tpu_torch.eval.native import ensure_evaluator
    lines = tcl.main(["--out", str(tmp_path)], device="cpu")
    assert [ln["family"] for ln in lines] == list(tcl.FAMILIES)
    for line in lines:
        for leg, aos in line["aos_r11_easy"].items():
            assert aos >= jtest.AOS_EASY_MIN, (line["family"], leg, aos)
            assert line["ap_r11_easy"][leg] > tcl.AP_EASY_MIN
            if ensure_evaluator() is not None:
                assert line["cpp_aos_r11_easy"][leg] == pytest.approx(
                    aos, abs=tcl.CPP_AOS_TOL)
