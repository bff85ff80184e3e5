"""The port's leg of tests/test_closed_loop.py, at its recipe and its bars:
train the port's lifter on the synthetic KITTI pairs (the port's world,
``synthetic_world.make_kitti_root``: the fixture's labels and calibrations
byte for byte), lift the validation split's GT screen keypoints, recover
rot_y through the port's template fit + rotation solve + euler angles,
write KITTI txts with the port's writer and score AOS with the port's
evaluator: mean yaw error under 8 deg, AOS above 0.9 x AP.  Then the JAX
``rigid.six_dof_from_cuboids`` and the port's give the same yaw on the
port lifter's cuboids (1e-4 rad)."""

import os

import numpy as np
import pytest
import torch

from egonet_tpu_torch.data import kitti
from egonet_tpu_torch.eval import kitti_eval as ke
from egonet_tpu_torch.geometry import rigid
from egonet_tpu_torch.io import kitti_writer
from egonet_tpu_torch.tools import synthetic_world as sw
from egonet_tpu_torch.train.lifting import LiftingTrainer

torch.set_num_threads(2)
YAW_TOL = 1e-4


@pytest.fixture(scope="module")
def lifted(tmp_path_factory):
    """The lifter trained on the CPU (the JAX test's recipe, which
    ``synthetic_world.lifter_config`` is), its history, and the validation
    cuboids it lifts."""
    tmp = tmp_path_factory.mktemp("loop")
    root, _ = sw.make_kitti_root(tmp, n_images=2)
    cfg = sw.lifter_config(root)
    train_set, valid_set = kitti.prepare_data(cfg)
    steps = max(1, len(train_set.input) // 128)
    trainer = LiftingTrainer(cfg, steps_per_epoch=steps, device="cpu")
    state, history = trainer.fit(train_set)
    stats = train_set.statistics
    preds = (trainer.predict(state, valid_set.input) * stats["std_out"]
             + stats["mean_out"])
    return {"tmp": tmp, "root": root, "cfg": cfg, "history": history,
            "cuboids": preds.reshape(len(preds), 32, 3)}


def test_recipe_is_the_jax_tests(lifted):
    """``lifter_config`` is the JAX test's config (but for the keys its
    YAML loader adds)."""
    from egonet_tpu.config import load_config
    from egonet_tpu_torch import config as tcfg
    here = os.path.join(os.path.dirname(__file__), "..", "egonet_tpu",
                        "configs")
    jcfg = load_config(os.path.join(here, "KITTI_train_lifting.yml"))
    jcfg["dataset"]["root"] = lifted["root"]
    jcfg["training_settings"].update(
        {"total_epochs": 150, "batch_size": 128, "lft_aug_times": 40})
    jcfg["FCModel"].update({"input_size": 66, "output_size": 96,
                            "num_neurons": 256, "dropout": 0.0})
    jcfg["optimizer"]["milestones"] = [60, 100]
    pcfg = lifted["cfg"]
    assert set(jcfg) - set(pcfg) <= {"config_path", *tcfg._DEFAULTS}
    assert pcfg == {k: v for k, v in jcfg.items() if k in pcfg}


def test_lifter_learns_orientation_end_to_end(lifted):
    history = lifted["history"]
    assert history[-1]["loss"] < history[0]["loss"] * 0.1
    angles, _ = rigid.six_dof_from_cuboids(
        torch.from_numpy(lifted["cuboids"]))
    ry_pred = angles[:, 1].numpy().astype(np.float64)

    # ground-truth yaw for the valid split (same generation path, no aug)
    root = lifted["root"]
    paths = kitti.KITTIPaths(root, "valid")
    gt_ry = []
    for name in paths.image_names():
        pairs = kitti.get_2d_3d_pairs(paths.label_path(name),
                                      paths.calib_path(name))
        gt_ry.extend(rot[0, 1] for rot in pairs["rotations"])
    gt_ry = np.array(gt_ry)
    assert len(gt_ry) == len(ry_pred)
    err = np.abs(np.arctan2(np.sin(ry_pred - gt_ry),
                            np.cos(ry_pred - gt_ry)))
    mean_err_deg = np.degrees(err.mean())
    print(f"port lifter loop: mean yaw error {mean_err_deg:.3f} deg")
    assert mean_err_deg < 8.0, f"mean yaw error {mean_err_deg:.2f} deg"

    # KITTI txts with the recovered angles (alpha by the 'trans'
    # convention from the labelled location), scored for AOS
    result_dir = str(lifted["tmp"] / "results")
    data_dir = os.path.join(result_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    i = 0
    for name in paths.image_names():
        pairs = kitti.get_2d_3d_pairs(paths.label_path(name),
                                      paths.calib_path(name))
        n = len(pairs["raw"])
        euler = np.zeros((n, 3))
        alphas = np.zeros(n)
        for j, raw in enumerate(pairs["raw"]):
            euler[j, 1] = ry_pred[i]
            x, _, z = raw["locations"]
            a = ry_pred[i] - np.arctan2(-z, x) - 0.5 * np.pi
            alphas[j] = np.arctan2(np.sin(a), np.cos(a))
            raw["score"] = 0.99 - 0.01 * j
            i += 1
        pred_str = kitti_writer.prediction_str(pairs["raw"], euler, alphas)
        with open(os.path.join(data_dir, name[:-3] + "txt"), "w") as f:
            f.write(pred_str)
    results = ke.evaluate(os.path.join(root, "training", "label_2"),
                          result_dir, metrics=("image",), write_stats=False)
    aos = results["car"]["image"]["easy"]["aos_r11"]
    ap = results["car"]["image"]["easy"]["ap_r11"]
    assert ap == pytest.approx(100.0 * 1 / 11, rel=0.5)  # few thresholds
    # orientation similarity close to detection precision => good angles
    assert aos > 0.9 * ap, (aos, ap)


def test_six_dof_yaw_equals_jax_on_the_port_lifters_cuboids(lifted):
    import jax.numpy as jnp
    from egonet_tpu.geometry import rigid as jrigid
    cuboids = lifted["cuboids"].astype(np.float32)
    got, _ = rigid.six_dof_from_cuboids(torch.from_numpy(cuboids))
    ref, _ = jrigid.six_dof_from_cuboids(jnp.asarray(cuboids))
    d = np.asarray(got[:, 1], np.float64) - np.asarray(ref[:, 1], np.float64)
    gap = np.abs(np.arctan2(np.sin(d), np.cos(d))).max()
    print(f"yaw gap port vs JAX rigid: {gap:.3g} rad over {len(d)} cuboids")
    assert gap < YAW_TOL, gap
