"""The port's training CLIs and checkpoints (egonet_tpu_torch/tools/
train_{lifting,igrs}.py, io/checkpoint.py) on a fixture KITTI root, on the
CPU at a shrunk HRNet: the files they write close the loop through the
port's inference CLI and Python evaluator; a HC.pth / L.pth / LS.npy the
port wrote loads into the JAX package (its own converter,
egonet_tpu/io/torch_convert.py) and into the port with strict=True, and
both forwards agree within the slice bars (kpts 1e-3 px, angles 1e-4
rad); a JAX-trained .pth loads into the port strictly; the warm start
from the committed donor keeps the JAX package's filtered keys."""

import copy
import functools
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from egonet_tpu.data import kitti as jk
from egonet_tpu.io import checkpoint as jckpt
from egonet_tpu.io import torch_convert as tc
from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.io import checkpoint as tckpt
from egonet_tpu_torch.io.weights import load_torch_state_dict
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.tools import inference, train_igrs, train_lifting
from tests import fixtures
from tests.test_torch_egonet import _annot, _compare_records

torch.set_num_threads(2)
DONOR = os.path.join(os.path.dirname(__file__), "data", "gate_hrnet_car.pth")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    scenes = [fixtures.random_scene(np.random.RandomState(i), n_cars=3,
                                    n_peds=0) for i in range(4)]
    r, pred = fixtures.make_kitti_root(tmp_path_factory.mktemp("cli"),
                                       n_images=4, classes_per_image=scenes,
                                       with_predictions=True)
    return r, pred


def _lift_cfg(root, out):
    cfg = tcfg.train_lifting_config()
    cfg["dataset"]["root"] = root
    cfg["dirs"] = {"output": out}
    cfg["device"] = "cpu"
    cfg["training_settings"].update(total_epochs=2, lft_aug_times=20,
                                    batch_size=256)
    return cfg


def _igr_cfg(root, out):
    cfg = fixtures.shrink_hrnet(tcfg.train_igrs_config())
    cfg["dataset"]["root"] = root
    cfg["dirs"] = {"output": out}
    cfg["device"] = "cpu"
    cfg["heatmapModel"]["pretrained"] = ""
    cfg["training_settings"].update(total_epochs=2, batch_size=1)
    return cfg


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    """Both CLIs run once; returns (ckpt dir, lifter summary, IGR
    summary)."""
    out = str(tmp_path_factory.mktemp("train_out"))
    lift_cfg = _lift_cfg(root[0], out)
    lift_cfg["visualize"] = True              # the figure, then the files
    lift = train_lifting.main(cfgs=lift_cfg)
    igr = train_igrs.main(cfgs=_igr_cfg(root[0], out))
    assert lift["ckpt_dir"] == igr["ckpt_dir"]
    return lift["ckpt_dir"], lift, igr


def test_lifting_cli_writes_files_with_the_jax_statistics(root, trained):
    ckpt, lift, _ = trained
    assert len(lift["history"]) == 2
    assert all(np.isfinite(h["valid_mse"]) for h in lift["history"])
    stats = np.load(os.path.join(ckpt, "LS.npy"), allow_pickle=True).item()
    jtrain, _ = jk.prepare_data(_lift_cfg(root[0], "unused"))
    for k, v in jtrain.statistics.items():
        np.testing.assert_array_equal(stats[k], v, err_msg=k)
    sd = load_torch_state_dict(os.path.join(ckpt, "L.pth"))
    assert sd["w1.weight"].shape == (1024, 66)
    assert sd["w2.weight"].shape == (96, 1024)
    # visualize: True wrote the evaluation figure before the files, and
    # L.msgpack holds L.pth's tensors as flax reads them
    assert os.path.getsize(os.path.join(os.path.dirname(ckpt),
                                        "lifting_eval.png")) > 0
    flax_tree = jckpt.load_variables(os.path.join(ckpt, "L.msgpack"))
    for k, v in tc.flax_to_torch(flax_tree).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(np.asarray(v), sd[k].numpy(), k)


def test_igr_cli_writes_hc_and_debug_grids(trained):
    ckpt, _, igr = trained
    assert len(igr["history"]) == 2 and igr["params"] > 0
    assert all(np.isfinite(h["loss"]) for h in igr["history"])
    assert os.path.exists(os.path.join(ckpt, "HC.pth"))
    assert len(os.listdir(os.path.join(ckpt, "debug"))) == 8


def _demo_cfg(root, pred, ckpt, out):
    cfg = fixtures.shrink_hrnet(tcfg.demo_config())
    cfg["dataset"]["root"] = root
    cfg["dirs"] = {"output": out, "ckpt": ckpt,
                   "load_prediction_file": pred}
    cfg["pre_trained"] = True
    cfg["device"] = "cpu"
    cfg["bf16"] = False
    return cfg


def test_trained_files_drive_the_inference_cli(root, trained, tmp_path,
                                              monkeypatch):
    """HC.pth + L.pth + LS.npy from the two CLIs -> the port's inference
    CLI on both paths -> KITTI txts scored by the port's Python evaluator
    (the C++ binary hidden)."""
    from egonet_tpu_torch.eval import native
    monkeypatch.setattr(native, "ensure_evaluator", lambda: None)
    ckpt, _, _ = trained
    summary = inference.main(cfgs=_demo_cfg(root[0], root[1], ckpt,
                                            str(tmp_path)))
    assert summary["evaluator"] == "python"
    assert "orientation AP" in summary["evaluation"]
    for sub in ("gt_box_test", "submission"):
        names = os.listdir(tmp_path / sub / "data")
        assert len(names) == 2
        for n in names:
            lines = (tmp_path / sub / "data" / n).read_text().splitlines()
            assert lines and all(len(ln.split()) == 16 for ln in lines)


def test_port_checkpoints_load_into_jax_and_agree(root, trained):
    """The port's HC.pth / L.pth / LS.npy load into the JAX EgoNet (its
    checkpoint loader checks every key and shape) and into the port with
    strict=True; both forwards (fp32, JAX run eagerly) agree within the
    slice bars."""
    ckpt, _, _ = trained
    cfg = _demo_cfg(root[0], root[1], ckpt, "unused")
    j = JaxEgoNet(cfg, pre_trained=True, dtype=jnp.float32)
    j._get_jitted = lambda alpha_mode, packed=False: functools.partial(
        j._core_packed if packed else j._core, alpha_mode=alpha_mode)
    t = EgoNet(cfg, pre_trained=True, dtype=torch.float32, device="cpu")
    hc = load_torch_state_dict(os.path.join(ckpt, "HC.pth"))
    np.testing.assert_array_equal(
        t.hrnet.state_dict()["stage2.0.branches.1.0.bn1.running_var"],
        hc["stage2.0.branches.1.0.bn1.running_var"])
    np.testing.assert_array_equal(
        np.asarray(j.hrnet_vars["batch_stats"]["stage2.0.branches.1.0.bn1"]
                   ["var"]), hc["stage2.0.branches.1.0.bn1.running_var"])
    annot = _annot(seed=3)
    _compare_records(j.forward_annot_dict(annot),
                     t.forward_annot_dict(annot))


def test_jax_trained_pth_loads_into_the_port(root, tmp_path):
    """One JAX IGR step and one JAX lifter step, exported by the JAX
    package's checkpoint writer, load into the port's models strictly,
    value for value."""
    from egonet_tpu.data.loader import IGRBatchLoader
    from egonet_tpu.models.fc_lifter import build_fc_model  # noqa: F401
    from egonet_tpu.train.igrs import IGRTrainer
    from egonet_tpu.train.lifting import LiftingTrainer
    from egonet_tpu_torch.models.fc_lifter import build_fc_model as tfc
    from egonet_tpu_torch.models.hrnet import build_hrnet
    cfg = _igr_cfg(root[0], str(tmp_path))
    jt = IGRTrainer(cfg)
    state = jt.init_state(0)
    records = jk.KITTIDataset(cfg, "train").records
    batch = next(IGRBatchLoader(records, cfg, train=True,
                                max_instances=6).epoch())
    state, _ = jt.train_step(state, batch)
    variables = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    path = jckpt.save_torch_state_dict(str(tmp_path / "HC.pth"), variables)
    model = build_hrnet(cfg)
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    ref = tc.flax_to_torch(variables)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)

    lcfg = _lift_cfg(root[0], str(tmp_path))
    lcfg["FCModel"].update(input_size=66, output_size=96)
    lt = LiftingTrainer(lcfg)
    ls = lt.init_state(0)
    rng = np.random.RandomState(0)
    ls, _ = lt.train_step(ls, {"input": rng.randn(8, 66).astype(np.float32),
                               "output": rng.randn(8, 96).astype(np.float32),
                               "mask": np.ones(8, np.float32)},
                          jax.random.PRNGKey(0))
    lpath = jckpt.save_torch_state_dict(
        str(tmp_path / "L.pth"),
        {"params": jax.device_get(ls.params),
         "batch_stats": jax.device_get(ls.batch_stats)})
    tfc(lcfg).load_state_dict(load_torch_state_dict(lpath), strict=True)


@pytest.mark.parametrize("layers", [None, ["conv1", "bn1", "layer1",
                                           "stage2"]])
def test_warm_start_from_the_donor(layers):
    """``warm_start_variables`` from tests/data/gate_hrnet_car.pth: the
    keys of ``pretrained_layers`` take the donor's values in both
    packages; the rest keep the model's own initialization."""
    from egonet_tpu.models.hrnet import build_hrnet as jbuild
    from egonet_tpu_torch.models.hrnet import build_hrnet
    from egonet_tpu_torch.models.init import numpy_init
    cfg = fixtures.shrink_hrnet(tcfg.train_igrs_config())
    cfg["heatmapModel"]["pretrained"] = DONOR
    if layers is not None:
        cfg["heatmapModel"]["extra"]["pretrained_layers"] = layers
    allowed = cfg["heatmapModel"]["extra"]["pretrained_layers"]
    model = numpy_init(build_hrnet(cfg), 0)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    got = tckpt.warm_start_variables(cfg, model)
    model.load_state_dict(got, strict=True)
    donor = load_torch_state_dict(DONOR)
    jvars = tc.flax_to_torch(jckpt.warm_start_variables(cfg, jbuild(cfg)))
    for k, v in got.items():
        if k.split(".")[0] in allowed:
            assert torch.equal(v, donor[k]), k
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(v.numpy(), jvars[k])
        else:
            assert torch.equal(v, own[k]), k
    assert any(k.split(".")[0] not in allowed for k in got)


def test_warm_start_off_or_missing():
    cfg = fixtures.shrink_hrnet(tcfg.train_igrs_config())
    from egonet_tpu_torch.models.hrnet import build_hrnet
    model = build_hrnet(cfg)
    cfg["heatmapModel"]["pretrained"] = ""
    assert tckpt.warm_start_variables(cfg, model) is None
    cfg["heatmapModel"]["pretrained"] = "no/such/start_point.pth"
    with pytest.raises(ValueError, match="does not exist"):
        tckpt.warm_start_variables(cfg, model)
    assert tckpt.merge_partial({"a": 1, "b": {"c": 2, "d": 3}},
                               {"b": {"c": 5}, "e": 6}) == \
        jckpt.merge_partial({"a": 1, "b": {"c": 2, "d": 3}},
                            {"b": {"c": 5}, "e": 6})


def test_cli_from_yaml_and_unported_options(root, tmp_path):
    """``--cfg <yaml>`` runs the lifter CLI; ``exact_resume: true`` keeps
    the full state under ``<checkpoints>/orbax`` in both CLIs, and a run
    of as many epochs as the latest step resumes there and trains none
    (tests/test_torch_resume.py holds 2 + 1 epochs against 3); a flax
    .msgpack resume starts from its weights (at lr 0 the parameters come
    out as they went in; tests/test_torch_msgpack.py resumes from a
    JAX-written one)."""
    cfg = _lift_cfg(root[0], str(tmp_path))
    cfg["training_settings"].update(total_epochs=1, lft_aug_times=2)
    path = tmp_path / "lift.yml"
    path.write_text(yaml.safe_dump(cfg))
    out = train_lifting.main(["--cfg", str(path)])
    assert os.path.exists(os.path.join(out["ckpt_dir"], "L.pth"))
    for main, make, name in ((train_lifting.main, _lift_cfg, "L.pth"),
                             (train_igrs.main, _igr_cfg, "HC.pth")):
        resume = make(root[0], str(tmp_path / name))
        resume["training_settings"].update(exact_resume=True,
                                           total_epochs=1, lft_aug_times=2)
        first = main(cfgs=resume)
        assert os.listdir(os.path.join(first["ckpt_dir"], "orbax")) == ["1"]
        before = load_torch_state_dict(os.path.join(first["ckpt_dir"], name))
        again = main(cfgs=resume)
        assert again["history"] == []
        after = load_torch_state_dict(os.path.join(again["ckpt_dir"], name))
        for k, v in before.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(after[k]))
    flax = _igr_cfg(root[0], str(tmp_path / "flax"))
    flax["optimizer"]["lr"] = 0.0
    flax["training_settings"].update(total_epochs=1, resume=(
        tckpt.save_variables(str(tmp_path / "HC.msgpack"), before)))
    out = train_igrs.main(cfgs=flax)
    resumed = load_torch_state_dict(os.path.join(out["ckpt_dir"], "HC.pth"))
    for k, v in before.items():
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            assert torch.equal(resumed[k], v), k


def test_profile_model_train_splits_one_step_by_stage(tmp_path):
    """``profile_model --train`` traces IGR train steps (bf16, the JAX
    tool's synthetic batch of 24 frames and 140 crops) and charges the time
    to ``profiling.TRAIN_SPANS`` (host time on the CPU)."""
    from egonet_tpu_torch.tools import profile_model
    from egonet_tpu_torch.utils import profiling
    cfg = fixtures.shrink_hrnet(tcfg.train_igrs_config())
    summary = profile_model.main(
        ["--train", "--iters", "1", "--trace-dir", str(tmp_path)],
        cfgs=cfg, device="cpu")
    assert list(summary["by_span"]) == list(profiling.TRAIN_SPANS)
    for span in ("warp", "forward", "backward", "optimizer"):
        assert summary["host_by_span"][span] > 0, span
    assert summary["idle"] is None                 # no device on the CPU
    with pytest.raises(ValueError, match="unknown span"):
        profiling.span("no_such_stage")


@pytest.mark.parametrize("which", ["native", "pedestrian"])
def test_profile_model_takes_the_native_and_pedestrian_configs(tmp_path,
                                                                which):
    """``profile_model`` on the native and the W32 pedestrian training
    configs (shrunk): inference charges the keypoint model to the
    ``backbone`` span; ``--train`` splits a step by stage."""
    from egonet_tpu_torch.tools import profile_model
    from egonet_tpu_torch.utils import profiling
    cfg = (fixtures.shrink_tpu_native(tcfg.tpu_native_config(),
                                      grid_stride=8)
           if which == "native"
           else fixtures.shrink_hrnet(tcfg.train_igrs_ped_config()))
    summary = profile_model.main(
        ["--iters", "1", "--batch", "4", "--trace-dir", str(tmp_path)],
        cfgs=cfg, device="cpu")
    assert list(summary["by_span"]) == list(profiling.SPANS)
    assert summary["host_by_span"]["backbone"] > 0
    summary = profile_model.main(
        ["--train", "--iters", "1", "--trace-dir", str(tmp_path / "t")],
        cfgs=cfg, device="cpu")
    assert summary["host_by_span"]["forward"] > 0
