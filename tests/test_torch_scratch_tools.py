"""The port's from-scratch tools (``egonet_tpu_torch/tools/
make_gate_artifacts.py``, ``record_native_fullwidth.py``) against the JAX
package's root tools, on the CPU.

* Donor training: the port's ``train_donor`` (through the tool's ``main``)
  against the JAX recipe of ``tools/make_gate_artifacts.train_donor``,
  rebuilt here (the root tool sets JAX's global matmul precision and
  compilation cache at import, so it is not imported), for two epochs on
  a world of 108 frames at the gate's shrunk HRNet width, from the same
  initial values: the recipe's config equal to the JAX one, then fp32
  bars on the first steps' losses, every epoch's loss and the final
  parameters.  In fp32 the two packages round independently, and under
  Adam a gradient within rounding of zero steps a weight by the full rate
  either way: the runs drift apart step by step (the exact parity of the
  trainers is held in fp64 by ``tests/test_torch_train.py``), so the
  later bars are those of that drift, measured (see each constant).
* Sidecars: ``--sidecar-only`` on copies of the committed donors rewrites
  sidecars whose val px equal the committed ones within 0.01 px.
* Donor format: a donor the port writes has the committed donor's keys,
  shapes and dtypes, and warm-starts both packages' trainers.
* The full-width tool end to end at a shrunk native width.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.io import checkpoint
from egonet_tpu_torch.tools import make_gate_artifacts as mga
from egonet_tpu_torch.tools import record_native_fullwidth as rnf
from egonet_tpu_torch.tools import synthetic_world as sw
from egonet_tpu_torch.train import igrs as tigrs
from tests import fixtures

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "data")

# 54 training frames: 9 steps an epoch, the fewest at which the hrnet
# donor's loss halves over two epochs (the tool's own assert)
DONOR_IMAGES = 108
DONOR_EPOCHS = 2
MILESTONES = [90, 130]
# fp32 bars of the port's donor training against the JAX recipe's (JAX
# under jit on the CPU; relative gaps).  The first step's loss (the same
# initial values on the same batch) is held tightly; from the second step
# on, the drift: one Adam step already moves the loss by 0.8%, and the
# port's own run at 2 and at 4 torch threads differs by 2.4% at epoch 0
FIRST_STEP_TOL = 1e-3              # measured 1.7e-5
EPOCH_LOSS_TOL = 0.1               # measured 3.1e-2, 2.8e-2 (2 threads)
# |params_port - params_jax| / |params_jax - params_init| (L2 over every
# parameter): below 1, the port lies nearer the JAX run's end than an
# untrained model does (measured 0.720 at 2 and at 4 threads)
PARAM_DRIFT_TOL = 0.9
SIDECAR_PX_TOL = 0.01


def _jax_donor(root, epochs, milestones):
    """The JAX recipe of ``tools/make_gate_artifacts.train_donor`` (hrnet
    family, seed 0) on ``root``: (its config, each step's loss, each
    epoch's last loss, the final variables)."""
    import jax
    from egonet_tpu.config import load_config
    from egonet_tpu.data import kitti
    from egonet_tpu.data.loader import IGRBatchLoader
    from egonet_tpu.train.igrs import IGRTrainer
    cfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                   "egonet_tpu", "configs",
                                   "KITTI_train_IGRs.yml"))
    cfg["dataset"]["root"] = root
    cfg["dataset"]["detect_classes"] = ["Car", "Pedestrian"]
    fixtures.gate_shrink("hrnet")(cfg)
    cfg["heatmapModel"]["pretrained"] = ""
    fixtures.gate_train_stanza(cfg)
    cfg["optimizer"]["milestones"] = list(milestones)
    ds = kitti.KITTIDataset(cfg, "train")
    loader = IGRBatchLoader(ds.records, cfg, train=True, max_instances=18,
                            seed=0)
    trainer = IGRTrainer(cfg, steps_per_epoch=len(loader))
    state = trainer.init_state(0)
    steps, epochs_last = [], []
    for ep in range(epochs):
        for batch in loader.epoch():
            state, metrics = trainer.train_step(state, batch,
                                                apply_cr=ep >= 1)
            steps.append(float(metrics["loss"]))
        epochs_last.append(steps[-1])
    variables = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    return cfg, steps, epochs_last, variables


@pytest.fixture(scope="module")
def port_donor(tmp_path_factory, monkeypatch_module):
    """The tool's main on the CPU: the hrnet donor trained for two epochs on
    the 108-frame world (each step's loss recorded), written with its
    sidecar."""
    out = str(tmp_path_factory.mktemp("port_donors"))
    steps = []
    real = tigrs.IGRTrainer.train_step

    def recorded(self, state, batch, apply_cr=False):
        state, metrics = real(self, state, batch, apply_cr)
        steps.append(float(metrics["loss"]))
        return state, metrics
    monkeypatch_module.setattr(tigrs.IGRTrainer, "train_step", recorded)
    report = mga.main(["--epochs", str(DONOR_EPOCHS), "--images",
                       str(DONOR_IMAGES), "--milestones",
                       *map(str, MILESTONES), "--families", "hrnet",
                       "--out", out], device="cpu")["hrnet"]
    monkeypatch_module.undo()
    return {"out": out, "steps": steps, **report}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_donor_training_matches_the_jax_recipe(port_donor, tmp_path):
    from egonet_tpu.io import torch_convert as tc
    # the tool's world (seed-3 scenes), rebuilt: the tool's was temporary
    rng = np.random.RandomState(3)
    scenes = [sw.random_scene(rng, n_cars=2, n_peds=1)
              for _ in range(DONOR_IMAGES)]
    root, _ = sw.make_kitti_root(tmp_path, n_images=DONOR_IMAGES,
                                 classes_per_image=scenes)
    jcfg, jsteps, jepochs, jvars = _jax_donor(root, DONOR_EPOCHS, MILESTONES)
    # the recipe: the JAX tool's config, but for the keys its YAML loader
    # adds
    pcfg = mga.donor_config("hrnet", root, MILESTONES)
    assert set(jcfg) - set(pcfg) <= {"config_path", *tcfg._DEFAULTS}
    assert pcfg == {k: v for k, v in jcfg.items() if k in pcfg}
    steps = port_donor["steps"]
    assert len(steps) == len(jsteps) == DONOR_EPOCHS * 9
    assert abs(steps[0] - jsteps[0]) <= FIRST_STEP_TOL * jsteps[0], \
        (steps[0], jsteps[0])
    np.testing.assert_allclose(port_donor["losses"], jepochs,
                               rtol=EPOCH_LOSS_TOL)
    got = checkpoint.load_torch_state_dict(
        os.path.join(port_donor["out"], "gate_hrnet_car.pth"))
    ref = {k: np.asarray(v, np.float64)
           for k, v in tc.flax_to_torch(jvars).items()}
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.init import numpy_init
    init = numpy_init(build_heatmap_model(pcfg), 0).state_dict()
    params = [k for k in ref if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    gap = np.sqrt(sum(((got[k].double().numpy() - ref[k]) ** 2).sum()
                      for k in params))
    moved = np.sqrt(sum(((init[k].double().numpy() - ref[k]) ** 2).sum()
                        for k in params))
    print(f"first steps {steps[:3]} vs {jsteps[:3]}; epochs "
          f"{port_donor['losses']} vs {jepochs}; parameter drift "
          f"{gap / moved:.3f}")
    assert gap / moved <= PARAM_DRIFT_TOL, (gap, moved)


def test_sidecar_only_reproduces_the_committed_sidecars(tmp_path):
    for name in ("gate_hrnet_car.pth", "gate_native_car.pth"):
        shutil.copyfile(os.path.join(DATA, name), tmp_path / name)
    out = mga.main(["--sidecar-only", "--out", str(tmp_path)], device="cpu")
    for backbone, name in mga.DONORS:
        with open(os.path.join(DATA, name[:-4] + ".json")) as f:
            committed = json.load(f)
        with open(tmp_path / (name[:-4] + ".json")) as f:
            written = json.load(f)
        assert written == out[backbone]["sidecar"]
        keys = ["val_px"] + (["val_px_ped"] if backbone == "hrnet" else [])
        assert sorted(written) == sorted(committed)
        for key in keys:
            assert abs(written[key] - committed[key]) <= SIDECAR_PX_TOL, \
                (name, key, written[key], committed[key])
        assert written["probe"]["fixture"] == (
            "egonet_tpu_torch.tools.synthetic_world.make_gate_fixture")
        assert written["probe"]["seed"] == sw.GATE_SEED == fixtures.GATE_SEED


def test_port_donor_has_the_committed_format_and_loads_in_both(port_donor):
    path = os.path.join(port_donor["out"], "gate_hrnet_car.pth")
    got = torch.load(path, map_location="cpu")
    ref = torch.load(os.path.join(DATA, "gate_hrnet_car.pth"),
                     map_location="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    with open(path[:-4] + ".json") as f:
        side = json.load(f)
    assert side == port_donor["sidecar"] and "val_px_ped" in side
    # warm-starts the port's trainer (every layer) ...
    cfg = sw.igr_config("train_igrs_config", "unused", ("Car",), "hrnet",
                        path)
    _, state, variables = sw.warm_trainer(cfg, "cpu")
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, got[k].to(v.dtype), rtol=0, atol=0)
    # ... and the JAX package's
    from egonet_tpu.io import checkpoint as jck
    from egonet_tpu.io import torch_convert as tc
    from egonet_tpu.train.igrs import IGRTrainer as JT
    jcfg = sw.igr_config("train_igrs_config", "unused", ("Car",), "hrnet",
                         path)
    jt = JT(jcfg)
    jvars = jck.warm_start_variables(jcfg, jt.model)
    assert jvars is not None
    jstate = jt.init_state(0, variables=jvars)
    back = tc.flax_to_torch({"params": jstate.params,
                             "batch_stats": jstate.batch_stats})
    for k, v in back.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy(),
                                      err_msg=k)


def test_fullwidth_tool_end_to_end_at_a_shrunk_width(capsys, monkeypatch):
    """``record_native_fullwidth.main`` on the CPU with the shipped config
    patched as ``shrink_tpu_native`` does: the loop runs through its own
    asserts and prints the JAX tool's keys as its last line."""
    shipped = tcfg.tpu_native_config

    def shrunk():
        return sw.shrink_tpu_native(shipped(), widths=(16, 32, 64),
                                    head_width=16, grid_stride=8)
    monkeypatch.setattr(tcfg, "tpu_native_config", shrunk)
    line = rnf.main(["--epochs", "40", "--images", "12"], device="cpu")
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == line
    assert {"family", "config", "epochs", "images", "ap_r11_easy",
            "aos_r11_easy"} <= set(line)
    assert line["family"] == "tpu_native_fullwidth"
    assert line["config"] == "KITTI_tpu_native.yml"
    assert (line["epochs"], line["images"], line["device"]) == (40, 12, "cpu")
    assert 0.0 < line["ap_r11_easy"] <= 100.0
    assert 0.0 <= line["aos_r11_easy"] <= line["ap_r11_easy"]
    assert line["train_s"] > 0 and line["lifter_s"] > 0
