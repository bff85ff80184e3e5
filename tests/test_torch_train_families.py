"""The port's trainers on the other model families, against the JAX
package's, in float64 at a shrunk size on the fixture KITTI root (the
bars and the method of tests/test_torch_train.py: loss within 1e-10 of
the total, gradients and stepped parameters within 1e-9, BN running
statistics within 1e-12; SGD with momentum and weight decay):

* ``IGRTrainer`` on a shrunk stride-8 PoseNetTPU (the native config) and
  on the W32 pedestrian config shrunk, its stem to stage2 frozen;
* ``AngleTrainer`` ('baselinealpha' and 'baselinetheta') on the HRNet
  and PoseNetTPU 'angleregression' heads, its batches, its evaluation
  and its device rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.data import kitti as jk
from egonet_tpu.models.initialization import numpy_init as jinit
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.data import kitti as tk
from egonet_tpu_torch.train import angle as tangle
from egonet_tpu_torch.train import igrs as tigrs
from tests import fixtures
from tests.test_torch_train import (LOSS_TOL, STATS, STATS_TOL, TENSOR_TOL,
                                    _compare, _compare_grads, _f64,
                                    _igr_batch, root)

torch.set_num_threads(2)
assert root                     # the module-scoped KITTI root fixture


def _shrunk_native(cfg):
    return fixtures.shrink_tpu_native(cfg, widths=(16, 32, 64),
                                      head_width=16, grid_stride=8)


def _train_cfg(cfg, root_dir):
    cfg["dataset"]["root"] = root_dir
    hm = cfg["heatmapModel"]
    hm["pretrained"] = ""
    cfg["training_settings"].update(batch_size=2, use_target_weight=True)
    cfg["optimizer"].update(optim_type="sgd", lr=0.05, weight_decay=1e-4)
    return cfg


def _native_igr_cfg(root_dir):
    cfg = _train_cfg(_shrunk_native(tcfg.tpu_native_config()), root_dir)
    cfg["heatmapModel"]["loss_weight_list"] = [1.0, 0.1, 0.01]
    return cfg


def _ped_igr_cfg(root_dir):
    """The W32 pedestrian config shrunk (its loss list, sigma 2 and frozen
    stem to stage2 kept), on the fixture's cars."""
    cfg = _train_cfg(fixtures.shrink_hrnet(tcfg.train_igrs_ped_config()),
                     root_dir)
    cfg["dataset"]["detect_classes"] = ["Car"]
    return cfg


def _jax_state(model, f64_cfg_seed=0, size=64):
    var = _f64(jinit(model, f64_cfg_seed, jnp.zeros((1, size, size, 3))))
    return var["params"], var["batch_stats"]


@pytest.mark.parametrize("family", ["native", "ped_w32_frozen"])
def test_igr_two_steps_match_jax_in_float64(root, family):
    from egonet_tpu.train import optim as jo
    from egonet_tpu.train.igrs import IGRTrainer as JT
    cfg = (_native_igr_cfg if family == "native" else _ped_igr_cfg)(root)
    freeze = cfg["heatmapModel"]["extra"].get("freeze_layers", [])
    assert bool(freeze) == (family != "native")
    batch, crops = _igr_batch(cfg)
    pt = tigrs.IGRTrainer(cfg, dtype=torch.float64, device="cpu")
    state = pt.init_state(0)
    got = pt._crops_from_batch(pt._device_batch(batch)).numpy()
    np.testing.assert_array_equal(got, crops)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    apply_cr = family == "native"
    with jax.enable_x64(True):
        jt = JT(cfg, dtype=jnp.float64)
        params, bs = _jax_state(jt.model)
        if freeze:
            jt.tx = jo.apply_freezing(jt.tx, params, freeze)
        opt = jt.tx.init(params)
        jt._crops_from_batch = lambda b: b["crops"]
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}
        jb["crops"] = jnp.asarray(crops)
        gfn = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True),
                      static_argnums=3)
        upd = jax.jit(jt.tx.update)
        for step in range(2):
            (loss, (bs, comps)), g = gfn(params, bs, jb, apply_cr)
            u, opt = upd(g, opt, params)
            params = jax.tree_util.tree_map(lambda p, d: p + d, params, u)
            state, metrics = pt.train_step(state, batch, apply_cr)
            for k in ("loss", *comps):
                want = float(loss if k == "loss" else comps[k])
                err = abs(float(metrics[k]) - want) / abs(float(loss))
                assert err <= LOSS_TOL, (step, k, err)
            if freeze:
                g = {k: v for k, v in g.items()
                     if k.split(".")[0] not in freeze}
            _compare_grads(state.model, g, bs)
            stats_tol = STATS_TOL if step == 0 or not apply_cr else 1e-11
            _compare(state.model, {"params": params, "batch_stats": bs},
                     TENSOR_TOL, stats_tol, what=f"step {step}")
    for k, v in state.model.state_dict().items():
        if freeze and k.split(".")[0] in freeze and not k.endswith(STATS):
            assert torch.equal(v, start[k]), k


def _angle_cfg(root_dir, exp_type, family):
    if family == "native":
        cfg = _shrunk_native(tcfg.tpu_native_config())
    else:
        cfg = fixtures.shrink_hrnet(tcfg.train_igrs_config())
    cfg = _train_cfg(cfg, root_dir)
    cfg["exp_type"] = exp_type
    cfg["heatmapModel"]["head_type"] = "angleregression"
    return cfg


def _angle_batch(cfg, angle_index):
    """One batch of the JAX angle loader, the JAX package's eager crops of
    it, and the batch with float64 masks and targets."""
    from egonet_tpu.train.angle import AngleBatchLoader as JL
    from egonet_tpu.train.angle import AngleTrainer as JT
    records = jk.KITTIDataset(cfg, "train").records
    batch = next(JL(records, cfg, train=True, angle_index=angle_index,
                    max_instances=8).epoch())
    crops = np.asarray(JT(cfg)._crops(
        {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}))
    b64 = dict(batch)
    for k in ("mask", "sup_mask", "angle_target"):
        b64[k] = batch[k].astype(np.float64)
    return b64, crops


@pytest.mark.parametrize("family", ["hrnet", "native"])
@pytest.mark.parametrize("exp_type", ["baselinealpha", "baselinetheta"])
def test_angle_two_steps_match_jax_in_float64(root, exp_type, family):
    from egonet_tpu.train.angle import AngleTrainer as JT
    cfg = _angle_cfg(root, exp_type, family)
    pt = tangle.AngleTrainer(cfg, dtype=torch.float64, device="cpu")
    assert pt.angle_index == (0 if exp_type == "baselinealpha" else 1)
    batch, crops = _angle_batch(cfg, pt.angle_index)
    assert batch["mask"].sum() < len(batch["mask"])          # padded
    state = pt.init_state(0)
    got = pt._crops_from_batch(pt._device_batch(batch)).numpy()
    np.testing.assert_array_equal(got, crops)
    with jax.enable_x64(True):
        jt = JT(cfg, dtype=jnp.float64)
        params, bs = _jax_state(jt.model)
        opt = jt.tx.init(params)
        jt._crops = lambda b: b["crops"]
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}
        jb["crops"] = jnp.asarray(crops)
        gfn = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))
        upd = jax.jit(jt.tx.update)
        for step in range(2):
            (loss, bs), g = gfn(params, bs, jb)
            u, opt = upd(g, opt, params)
            params = jax.tree_util.tree_map(lambda p, d: p + d, params, u)
            state, got_loss = pt.train_step(state, batch)
            err = abs(float(got_loss) - float(loss)) / abs(float(loss))
            assert err <= LOSS_TOL, (step, err)
            _compare_grads(state.model, g, bs)
            # the second step's statistics come from parameters the first
            # step left up to 1.6e-12 apart (relative, the trunk's BN
            # biases; observed on the HRNet head): they are held at 1e-11
            # (observed up to 5.4e-12, final_fc.1.running_var), as
            # tests/test_torch_train.py holds its cross-ratio case
            stats_tol = STATS_TOL if step == 0 else 1e-11
            _compare(state.model, {"params": params, "batch_stats": bs},
                     TENSOR_TOL, stats_tol, what=f"step {step}")


@pytest.mark.parametrize("exp_type", ["baselinealpha", "baselinetheta"])
def test_angle_batches_equal_jax(root, exp_type):
    """The port's AngleBatchLoader draws the JAX loader's batches: the same
    crops' affines, and [cos, sin] of rots[:, 0] (alpha) or rots[:, 1]
    (the yaw)."""
    from egonet_tpu.train.angle import AngleBatchLoader as JL
    cfg = _angle_cfg(root, exp_type, "hrnet")
    idx = 0 if exp_type == "baselinealpha" else 1
    jb = list(JL(jk.KITTIDataset(cfg, "train").records, cfg, train=True,
                 angle_index=idx, seed=4).epoch())
    tb = list(tangle.AngleBatchLoader(tk.KITTIDataset(cfg, "train").records,
                                      cfg, train=True, angle_index=idx,
                                      seed=4).epoch())
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        for k in ("angle_target", "mask", "inv_mats", "img_idx"):
            np.testing.assert_array_equal(a[k], b[k], k)
        np.testing.assert_array_equal(a["meta"]["angles_gt"],
                                      b["meta"]["angles_gt"])
        m = b["meta"]["count"]
        ang = b["meta"]["angles_gt"]
        np.testing.assert_allclose(b["angle_target"][:m],
                                   np.stack([np.cos(ang), np.sin(ang)], 1),
                                   atol=1e-7)
        assert not b["angle_target"][m:].any()


def test_angle_evaluate_matches_jax(root):
    """The mean angle error over the valid split with the same weights
    (fp32 eval; the JAX side jits its warp, so 1e-4 relative)."""
    from egonet_tpu.io import torch_convert as tc
    from egonet_tpu.train.angle import AngleTrainer as JT
    cfg = _angle_cfg(root, "baselinealpha", "hrnet")
    jt = JT(cfg)
    jstate = jt.init_state(3)
    records = jk.KITTIDataset(cfg, "valid").records
    jerr = jt.evaluate(jstate, records)
    pt = tangle.AngleTrainer(cfg, device="cpu")
    sd = tc.flax_to_torch({"params": jax.device_get(jstate.params),
                           "batch_stats": jax.device_get(
                               jstate.batch_stats)})
    state = pt.init_state(0, variables={
        k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    err = pt.evaluate(state, tk.KITTIDataset(cfg, "valid").records)
    assert 0.0 < jerr and abs(err - jerr) <= 1e-4 * jerr
    assert state.model.training


def test_angle_trainer_needs_the_angle_head_and_a_card(root, monkeypatch):
    cfg = _angle_cfg(root, "baselinealpha", "hrnet")
    cfg["heatmapModel"]["head_type"] = "coordinates"
    with pytest.raises(ValueError, match="angleregression"):
        tangle.AngleTrainer(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tangle.AngleTrainer(_angle_cfg(root, "baselinetheta", "native"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tigrs.IGRTrainer(_native_igr_cfg(root))
    from egonet_tpu_torch.models.egonet import EgoNet
    with pytest.raises(RuntimeError, match="CUDA"):
        EgoNet(tcfg.native_demo_config())


def test_native_igr_fit_and_eval(root, tmp_path):
    """The fit loop on the shrunk native config: a falling loss over 3
    epochs of the fixture, the eval forward's maps and coords, snapshots
    that load strictly into the facade."""
    from egonet_tpu_torch.io.weights import load_torch_state_dict
    from egonet_tpu_torch.models.egonet import EgoNet
    cfg = _native_igr_cfg(root)
    cfg["training_settings"]["snapshot_epochs"] = [3]
    cfg["optimizer"].update(optim_type="adam", lr=1e-3)
    pt = tigrs.IGRTrainer(cfg, device="cpu")
    records = tk.KITTIDataset(cfg, "train").records
    state, hist = pt.fit(records, epochs=3, snapshot_dir=str(tmp_path))
    assert hist[-1]["loss"] < hist[0]["loss"]
    ev = pt.evaluate(state, tk.KITTIDataset(cfg, "valid").records)
    assert np.isfinite(ev.metrics[0].mean)
    dcfg = tcfg.native_demo_config()
    _shrunk_native(dcfg)
    net = EgoNet(dcfg, device="cpu")
    net.load_state(load_torch_state_dict(str(tmp_path / "HC_epoch3.pth")))
