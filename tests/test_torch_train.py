"""The port's trainers (egonet_tpu_torch/train/{lifting,igrs}.py) against
the JAX package's, at a shrunk size on the fixture KITTI root.

Exact parity runs in float64 (in float32 the two packages round
independently and a ReLU gate within rounding of zero flips between them,
moving whole gradient contributions): the loss within 1e-10 relative,
every gradient and stepped parameter within 1e-9 (relative to the
tensor's largest entry) and the BN running statistics within 1e-12
(relative to their largest entry, or absolute where that is below 1), by
the JAX package's rule for the running variance (biased).  The JAX side
is fed the crops of its own eager warp (under ``jit`` its CPU warp rounds
a few pixels differently, ROADMAP section 3), which the port's warp
equals bit for bit; the batch's joints and masks are float64 so that the
Gaussian targets are too.  The IGR steps use SGD with momentum and weight
decay, and, in one case, Adam at the shipped config's rate (1e-3).
Dropout-on lifter training is held by behaviour.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.data import kitti as jk
from egonet_tpu.data.loader import ArrayBatchLoader as JArrayLoader
from egonet_tpu.data.loader import IGRBatchLoader as JIGRLoader
from egonet_tpu.io import torch_convert as tc
from egonet_tpu.models.initialization import numpy_init as jinit
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.data import kitti as tk
from egonet_tpu_torch.train import igrs as tigrs
from egonet_tpu_torch.train import lifting as tlift
from tests import fixtures

torch.set_num_threads(2)
LOSS_TOL, TENSOR_TOL, STATS_TOL = 1e-10, 1e-9, 1e-12
STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    scenes = [fixtures.random_scene(np.random.RandomState(i), n_cars=3,
                                    n_peds=0) for i in range(4)]
    r, _ = fixtures.make_kitti_root(tmp_path_factory.mktemp("tt"),
                                    n_images=4, classes_per_image=scenes)
    return r


def _f64(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v, np.float64), tree)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def _compare(model, variables, tol, stats_tol, grads=None, what="",
             noise=(), step_size=0.0):
    """Every parameter (or its .grad) and running statistic of the port's
    ``model`` against flax ``variables``, relative to each tensor's
    largest entry (to 1 where that is smaller, for the running
    statistics).  Analytically-zero tensors (both sides below 1e-14 of
    the largest tensor) are fp64 noise on both sides: they are skipped and
    their names returned.  The parameters named in ``noise`` (their
    gradient was such noise: a bias feeding batch norm) moved by rounding
    noise only, which Adam divides by 1e-8; they are held within 1e-6 of
    ``step_size``."""
    ref = {k: np.asarray(v) for k, v in tc.flax_to_torch(variables).items()
           if not k.endswith("num_batches_tracked")}
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if grads is not None:
        got = {n: p.grad.numpy() for n, p in model.named_parameters()}
        ref = {k: v for k, v in ref.items() if not k.endswith(STATS)}
    gscale = max(float(np.abs(v).max()) for v in ref.values())
    skipped = set()
    for k, r in ref.items():
        g = got[k]
        if k in noise:
            assert float(np.abs(g - r).max()) <= 1e-6 * step_size, (what, k)
            continue
        if max(float(np.abs(r).max()), float(np.abs(g).max())) \
                < 1e-14 * gscale:
            skipped.add(k)
            continue
        if k.endswith(STATS):
            err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                                    1.0)
            # a running mean downstream of a noise-moved bias carries that
            # bias's rounding gap (momentum 0.1 x |d bias| <= 1e-7 x lr)
            fed = k.replace("batch_norm", "w").replace(".running_mean",
                                                       ".bias")
            bar = stats_tol + (1e-7 * step_size if fed in noise else 0.0)
            assert err <= bar, (what, k, err)
        else:
            assert _rel(g, r) <= tol, (what, k, _rel(g, r))
    return skipped


# ---------------------------------------------------------------- lifter

def _lift_cfg(root, dropout=0.0, optim_type="adam"):
    cfg = tcfg.train_lifting_config()
    cfg["dataset"]["root"] = root
    cfg["training_settings"].update(lft_aug_times=12, batch_size=32,
                                    total_epochs=1)
    cfg["FCModel"].update(num_neurons=64, dropout=dropout,
                          input_size=66, output_size=96)
    cfg["optimizer"].update(optim_type=optim_type, lr=1e-3,
                            milestones=[1, 2], weight_decay=1e-4)
    return cfg


def test_lifter_initial_values_equal_jax(root):
    from egonet_tpu.models.fc_lifter import build_fc_model
    cfg = _lift_cfg(root)
    jv = jinit(build_fc_model(cfg), 4, jnp.zeros((1, 66)))
    model = tlift.LiftingTrainer(cfg, device="cpu").build_model(4)
    for k, v in tc.flax_to_torch(jv).items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(),
                                      np.asarray(v), err_msg=k)


@pytest.mark.parametrize("optim_type", ["adam", "sgd"])
def test_lifter_five_steps_match_jax_in_float64(root, optim_type):
    """Five steps (the rate halves at steps 2 and 4) with dropout off: the
    loss, every gradient, the stepped parameters and the BN statistics of
    each step."""
    from egonet_tpu.train.lifting import LiftingTrainer as JLift
    cfg = _lift_cfg(root, optim_type=optim_type)
    train, _ = tk.prepare_data(cfg)
    batches = []
    loader = JArrayLoader(train.input, train.output, 32, seed=0)
    while len(batches) < 5:
        batches += list(loader.epoch())
    batches = [{k: v.astype(np.float64) for k, v in b.items()}
               for b in batches[:5]]
    pt = tlift.LiftingTrainer(cfg, dtype=torch.float64, steps_per_epoch=2,
                              device="cpu")
    state = pt.init_state(0)
    with jax.enable_x64(True):
        jt = JLift(cfg, dtype=jnp.float64, steps_per_epoch=2)
        var = _f64(jinit(jt.model, 0, jnp.zeros((1, 66))))
        params, bs = var["params"], var["batch_stats"]
        opt = jt.tx.init(params)
        gfn = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))
        upd = jax.jit(jt.tx.update)
        key = jax.random.PRNGKey(0)
        for step, batch in enumerate(batches):
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (loss, bs), g = gfn(params, bs, jb, key)
            u, opt = upd(g, opt, params)
            params = jax.tree_util.tree_map(lambda p, d: p + d, params, u)
            state, tloss = pt.train_step(state, batch)
            assert _rel(float(tloss), float(loss)) <= LOSS_TOL, step
            noise = _compare(state.model, {"params": g, "batch_stats": bs},
                             TENSOR_TOL, STATS_TOL, grads=True,
                             what=f"grad {step}")
            assert noise == {f"{p}.bias" for p in (
                "w1", "res_blocks.0.w1", "res_blocks.0.w2",
                "res_blocks.1.w1", "res_blocks.1.w2")}
            _compare(state.model, {"params": params, "batch_stats": bs},
                     TENSOR_TOL, STATS_TOL, what=f"step {step}",
                     noise=noise, step_size=pt.schedule(step))
    assert state.step == 5


def test_lifter_with_dropout_learns_like_jax(root):
    """Dropout on (0.5), 8 epochs at the same data and seed: the port's
    training loss and valid MSE fall (the mean of the last two epochs
    below the first epoch's) and its final valid MSE lies within a factor
    1.5 of the JAX trainer's (the masks are different draws)."""
    from egonet_tpu.train.lifting import LiftingTrainer as JLift
    cfg = _lift_cfg(root, dropout=0.5)
    cfg["optimizer"]["milestones"] = [50]
    train, valid = tk.prepare_data(cfg)
    steps = len(train.input) // 32
    _, th = tlift.LiftingTrainer(cfg, steps_per_epoch=steps,
                                 device="cpu").fit(train, valid, epochs=8)
    _, jh = JLift(cfg, steps_per_epoch=steps).fit(train, valid, epochs=8)
    for key in ("loss", "valid_mse"):
        curve = [h[key] for h in th]
        assert np.mean(curve[-2:]) < curve[0], (key, curve)
    ratio = th[-1]["valid_mse"] / jh[-1]["valid_mse"]
    assert 1 / 1.5 <= ratio <= 1.5, (th[-1], jh[-1])


def test_lifter_eval_dropout_and_evaluate(root, tmp_path):
    cfg = _lift_cfg(root, dropout=0.5)
    train, valid = tk.prepare_data(cfg)
    trainer = tlift.LiftingTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    det = trainer.predict(state, valid.input)
    assert np.array_equal(det, trainer.predict(state, valid.input))
    cfg["testing_settings"]["apply_dropout"] = True
    a = trainer.predict(state, valid.input)
    b = trainer.predict(state, valid.input)
    assert np.isfinite(a).all() and not np.array_equal(a, b)
    ev = trainer.evaluate(state, valid, metrics=["RError3D"])
    assert np.isfinite(ev.metrics[0].rT.mean).all()
    figs = os.path.join(tmp_path, "figs")
    trainer.evaluate(state, valid, visualize_dir=figs)
    assert os.path.getsize(os.path.join(figs, "lifting_eval.png")) > 0


def test_lifter_evaluate_writes_the_figure_of_jax(root, tmp_path,
                                                 monkeypatch):
    """``visualize_dir`` writes ``lifting_eval.png`` from the un-normalised
    inputs, predictions and targets, as the JAX trainer does: the
    figure's inputs and targets equal the JAX trainer's bit for bit, its
    predictions (fp32, same initial weights) within 1e-5 relative."""
    from egonet_tpu.train import lifting as jlift
    from egonet_tpu.visualization import overlays as jov
    from egonet_tpu_torch.visualization import overlays as tov
    cfg = _lift_cfg(root)
    train, valid = tk.prepare_data(cfg)
    seen = {}
    real = tov.visualize_lifting_results

    def capture(tag, draw):
        def fn(data_2d, prediction, target=None, sample_num=None, **kw):
            seen[tag] = (np.asarray(data_2d), np.asarray(prediction),
                         np.asarray(target), sample_num)
            return draw(data_2d, prediction, target=target,
                        sample_num=sample_num, **kw) if draw else \
                kw["save_path"]
        return fn

    monkeypatch.setattr(tov, "visualize_lifting_results",
                        capture("port", real))
    monkeypatch.setattr(jov, "visualize_lifting_results",
                        capture("jax", None))
    trainer = tlift.LiftingTrainer(cfg, device="cpu")
    out = str(tmp_path / "figs")
    trainer.evaluate(trainer.init_state(0), valid, visualize_dir=out)
    png = os.path.join(out, "lifting_eval.png")
    assert os.path.getsize(png) > 0
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    jt = jlift.LiftingTrainer(cfg)
    jt.evaluate(jt.init_state(0), valid, visualize_dir=str(tmp_path / "j"))
    (ti, tp, tg, tn), (ji, jp, jg, jn) = seen["port"], seen["jax"]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tg, jg)
    assert tn == jn == 9 and tp.shape == jp.shape
    assert _rel(tp, jp) <= 1e-5, _rel(tp, jp)
    # un-normalised: the figure's inputs are screen pixels, not z-scores
    assert np.abs(ti).max() > 50


# ---------------------------------------------------------------- IGR

def _igr_cfg(root, cr_weight=0.01, freeze=()):
    cfg = tcfg.train_igrs_config()
    fixtures.shrink_hrnet(cfg)
    cfg["dataset"]["root"] = root
    hm = cfg["heatmapModel"]
    hm["pretrained"] = ""
    hm["loss_weight_list"] = [1.0, 0.1, cr_weight]
    hm["extra"]["freeze_layers"] = list(freeze)
    cfg["training_settings"].update(batch_size=2, use_target_weight=True)
    cfg["optimizer"].update(optim_type="sgd", lr=0.05, weight_decay=1e-4)
    return cfg


def _igr_batch(cfg, max_instances=8):
    """One jittered batch of the JAX loader (cars duplicated into the
    padding slots), the JAX package's eager crops of it, and the batch
    with float64 joints and masks."""
    from egonet_tpu.train.igrs import IGRTrainer as JT
    records = jk.KITTIDataset(cfg, "train").records
    batch = next(JIGRLoader(records, cfg, train=True,
                            max_instances=max_instances).epoch())
    crops = np.asarray(JT(cfg)._crops_from_batch(
        {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}))
    b64 = dict(batch)
    for k in ("joints", "mask", "sup_mask"):
        b64[k] = batch[k].astype(np.float64)
    return b64, crops


@pytest.mark.parametrize("case", ["cr_off", "cr_on", "frozen", "adam"])
def test_igr_two_steps_match_jax_in_float64(root, case):
    """Two steps of the port's IGRTrainer against the JAX trainer's
    ``_loss_fn`` + optax update: the loss and its components, every
    gradient, the stepped parameters and the BN running statistics; with
    target weights and sup_mask, with the cross-ratio term on or off, and
    with layers frozen (which keep their values and get no gradient)."""
    from egonet_tpu.train import optim as jo
    from egonet_tpu.train.igrs import IGRTrainer as JT
    freeze = ("conv1", "bn1", "layer1") if case == "frozen" else ()
    cfg = _igr_cfg(root, freeze=freeze)
    if case == "adam":
        cfg["optimizer"].update(optim_type="adam", lr=1e-3)
    apply_cr = case == "cr_on"
    batch, crops = _igr_batch(cfg)
    assert batch["mask"].sum() < len(batch["mask"])     # padded

    pt = tigrs.IGRTrainer(cfg, dtype=torch.float64, device="cpu")
    state = pt.init_state(0)
    got = pt._crops_from_batch(pt._device_batch(batch)).numpy()
    np.testing.assert_array_equal(got, crops)     # the eager JAX warp
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    with jax.enable_x64(True):
        jt = JT(cfg, dtype=jnp.float64)
        var = _f64(jinit(jt.model, 0, jnp.zeros((1, 64, 64, 3))))
        params, bs = var["params"], var["batch_stats"]
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
            assert ("cr" in metrics) == apply_cr
            # the components on the total's scale: the cross-ratio term of
            # near-degenerate edges moves 1e-10 of itself for a 1e-12 gap in
            # the first step's parameters
            for k in ("loss", *comps):
                want = float(loss if k == "loss" else comps[k])
                err = abs(float(metrics[k]) - want) / abs(float(loss))
                assert err <= LOSS_TOL, (step, k, err)
            if freeze:
                g = {k: v for k, v in g.items()
                     if k.split(".")[0] not in freeze}
            _compare_grads(state.model, g, bs)
            # the second step's statistics come from parameters the first
            # step left 1e-12 apart; with the cross-ratio term on, its
            # near-degenerate edges widen that gap in a few head layers to
            # 1.15e-12 (observed), so that step is held at 1e-11
            stats_tol = STATS_TOL if step == 0 or not apply_cr else 1e-11
            _compare(state.model, {"params": params, "batch_stats": bs},
                     TENSOR_TOL, stats_tol, what=f"step {step}")
    for k, v in state.model.state_dict().items():
        if freeze and k.split(".")[0] in freeze and not k.endswith(STATS):
            assert torch.equal(v, start[k]), k
            assert state.model.get_parameter(k).grad is None


def _compare_grads(model, grads, bs):
    """The port's .grad of every parameter the JAX gradient tree covers."""
    ref = tc.flax_to_torch({"params": grads, "batch_stats": bs})
    named = dict(model.named_parameters())
    gscale = max(float(np.abs(np.asarray(v)).max()) for k, v in ref.items()
                 if not k.endswith(STATS))
    for k, r in ref.items():
        if k.endswith(STATS):
            continue
        r = np.asarray(r)
        g = named[k].grad.numpy()
        if max(float(np.abs(r).max()), float(np.abs(g).max())) \
                < 1e-14 * gscale:
            continue
        assert _rel(g, r) <= TENSOR_TOL, k


def test_igr_evaluate_matches_jax(root):
    """JointDistance2DSIP over the valid split with the same weights, fp32
    eval mode (the JAX side jits its warp: a few crop pixels round
    differently, so the means agree to 1e-4 relative, not bit for bit)."""
    from egonet_tpu.train.igrs import IGRTrainer as JT
    cfg = _igr_cfg(root)
    jt = JT(cfg)
    jstate = jt.init_state(3)
    records = jk.KITTIDataset(cfg, "valid").records
    jmean = jt.evaluate(jstate, records).metrics[0].mean
    pt = tigrs.IGRTrainer(cfg, device="cpu")
    sd = tc.flax_to_torch({"params": jax.device_get(jstate.params),
                           "batch_stats": jax.device_get(
                               jstate.batch_stats)})
    state = pt.init_state(
        0, variables={k: torch.from_numpy(np.array(v)) for k, v in
                      sd.items()})
    ev = pt.evaluate(state, tk.KITTIDataset(cfg, "valid").records)
    assert abs(ev.metrics[0].mean - jmean) <= 1e-4 * jmean
    assert ev.metrics[0].count > 0 and state.model.training


def _capture_cv2(monkeypatch):
    import cv2
    written = {}

    def imwrite(path, img):
        written[os.path.basename(path)] = cv2.cvtColor(img,
                                                       cv2.COLOR_BGR2RGB)
        return True
    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return written


def test_heatmap_grids_equal_jax(monkeypatch, tmp_path):
    """The debug heatmap grid (thumbnail + JET colouring + blend) equals
    the array the JAX package hands to cv2.imwrite; the joints grid has
    its shape and crops."""
    from egonet_tpu.visualization import debug as jd
    from egonet_tpu_torch.visualization import debug as td
    written = _capture_cv2(monkeypatch)
    rng = np.random.RandomState(0)
    crops = rng.randn(3, 64, 64, 3).astype(np.float32)
    maps = rng.randn(3, 5, 16, 16).astype(np.float32)
    maps[1] = -np.abs(maps[1])                   # all-negative heatmaps
    jd.save_batch_heatmaps(crops, maps, str(tmp_path / "hm.jpg"))
    np.testing.assert_array_equal(td.batch_heatmaps(crops, maps),
                                  written["hm.jpg"])
    joints = rng.uniform(-5, 70, (3, 5, 2))
    jd.save_batch_image_with_joints(crops, joints, None,
                                    str(tmp_path / "kp.jpg"))
    grid = td.batch_image_with_joints(crops, joints, None)
    assert grid.shape == written["kp.jpg"].shape
    far = np.ones(grid.shape[:2], bool)          # pixels far from a joint
    for i in range(3):
        for x, y in joints[i].astype(int):
            far[max(0, y - 3):y + 4, 64 * i + max(0, x - 3):64 * i + x + 4] \
                = False
    np.testing.assert_array_equal(grid[far], written["kp.jpg"][far])


def test_igr_fit_writes_debug_grids_and_snapshots(root, tmp_path):
    """``fit`` with the shipped debug flags: four PNG grids per epoch at
    batch 0, a snapshot at each snapshot epoch, falling nothing but
    finite loss; plot_loss without matplotlib raises a clear error."""
    from egonet_tpu_torch.data import png
    cfg = _igr_cfg(root, cr_weight="None")
    cfg["training_settings"].update(snapshot_epochs=[2], report_every=30)
    pt = tigrs.IGRTrainer(cfg, device="cpu")
    records = tk.KITTIDataset(cfg, "train").records
    state, history = pt.fit(records, epochs=2, snapshot_dir=str(tmp_path))
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                      for h in history)
    for h in history:             # the wall split covers the epoch's loop
        assert set(h["split"]) == {"load", "step", "debug"}, h
        assert 0.9 * h["seconds"] < sum(h["split"].values()) \
            <= h["seconds"] + 1e-3, h
    names = sorted(os.listdir(tmp_path / "debug"))
    assert names == sorted(f"e{e}_b0_{k}.png" for e in (0, 1)
                           for k in ("pred", "gt", "hm_gt", "hm_pred"))
    img = png.decode(str(tmp_path / "debug" / "e0_b0_hm_gt.png"))
    assert img.shape[1] == 16 * 34 and img.dtype == np.uint8
    assert (tmp_path / "HC_epoch2.pth").exists()
    assert state.step == 2 * len(records) // 2
