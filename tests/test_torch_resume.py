"""Exact resume in the port (egonet_tpu_torch/io/train_ckpt.py and the
``ckpt_manager`` / ``start_epoch`` contract of the trainers' ``fit``), the
counterparts of tests/test_orbax_resume.py, on the CPU at a shrunk size:
a full-state round trip; the IGR and lifter trainers interrupted and
resumed bit-equal to the uninterrupted run, in fp32 and fp64, in one
process and under 2 gloo ranks; an asynchronous save unaffected by the
steps that follow it; no step to restore; retention; a leftover ``.tmp``;
both training CLIs' ``exact_resume`` (2 + 1 epochs equal 3); and the
port's lifter ``fit`` against the JAX package's with a checkpoint manager
in play (the (seed, epoch) reshuffle), in fp64 at PR 7's bars."""

import copy
import os

import numpy as np
import pytest
import torch

from egonet_tpu_torch.data import kitti as tk
from egonet_tpu_torch.io.train_ckpt import TrainCheckpointManager
from egonet_tpu_torch.io.weights import load_torch_state_dict
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.tools import train_igrs, train_lifting
from egonet_tpu_torch.train import igrs as tigrs
from egonet_tpu_torch.train import lifting as tlift
from tests import torch_dp_ranks as ranks
from tests.test_torch_train import STATS_TOL, TENSOR_TOL, _igr_cfg, _lift_cfg
from tests.test_torch_train import root
from tests.test_torch_train_cli import _igr_cfg as _igr_cli_cfg
from tests.test_torch_train_cli import _lift_cfg as _lift_cli_cfg

torch.set_num_threads(2)
assert root                     # the module-scoped KITTI root fixture
DTYPES = {"fp32": torch.float32, "fp64": torch.float64}


def _adam(cfg):
    cfg["optimizer"].update(optim_type="adam", lr=1e-3)
    return cfg


@pytest.fixture(scope="module")
def igr(root):
    cfg = _adam(_igr_cfg(root))
    return cfg, tk.KITTIDataset(cfg, "train").records


@pytest.fixture(scope="module")
def lifter(root):
    cfg = _lift_cfg(root)
    cfg["training_settings"].update(batch_size=64)
    train, _ = tk.prepare_data(cfg)
    return cfg, train


def _tensors(state) -> dict:
    return ranks._full_state(state)


def _assert_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _resumed(make, fit, directory, total, cut, async_save):
    """``fit`` for ``cut`` epochs, then a fresh trainer (a restarted
    process) restored from the latest step and fitted to ``total``."""
    with TrainCheckpointManager(directory, async_save=async_save) as mgr:
        fit(make(), mgr, cut)
    trainer = make()
    with TrainCheckpointManager(directory, async_save=async_save) as mgr:
        assert mgr.latest_step() == cut
        state = mgr.restore(trainer.init_state(0))
        assert state.step > 0
        return fit(trainer, mgr, total, state=state, start=cut)


def test_full_state_round_trip(igr, tmp_path):
    """One epoch with a manager; every tensor of the state (parameters,
    BN buffers, Adam moments and step) and the step restore into a fresh
    template."""
    cfg, records = igr
    trainer = tigrs.IGRTrainer(cfg, device="cpu")
    with TrainCheckpointManager(str(tmp_path), async_save=False) as mgr:
        state, _ = trainer.fit(records, epochs=1, seed=7, ckpt_manager=mgr)
        assert mgr.latest_step() == 1
        fresh = tigrs.IGRTrainer(cfg, device="cpu")
        restored = mgr.restore(fresh.init_state(0), step=1)
    got, want = _tensors(restored), _tensors(state)
    assert any(k.endswith("exp_avg_sq") for k in got)
    _assert_equal(got, want)
    assert restored.step == state.step > 0
    assert restored.model is fresh.model


@pytest.mark.parametrize("dtype,total,cut", [("fp32", 3, 2), ("fp64", 2, 1)])
def test_igr_exact_resume_is_bit_equal(igr, tmp_path, dtype, total, cut):
    """``total`` epochs straight against ``cut`` and the rest resumed (the
    cross-ratio term switches on at epoch 1, on either side of the cut;
    fp64 convolutions are slow on the CPU, hence the shorter run)."""
    cfg, records = igr

    def make():
        return tigrs.IGRTrainer(cfg, dtype=DTYPES[dtype], device="cpu")

    def fit(trainer, mgr, epochs, state=None, start=0):
        return trainer.fit(records, epochs=epochs, seed=7, state=state,
                           ckpt_manager=mgr, start_epoch=start)[0]

    with TrainCheckpointManager(str(tmp_path / "a")) as mgr:
        full = fit(make(), mgr, total)
    resumed = _resumed(make, fit, str(tmp_path / "b"), total, cut, True)
    _assert_equal(_tensors(resumed), _tensors(full))


@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
def test_lifter_exact_resume_is_bit_equal(lifter, tmp_path, dtype):
    cfg, train = lifter

    def make():
        return tlift.LiftingTrainer(cfg, dtype=DTYPES[dtype],
                                    steps_per_epoch=2, device="cpu")

    def fit(trainer, mgr, epochs, state=None, start=0):
        return trainer.fit(train, epochs=epochs, seed=3, state=state,
                           ckpt_manager=mgr, start_epoch=start)[0]

    with TrainCheckpointManager(str(tmp_path / "a")) as mgr:
        full = fit(make(), mgr, 4)
    resumed = _resumed(make, fit, str(tmp_path / "b"), 4, 2, False)
    _assert_equal(_tensors(resumed), _tensors(full))


def test_async_save_survives_the_next_in_place_steps(lifter, tmp_path):
    """The host copy is taken before ``save`` returns: the optimizer steps
    that follow (in place, while the write may be in flight) do not reach
    the file."""
    cfg, train = lifter
    trainer = tlift.LiftingTrainer(cfg, device="cpu")
    state = trainer.init_state(3)
    batches = list(tlift.ArrayBatchLoader(train.input, train.output, 64,
                                          seed=3).epoch())
    for b in batches:
        state, _ = trainer.train_step(state, b)
    snap = {k: v.clone() for k, v in _tensors(state).items()}
    with TrainCheckpointManager(str(tmp_path), async_save=True) as mgr:
        mgr.save(1, state)
        for b in batches:
            state, _ = trainer.train_step(state, b)
        mgr.wait_until_finished()
        assert mgr.saves[0]["bytes"] > 0 and mgr.saves[0]["write_s"] >= 0
        restored = mgr.restore(trainer.init_state(0), step=1)
    assert not torch.equal(_tensors(state)["model.w1.weight"],
                           snap["model.w1.weight"])
    _assert_equal(_tensors(restored), snap)


def test_restore_without_a_step_raises(tmp_path):
    with TrainCheckpointManager(str(tmp_path / "empty")) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(template=None)


def test_retention_and_leftover_tmp(lifter, tmp_path):
    """``max_to_keep`` newest steps stay; a ``<step>.tmp`` left by a crash
    is no step."""
    cfg, _ = lifter
    trainer = tlift.LiftingTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    with TrainCheckpointManager(str(tmp_path), max_to_keep=2) as mgr:
        for step in (1, 2, 3, 4):
            mgr.save(step, state, wait=True)
        assert mgr.all_steps() == [3, 4]
        (tmp_path / "9.tmp").write_bytes(b"half a file")
        assert mgr.latest_step() == 4
        assert sorted(os.listdir(tmp_path)) == ["3", "4", "9.tmp"]
        restored = mgr.restore(trainer.init_state(1))
        assert restored.step == 0
    _assert_equal(_tensors(restored), _tensors(state))


def test_exact_resume_under_two_gloo_ranks(igr, tmp_path):
    """The IGR trainer over 2 ranks: 2 epochs + 1 resumed equal 3 straight
    on every rank, bit for bit, and the ranks hold the same state."""
    cfg, records = igr
    mesh.run_ranks(ranks.resume_fit, 2,
                   args=(str(tmp_path), cfg, records), timeout_s=300)
    got = ranks.load(str(tmp_path), "resume", 2)
    for r in got:
        _assert_equal(r["resumed"], r["full"])
        _assert_equal(r["full"], got[0]["full"])
    assert int(got[0]["full"]["step"]) > 0


@pytest.mark.parametrize("cli", ["lifting", "igrs"])
def test_cli_exact_resume(root, tmp_path, cli, monkeypatch):
    """``training_settings.exact_resume: true``: 2 epochs, then the same
    command to 3 epochs resumes at epoch 2 from ``<checkpoints>/orbax``;
    its checkpoint equals 3 epochs in one run.  Each run trains under
    deterministic algorithms, and the mode is off again after it."""
    main, make, name = ((train_lifting.main, _lift_cli_cfg, "L.pth")
                        if cli == "lifting"
                        else (train_igrs.main, _igr_cli_cfg, "HC.pth"))
    trainer = tlift.LiftingTrainer if cli == "lifting" else tigrs.IGRTrainer
    modes, fit = [], trainer.fit

    def spy(self, *args, **kwargs):
        modes.append(torch.are_deterministic_algorithms_enabled())
        return fit(self, *args, **kwargs)
    monkeypatch.setattr(trainer, "fit", spy)

    def run(out, epochs):
        cfg = make(root, str(out))
        cfg["training_settings"].update(total_epochs=epochs,
                                        exact_resume=True)
        if cli == "lifting":
            cfg["training_settings"].update(lft_aug_times=2)
        else:       # the debug grids have nothing to do with resuming
            cfg["training_settings"].update(batch_size=2)
            cfg["training_settings"]["debug"]["save"] = False
        return main(cfgs=cfg)

    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "b", 3)
    assert [h["epoch"] for h in resumed["history"]] == [2]
    orbax = os.path.join(resumed["ckpt_dir"], "orbax")
    assert TrainCheckpointManager(orbax).all_steps() == [1, 2, 3]
    full = run(tmp_path / "a", 3)
    assert modes == [True] * 3
    assert not torch.are_deterministic_algorithms_enabled()
    a = load_torch_state_dict(os.path.join(full["ckpt_dir"], name))
    b = load_torch_state_dict(os.path.join(resumed["ckpt_dir"], name))
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def test_lifter_fit_with_a_manager_matches_jax(lifter, tmp_path):
    """The port's ``fit`` and the JAX package's, fp64, 2 epochs, dropout
    off, each with its checkpoint manager (so each epoch's shuffle is
    keyed by (seed, epoch)): the losses within 1e-10, the parameters
    within 1e-9 and the BN statistics within 1e-12 (relative; the biases
    feeding batch norm, analytically zero, are rounding noise on both
    sides and skipped), and the same step count."""
    import jax
    import jax.numpy as jnp
    from egonet_tpu.io import torch_convert as tc
    from egonet_tpu.io.orbax_ckpt import TrainCheckpointManager as JMgr
    from egonet_tpu.models.initialization import numpy_init as jinit
    from egonet_tpu.train.lifting import LiftingTrainer as JLift
    cfg, train = lifter
    cfg = copy.deepcopy(cfg)
    cfg["optimizer"].update(optim_type="sgd", lr=0.05)
    t64 = copy.copy(train)
    t64.input = train.input.astype(np.float64)
    t64.output = train.output.astype(np.float64)
    pt = tlift.LiftingTrainer(cfg, dtype=torch.float64, steps_per_epoch=2,
                              device="cpu")
    with TrainCheckpointManager(str(tmp_path / "t")) as mgr:
        state, th = pt.fit(t64, epochs=2, seed=4, ckpt_manager=mgr)
    with jax.enable_x64(True):
        jt = JLift(cfg, dtype=jnp.float64, steps_per_epoch=2)
        var = jax.tree_util.tree_map(
            lambda v: np.array(v, np.float64),
            jinit(jt.model, 4, jnp.zeros((1, 66))))
        from egonet_tpu.train.lifting import TrainState as JState
        jstate = JState(var["params"], var["batch_stats"],
                        jt.tx.init(var["params"]), jnp.zeros((), jnp.int32))
        with JMgr(str(tmp_path / "j"), async_save=False) as jmgr:
            jstate, jh = jt.fit(t64, epochs=2, seed=4, state=jstate,
                                ckpt_manager=jmgr)
        ref = tc.flax_to_torch(jax.device_get(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= 1e-10 * abs(b["loss"])
    got = state.model.state_dict()
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for k, r in ref.items():
        g, r = got[k].numpy(), np.asarray(r)
        if k.endswith("num_batches_tracked") or max(
                float(np.abs(r).max()), float(np.abs(g).max())) \
                < 1e-14 * scale:
            continue        # flax keeps no count; rounding noise both sides
        err = float(np.abs(g - r).max())
        if k.endswith(("running_mean", "running_var")):
            assert err / max(float(np.abs(r).max()), 1.0) <= STATS_TOL, k
        else:
            assert err / max(float(np.abs(r).max()), 1e-300) <= TENSOR_TOL, k
    assert state.step == int(jstate.step)
