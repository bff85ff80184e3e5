"""The port's data-parallel training steps (egonet_tpu_torch/train/
{igrs,lifting,angle}.py under a torch.distributed group), on the CPU in
spawned gloo processes (egonet_tpu_torch.parallel.mesh.run_ranks; the rank
programs are tests/torch_dp_ranks.py, which imports no jax).

* Against the single-process step, in float64, at 2 and 4 ranks on a
  divisible instance count: the IGR trainer (cross-ratio off and on,
  frozen layers), the lifter (Adam and SGD with dropout off, SGD with
  dropout 0.5) and the angle trainer, two steps each: the losses within 1e-10 of the total, every
  gradient and stepped parameter within 1e-9 (relative to the tensor's
  largest entry), the BN running statistics within 1e-12 (relative to
  their largest entry, or absolute below 1; 1e-11 for the second step
  with the cross-ratio on and of the angle trainer: the bars of
  tests/test_torch_train.py and tests/test_torch_train_families.py); and
  every rank holds the same values.
* Against the JAX package's ``IGRTrainer(mesh=make_mesh(8))`` step with
  wrap rows: a batch at a cap of 14, padded to 16 by both (the port over 4
  ranks of 4 rows), at the same bars; a per-rank batch norm (the group's
  reduction dropped) fails them.
* ``host_shard`` by node for 2 nodes x 2 ranks; the dry run
  (``tools/dryrun_multigpu``) over 2 gloo ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.io import torch_convert as tc
from egonet_tpu.models.initialization import numpy_init as jinit
from egonet_tpu.parallel import mesh as jmesh
from egonet_tpu_torch.data import kitti as tk
from egonet_tpu_torch.data.loader import ArrayBatchLoader, IGRBatchLoader
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.train import angle as tangle
from tests import torch_dp_ranks as ranks
from tests.test_torch_train import (LOSS_TOL, STATS, STATS_TOL, TENSOR_TOL,
                                    _f64, _igr_cfg, _lift_cfg, root)
from tests.test_torch_train_families import _angle_cfg

torch.set_num_threads(2)
assert root                     # the module-scoped KITTI root fixture
TIMEOUT_S = 300


def _f64_batch(batch, keys=("joints", "mask", "sup_mask", "angle_target",
                            "input", "output")):
    return {k: (v.astype(np.float64) if k in keys else v)
            for k, v in batch.items()}


def _jobs(root_dir):
    """{name: job} of the DP-vs-single comparison: two steps each, on
    batches of 8 instance rows (divisible by 2 and 4; the IGR and angle
    batches carry padding slots, and take the split's one batch twice)."""
    jobs = {}
    for case, freeze, cr in (("igr_cr_off", (), False),
                             ("igr_cr_on", (), True),
                             ("igr_frozen", ("conv1", "bn1", "layer1"),
                              False)):
        cfg = _igr_cfg(root_dir, freeze=freeze)
        records = tk.KITTIDataset(cfg, "train").records
        batches = (list(IGRBatchLoader(records, cfg, train=True,
                                       max_instances=8).epoch()) * 2)[:2]
        jobs[case] = {"kind": "igr", "cfg": cfg, "apply_cr": cr,
                      "batches": [_f64_batch(b) for b in batches]}
    for name, opt, dropout in (("lifter_adam", "adam", 0.0),
                               ("lifter_sgd", "sgd", 0.0),
                               ("lifter_dropout", "sgd", 0.5)):
        cfg = _lift_cfg(root_dir, dropout=dropout, optim_type=opt)
        train, _ = tk.prepare_data(cfg)
        batches = list(ArrayBatchLoader(train.input[:64], train.output[:64],
                                        8, seed=0).epoch())[:2]
        jobs[name] = {"kind": "lifter", "cfg": cfg,
                      "batches": [_f64_batch(b) for b in batches]}
    cfg = _angle_cfg(root_dir, "baselinealpha", "hrnet")
    records = tk.KITTIDataset(cfg, "train").records
    batches = (list(tangle.AngleBatchLoader(records, cfg, train=True,
                                            angle_index=0,
                                            max_instances=8).epoch())
               * 2)[:2]
    jobs["angle"] = {"kind": "angle", "cfg": cfg,
                     "batches": [_f64_batch(b) for b in batches]}
    return jobs


@pytest.fixture(scope="module")
def jobs(root):
    return _jobs(root)


@pytest.fixture(scope="module")
def single(jobs):
    """The single-process steps (no group), here in the test process."""
    return {name: ranks.run_job(job) for name, job in jobs.items()}


@pytest.fixture(scope="module", params=[2, 4])
def dp(request, jobs, tmp_path_factory):
    world = request.param
    out = str(tmp_path_factory.mktemp(f"dp{world}"))
    mesh.run_ranks(ranks.train_jobs, world, args=(out, jobs),
                   timeout_s=TIMEOUT_S)
    return world, {name: ranks.load(out, name, world) for name in jobs}


def _rel(got, ref):
    got, ref = (np.asarray(x, np.float64) for x in (got, ref))
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def _noise(grads: dict) -> set:
    """Parameters whose gradient is rounding noise (below 1e-10 of the
    largest): biases feeding batch norm, whose gradient is zero
    analytically.  Adam divides such noise by 1e-8 and moves them by it."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in grads.values())
    return {k for k, v in grads.items()
            if float(np.abs(np.asarray(v)).max()) < 1e-10 * scale}


def _hold(got: dict, ref: dict, what: str, stats_tol: float, grads=False,
          noise=(), step_size=0.0):
    """Every tensor of ``got`` against ``ref`` at the module's bars:
    analytically-zero tensors (both sides below 1e-14 of the largest) are
    rounding noise on both sides and skipped; the parameters in ``noise``
    moved by rounding noise only and are held within 1e-6 of
    ``step_size`` (tests/test_torch_train.py's rule)."""
    assert set(got) == set(ref), what
    scale = max(float(np.abs(np.asarray(v, np.float64)).max())
                for k, v in ref.items() if not k.endswith(STATS))
    for k, r in ref.items():
        g, r = np.asarray(got[k], np.float64), np.asarray(r, np.float64)
        if k in noise:
            assert float(np.abs(g - r).max()) <= 1e-6 * step_size, (what, k)
        elif k.endswith(STATS):
            err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                                   1.0)
            assert err <= stats_tol, (what, k, err)
        elif max(float(np.abs(r).max()), float(np.abs(g).max())) \
                < 1e-14 * scale:
            continue
        else:
            assert _rel(g, r) <= TENSOR_TOL, (what, k, _rel(g, r),
                                              "grad" if grads else "")


@pytest.mark.parametrize("name", ["igr_cr_off", "igr_cr_on", "igr_frozen",
                                  "lifter_adam", "lifter_sgd",
                                  "lifter_dropout", "angle"])
def test_dp_steps_match_the_single_process_steps(dp, single, jobs, name):
    """``lifter_dropout`` (p = 0.5): each rank draws the global batch's
    mask and keeps its rows, so the step does not depend on the split."""
    world, results = dp
    want = single[name]
    for r, steps in enumerate(results[name]):
        assert len(steps) == len(want) == 2
        for i, (got, ref) in enumerate(zip(steps, want)):
            what = f"{name} rank {r}/{world} step {i}"
            total = abs(ref["metrics"]["loss"])
            for k, v in ref["metrics"].items():
                assert abs(got["metrics"][k] - v) <= LOSS_TOL * total, \
                    (what, k, got["metrics"][k], v)
            _hold(got["grads"], ref["grads"], what, STATS_TOL, grads=True)
            # the second step's statistics come from parameters the first
            # left 1e-12 apart: with the cross-ratio on, and in the angle
            # trainer, that gap reaches a few BN variances (ROADMAP
            # section 3), held at 1e-11 as against the JAX trainers
            stats_tol = 1e-11 if i and (jobs[name].get("apply_cr")
                                        or jobs[name]["kind"] == "angle") \
                else STATS_TOL
            noise = (_noise(ref["grads"]) if i == 0
                     else _noise(ref["grads"]) | _noise(want[0]["grads"]))
            _hold(got["state"], ref["state"], what, stats_tol, noise=noise,
                  step_size=jobs[name]["cfg"]["optimizer"]["lr"])
            # the ranks are replicas: rank 0's values, bit for bit
            for k, v in got["state"].items():
                assert torch.equal(v, results[name][0][i]["state"][k]), \
                    (what, k)
    if name == "igr_frozen":
        assert not any(k.split(".")[0] in ("conv1", "bn1", "layer1")
                       for k in results[name][0][0]["grads"])


# ------------------------------------------------------------ the JAX mesh

@pytest.fixture(scope="module")
def capped(root, tmp_path_factory):
    """A batch at a cap of 14 instances (2 frames x 8 boxes, subsampled),
    the JAX package's eager crops of it, the config; and the port's
    4-rank step on it, with and without the group's batch norm."""
    from egonet_tpu.data.loader import IGRBatchLoader as JIGRLoader
    from egonet_tpu.train.igrs import IGRTrainer as JT
    from egonet_tpu_torch.tools.dryrun_multigpu import write_records
    cfg = _igr_cfg(root)
    d = str(tmp_path_factory.mktemp("capped"))
    records = write_records(d, np.random.RandomState(2), 2, 8, (128, 416),
                            ((30, 79), (20, 49)))
    batch = next(JIGRLoader(records, cfg, train=True, canvas_hw=(128, 416),
                            max_instances=14, seed=0).epoch())
    assert len(batch["mask"]) == 14 and batch["mask"].sum() == 14
    crops = np.asarray(JT(cfg)._crops_from_batch(
        {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}))
    batch = _f64_batch(batch)
    job = {"kind": "igr", "cfg": cfg, "apply_cr": True, "batches": [batch]}
    out = str(tmp_path_factory.mktemp("capped_dp"))
    mesh.run_ranks(ranks.train_jobs, 4,
                   args=(out, {"group_bn": job,
                               "rank_bn": dict(job, local_bn=True)}),
                   timeout_s=TIMEOUT_S)
    return cfg, batch, crops, {name: ranks.load(out, name, 4)
                               for name in ("group_bn", "rank_bn")}


@pytest.fixture(scope="module")
def jax_mesh_step(capped):
    """The JAX mesh step (8 devices, the batch padded to 16 with wrap rows
    by the trainer) in float64, and the gradient of its loss on the same
    padded batch."""
    from egonet_tpu.train.igrs import IGRTrainer as JT
    cfg, batch, crops, _ = capped
    with jax.enable_x64(True):
        jt = JT(cfg, mesh=jmesh.make_mesh(8), dtype=jnp.float64)
        var = _f64(jinit(jt.model, 0, jnp.zeros((1, 64, 64, 3))))
        state = jt.init_state(0, variables=var)
        jt._crops_from_batch = lambda b: b["crops"]
        jb = dict(batch, crops=crops)
        padded = jmesh.pad_instance_batch(
            {k: v for k, v in jb.items() if k != "meta"}, 8)
        assert len(padded["mask"]) == 16 and padded["mask"][14:].sum() == 0
        _, g = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True),
                       static_argnums=3)(
            var["params"], var["batch_stats"],
            {k: jnp.asarray(v) for k, v in padded.items()}, True)
        state, metrics = jt.train_step(state, jb, apply_cr=True)
        stepped = tc.flax_to_torch(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}))
        grads = tc.flax_to_torch(jax.device_get({"params": g}))
        metrics = {k: float(v) for k, v in metrics.items()}
    return metrics, grads, stepped


def _hold_jax(steps, jax_step, what):
    metrics, grads, stepped = jax_step
    for r, [got] in enumerate(steps):
        total = abs(metrics["loss"])
        for k, v in metrics.items():
            assert abs(got["metrics"][k] - v) <= LOSS_TOL * total, \
                (what, r, k, got["metrics"][k], v)
        _hold(got["grads"], grads, f"{what} rank {r}", STATS_TOL,
              grads=True)
        state = {k: v for k, v in got["state"].items()
                 if not k.endswith("num_batches_tracked")}
        _hold(state, {k: v for k, v in stepped.items()
                      if not k.endswith("num_batches_tracked")},
              f"{what} rank {r}", STATS_TOL)


def test_dp_step_matches_the_jax_mesh_step_with_wrap_rows(capped,
                                                          jax_mesh_step):
    """4 ranks x 4 rows of the 16 (14 real + 2 wrap rows, mask 0) against
    JAX's 8 devices x 2 rows: loss and components, gradients, stepped
    parameters and BN statistics (over all 16 rows) at the bars."""
    _hold_jax(capped[3]["group_bn"], jax_mesh_step, "group batch norm")


def test_per_rank_batch_norm_fails_the_jax_mesh_bars(capped, jax_mesh_step):
    """The planted fault: each rank normalizing with its own 4 rows'
    statistics misses the bars (the loss already)."""
    with pytest.raises(AssertionError):
        _hold_jax(capped[3]["rank_bn"], jax_mesh_step, "per-rank BN")
    got = capped[3]["rank_bn"][0][0]["metrics"]["loss"]
    assert abs(got - jax_mesh_step[0]["loss"]) > 1e-6 * abs(got)


# ------------------------------------------------------------ nodes, dry run

def test_host_shard_by_node_2_nodes_x_2_ranks(tmp_path):
    """4 ranks, 2 to a node: the ranks of a node read the same records,
    the nodes disjoint records covering all of them."""
    recs = list(range(11))
    mesh.run_ranks(ranks.node_shards, 4, args=(str(tmp_path), recs),
                   local_world_size=2, timeout_s=TIMEOUT_S)
    got = ranks.load(str(tmp_path), "shards", 4)
    assert [g["node"] for g in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [g["local"] for g in got] == [0, 1, 0, 1]
    assert got[0]["shard"] == got[1]["shard"] == [0, 2, 4, 6, 8, 10]
    assert got[2]["shard"] == got[3]["shard"] == [1, 3, 5, 7, 9, 1]
    assert set(got[0]["shard"]) | set(got[2]["shard"]) == set(recs)
    assert not set(got[0]["shard"]) & set(got[2]["shard"][:-1])


def test_dryrun_over_two_gloo_ranks(tmp_path, capfd):
    """The dry run on the CPU over 2 gloo ranks: every leg but the
    full-width W48 and the resume (tests/test_torch_resume.py holds it
    over 2 ranks) prints its ok line.  Through its CLI on one rank it
    runs the legs that need no group and skips the others for that
    reason, not for the budget."""
    from egonet_tpu_torch.tools import dryrun_multigpu
    out = tmp_path / "dry.json"
    legs = ("train_parity", "inference_parity", "node_shards",
            "lifter_parity")
    mesh.run_ranks(dryrun_multigpu._rank, 2,
                   args=("cpu", 1e9, str(out), legs), timeout_s=TIMEOUT_S)
    summary = json.loads(out.read_text())
    assert summary["ranks"] == 2 and summary["backend"] == "gloo"
    assert set(summary["legs"]) == {"sharded_train", *legs}
    assert summary["skipped"] == {}
    text = capfd.readouterr().out
    assert text.count("[dryrun leg ok]") == 5
    assert "sharded_train: 2 ranks, 140 instances" in text
    dryrun_multigpu.main(["--device", "cpu", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["ranks"] == 1 and summary["backend"] is None
    assert set(summary["legs"]) == {"sharded_train", "node_shards"}
    assert summary["skipped"] == {
        name: "one rank" for name in dryrun_multigpu.GROUP_LEGS}
    assert "budget" not in capfd.readouterr().out
