"""What the ranks of the data-parallel tests run (tests/test_torch_dp.py,
tests/test_torch_resume.py), in processes spawned by
``egonet_tpu_torch.parallel.mesh.run_ranks``.  No jax here: the ranks import
only the port.  Each function writes its results to ``out_dir`` as
``<name>.rank<r>.pt``; :func:`run_job` also runs in the test process
itself, without a group, for the single-process reference."""

import copy
import os

import numpy as np
import torch

from egonet_tpu_torch.parallel import mesh

STATS = ("running_mean", "running_var", "num_batches_tracked")


def _trainer(kind, cfg):
    if kind == "igr":
        from egonet_tpu_torch.train.igrs import IGRTrainer
        return IGRTrainer(cfg, dtype=torch.float64, device="cpu")
    if kind == "angle":
        from egonet_tpu_torch.train.angle import AngleTrainer
        return AngleTrainer(cfg, dtype=torch.float64, device="cpu")
    from egonet_tpu_torch.train.lifting import LiftingTrainer
    return LiftingTrainer(cfg, dtype=torch.float64, steps_per_epoch=2,
                          device="cpu")


def _local_batch_norm(m, x):
    """Batch norm with this rank's statistics only (a planted fault)."""
    from egonet_tpu_torch.models import layers
    with mesh.solo():
        return layers.batch_norm(m, x, x.dtype)


def run_job(job: dict) -> list:
    """``job``: {"kind": igr / lifter / angle, "cfg", "batches", "apply_cr",
    "local_bn"}.  One step per batch from the seed-0 initial values;
    returns per step {"metrics", "grads", "state"} (every tensor on the
    host, fp64)."""
    from egonet_tpu_torch.models import layers
    trainer = _trainer(job["kind"], copy.deepcopy(job["cfg"]))
    state = trainer.init_state(0)
    saved = layers._group_batch_norm
    if job.get("local_bn"):
        layers._group_batch_norm = _local_batch_norm
    steps = []
    try:
        for batch in job["batches"]:
            if job["kind"] == "igr":
                state, metrics = trainer.train_step(
                    state, batch, job.get("apply_cr", False))
            else:
                state, loss = trainer.train_step(state, batch)
                metrics = {"loss": loss}
            steps.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: p.grad.detach().clone()
                          for n, p in state.model.named_parameters()
                          if p.grad is not None},
                "state": {k: v.detach().clone()
                          for k, v in state.model.state_dict().items()}})
    finally:
        layers._group_batch_norm = saved
    return steps


def train_jobs(out_dir: str, jobs: dict) -> None:
    """Every job of {name: job} on this rank."""
    for name, job in jobs.items():
        torch.save(run_job(job),
                   os.path.join(out_dir, f"{name}.rank{mesh.rank()}.pt"))


def node_shards(out_dir: str, records: list) -> None:
    from egonet_tpu_torch.data.loader import host_shard
    torch.save({"node": mesh.node(), "local": mesh.local_rank(),
                "shard": host_shard(records)},
               os.path.join(out_dir, f"shards.rank{mesh.rank()}.pt"))


def resume_fit(out_dir: str, cfg: dict, records: list) -> None:
    """The IGR trainer's exact resume under the group: 3 epochs straight
    and 2 + 1 resumed, every rank's final state of both (rank 0 writes the
    checkpoints into ``out_dir``)."""
    from egonet_tpu_torch.io.train_ckpt import TrainCheckpointManager
    from egonet_tpu_torch.train.igrs import IGRTrainer

    def fit(directory, epochs, state=None, start=0, trainer=None):
        trainer = trainer or IGRTrainer(copy.deepcopy(cfg), device="cpu")
        with TrainCheckpointManager(directory) as mgr:
            if state is not None:
                state = mgr.restore(state, step=mgr.latest_step())
                start = mgr.latest_step()
            state, _ = trainer.fit(records, epochs=epochs, seed=3,
                                   state=state, ckpt_manager=mgr,
                                   start_epoch=start)
        return state

    full = fit(os.path.join(out_dir, "a"), 3)
    fit(os.path.join(out_dir, "b"), 2)
    trainer = IGRTrainer(copy.deepcopy(cfg), device="cpu")
    resumed = fit(os.path.join(out_dir, "b"), 3, trainer.init_state(0),
                  trainer=trainer)
    torch.save({"full": _full_state(full), "resumed": _full_state(resumed)},
               os.path.join(out_dir, f"resume.rank{mesh.rank()}.pt"))


def _full_state(state) -> dict:
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt.{i}.{k}"] = v.clone()
    out["step"] = torch.tensor(state.step)
    return out


def load(out_dir: str, name: str, world: int) -> list:
    """Every rank's results of ``name``."""
    return [torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def numpy_batches(batches) -> list:
    """Host batches with float arrays as they are and meta kept."""
    return [{k: (np.asarray(v) if k != "meta" else v) for k, v in b.items()}
            for b in batches]
