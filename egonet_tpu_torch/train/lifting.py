"""Stage-1 training: the FC 2D->3D lifting model (port of
``egonet_tpu/train/lifting.py``).

In-RAM normalized (input, output) pairs, large batches, MSE loss, Adam and
a multi-step rate.  The trainer runs on CUDA unless asked for the CPU
(``device="cpu"``).  Dropout masks come from a ``torch.Generator`` seeded
from (seed, step), so a run is repeatable; they are not the JAX package's
masks (its ``fold_in`` stream has no torch counterpart).

In a process group of several ranks the step is data parallel, as the IGR
trainer's (``train/igrs.py``): each rank keeps its rows of its node's
batch, batch norm and the loss count are the global batch's, gradients are
summed, and each rank draws the global batch's dropout mask and keeps its
rows.  ``fit`` takes the exact-resume contract of the IGR trainer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from egonet_tpu_torch.data.loader import ArrayBatchLoader
from egonet_tpu_torch.device import full_precision_fp32, resolve_device
from egonet_tpu_torch.models.fc_lifter import FCModel, build_fc_model
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.train import losses, optim


@dataclass
class TrainState:
    """The model in train mode, its optimizer and the count of steps
    taken (the schedule reads it)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of one step: a function of (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) + 1) * 1_000_003 + int(step)) & 0x7FFFFFFF)
    return g


class LiftingTrainer:
    def __init__(self, cfgs: dict, dtype=torch.float32,
                 steps_per_epoch: int = 1, logger=None, device=None):
        self.cfgs = cfgs
        self.dtype = dtype
        self.logger = logger if mesh.is_main() else None
        self.device = resolve_device(device)
        self.steps_per_epoch = int(steps_per_epoch)
        self._eval_calls = 0
        full_precision_fp32()
        fc = cfgs.get("FCModel", {})
        loss_type = fc.get("loss_type", "MSELoss1D")
        if loss_type == "MSELoss1D":
            self._loss = losses.mse_loss_1d
        elif loss_type == "SmoothL1Loss1D":
            self._loss = losses.smooth_l1_loss_1d
        else:
            raise NotImplementedError(loss_type)
        self.loss_sum = fc.get("loss_reduction", "mean") == "sum"

    def build_model(self, rng_seed: int = 0) -> FCModel:
        """The lifter with the JAX package's initial values for
        ``rng_seed`` (rank 0's on every rank), on the trainer's device."""
        model = numpy_init(build_fc_model(self.cfgs, dtype=self.dtype),
                           rng_seed).to(self.device)
        mesh.broadcast_module(model)
        return model

    def init_state(self, rng_seed: int = 0, model=None) -> TrainState:
        model = model if model is not None else self.build_model(rng_seed)
        model.train()
        opt, self.schedule = optim.prepare_optim(
            self.cfgs, model.parameters(), self.steps_per_epoch)
        return TrainState(model, opt, 0)

    def _device_batch(self, batch):
        return {k: (v if k == "shard"
                    else torch.as_tensor(np.asarray(v)).to(self.device))
                for k, v in batch.items()}

    def loss_fn(self, model, batch, generator=None):
        rows = (mesh.global_rows(batch["shard"]) if "shard" in batch
                else None)
        out = model(batch["input"], generator=generator, rows=rows)
        loss = self._loss(out, batch["output"], batch["mask"])
        if self.loss_sum:
            # reduction='sum': the total, not the per-element mean
            loss = loss * mesh.all_reduce_count(torch.broadcast_to(
                batch["mask"][:, None], out.shape).sum())
        return loss

    def train_step(self, state: TrainState, batch, seed: int = 0):
        """One Adam / SGD step on a host batch {input, output, mask}, the
        dropout masks drawn from (seed, step); returns (state, the global
        batch's loss, a tensor on the device)."""
        b = self._device_batch(mesh.shard_batch(batch, replicated_keys=()))
        g = step_generator(seed, state.step, self.device)
        state.model.train()
        loss = self.loss_fn(state.model, b, g)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mesh.all_reduce_grads(state.model.parameters())
        optim.set_lr(state.optimizer, self.schedule(state.step))
        state.optimizer.step()
        state.step += 1
        return state, mesh.all_reduce_values({"loss": loss})["loss"]

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """Eval-mode forward; with ``testing_settings.apply_dropout`` the
        dropout stays on (a fresh mask per call), so the loss compares with
        the training loss."""
        apply_dropout = bool(self.cfgs.get("testing_settings", {})
                             .get("apply_dropout", False))
        g = None
        if apply_dropout:
            g = step_generator(17, self._eval_calls, self.device)
            self._eval_calls += 1
        state.model.eval()
        x = torch.as_tensor(np.asarray(batch["input"], np.float32),
                            device=self.device)
        out = state.model(x, apply_dropout=apply_dropout or None,
                          generator=g)
        state.model.train()
        return out

    def fit(self, train_set, valid_set=None, epochs=None, seed: int = 0,
            state=None, ckpt_manager=None, start_epoch: int = 0):
        """train_set: KITTIDataset with exp_type '2dto3d' (normalized).
        Returns (state, history: per epoch loss, seconds and, with a valid
        set, its MSE).  ``ckpt_manager`` / ``state`` / ``start_epoch``:
        exact resume, as in ``IGRTrainer.fit``."""
        settings = self.cfgs.get("training_settings", {})
        epochs = epochs or int(settings.get("total_epochs", 1))
        batch_size = int(settings.get("batch_size", 2048))
        loader = ArrayBatchLoader(train_set.input, train_set.output,
                                  batch_size, seed=seed)
        if state is None:
            state = self.init_state(seed)
        history = []
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch)
            if ckpt_manager is not None or start_epoch:
                loader.reseed((seed + 1) * 1_000_003 + epoch)
            t0 = time.time()
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            n = 0
            for batch in loader.epoch():
                state, loss = self.train_step(state, batch, seed)
                total += loss
                n += 1
            history.append({"epoch": epoch, "loss": float(total) / max(n, 1),
                            "seconds": time.time() - t0})
            if self.logger:
                self.logger.info(f"lifter epoch {epoch}: "
                                 f"loss {history[-1]['loss']:.6f}")
            if valid_set is not None and len(valid_set.input):
                preds = self.predict(state, valid_set.input)
                mse = float(np.mean((preds - valid_set.output) ** 2))
                history[-1]["valid_mse"] = mse
                if self.logger:
                    self.logger.info(f"lifter epoch {epoch}: "
                                     f"valid mse {mse:.6f}")
            if ckpt_manager is not None:
                ckpt_manager.save(epoch + 1, state)
        if ckpt_manager is not None:
            ckpt_manager.wait_until_finished()
        return state, history

    def evaluate(self, state, valid_set, metrics=None,
                 visualize_dir: str | None = None, sample_num: int = 9):
        """Metric-registry evaluation with un-normalized outputs
        (``testing_settings.unnormalize``).  ``visualize_dir`` saves the
        pred-vs-GT cuboid figure there as ``lifting_eval.png``."""
        from egonet_tpu_torch.train.metrics import Evaluator
        metrics = metrics or self.cfgs.get("training_settings", {}).get(
            "eval_metrics", ["RError3D"])
        num_joints = int(self.cfgs.get("heatmapModel", {})
                         .get("num_joints", 33))
        evaluator = Evaluator(metrics, cfgs=self.cfgs, num_joints=num_joints)
        preds = self.predict(state, valid_set.input)
        gts = valid_set.output
        inputs = valid_set.input
        if self.cfgs.get("testing_settings", {}).get("unnormalize", True) \
                and valid_set.statistics is not None:
            stats = valid_set.statistics
            preds = preds * stats["std_out"] + stats["mean_out"]
            gts = gts * stats["std_out"] + stats["mean_out"]
            inputs = inputs * stats["std_in"] + stats["mean_in"]
        evaluator.update(preds, ground_truth=gts, logger=self.logger)
        if self.logger:
            evaluator.report(self.logger)
        if visualize_dir and len(preds):
            import os
            from egonet_tpu_torch.visualization.overlays import (
                visualize_lifting_results)
            os.makedirs(visualize_dir, exist_ok=True)
            path = visualize_lifting_results(
                inputs, preds, target=gts, sample_num=sample_num,
                save_path=os.path.join(visualize_dir, "lifting_eval.png"))
            if self.logger:
                self.logger.info(f"wrote {path}")
        return evaluator

    def predict(self, state, inputs, batch_size: int = 4096):
        outs = []
        for start in range(0, len(inputs), batch_size):
            out = self.eval_step(state, {"input": inputs[start:start
                                                         + batch_size]})
            outs.append(out.float().cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,))
