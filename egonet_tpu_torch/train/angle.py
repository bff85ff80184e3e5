"""Baseline angle-regression training (exp types 'baselinealpha' /
'baselinetheta'), port of ``egonet_tpu/train/angle.py``.

A heatmap model with the 'angleregression' head predicts [cos a, sin a]
of the observation angle alpha (``rots[:, 0]``) or of the global yaw
(``rots[:, 1]``) straight from the crop; the loss is the masked MSE on
that unit-circle embedding (``losses.mse_loss_1d``) and evaluation the
mean angle error in degrees (``metrics.get_angle_error``).  The crops are
warped on the device as in the IGR trainer (``igrs.CropTrainer``).  Runs
on CUDA unless asked for the CPU (``device="cpu"``); raises without a
card.
"""

from __future__ import annotations

import numpy as np
import torch

from egonet_tpu_torch.data.loader import IGRBatchLoader
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.train import losses
from egonet_tpu_torch.train.igrs import _FLOAT_KEYS, CropTrainer, TrainState
from egonet_tpu_torch.train.metrics import get_angle_error
from egonet_tpu_torch.utils.profiling import span


class AngleBatchLoader(IGRBatchLoader):
    """IGR batches plus ``angle_target`` [M, 2] (cos, sin of each real
    instance's angle, zeros in the padding) and ``meta['angles_gt']``.

    exp_type 'baselinealpha' regresses alpha (rots[:, 0]);
    'baselinetheta' regresses the global yaw ry (rots[:, 1])."""

    def __init__(self, records, cfgs, train, angle_index: int, **kw):
        super().__init__(records, cfgs, train, **kw)
        self.angle_index = angle_index

    def _assemble(self, chunk):
        batch = super()._assemble(chunk)
        m = batch["meta"]["count"]
        # (chunk index, box index) per kept instance in batch order keeps
        # the targets aligned with the crops after any cap subsampling
        ids = batch["meta"]["instance_ids"]
        angles = np.asarray(
            [chunk[i]["rots"][j, self.angle_index] for i, j in ids],
            np.float64)
        target = np.zeros((len(batch["mask"]), 2), np.float32)
        target[:m, 0] = np.cos(angles)
        target[:m, 1] = np.sin(angles)
        batch["angle_target"] = target
        batch["meta"]["angles_gt"] = angles
        return batch


class AngleTrainer(CropTrainer):
    float_keys = _FLOAT_KEYS + ("angle_target",)

    def __init__(self, cfgs: dict, dtype=torch.float32,
                 steps_per_epoch: int = 1, logger=None, device=None):
        if cfgs["heatmapModel"].get("head_type") != "angleregression":
            raise ValueError("the angle trainer needs heatmapModel.head_type "
                             "'angleregression'")
        super().__init__(cfgs, dtype, steps_per_epoch, logger, device)
        self.angle_index = 0 if cfgs["exp_type"] == "baselinealpha" else 1

    def _freeze_layers(self):
        return []                       # the JAX angle trainer freezes none

    def loss_fn(self, model, batch):
        crops = self._crops_from_batch(batch)
        with span("forward"):
            out = model(crops.permute(0, 3, 1, 2))
        with span("loss"):
            return losses.mse_loss_1d(out, batch["angle_target"],
                                      batch["mask"])

    def train_step(self, state: TrainState, batch):
        """One step (data parallel in a process group, as the IGR
        trainer's); returns (state, the global batch's loss as a device
        scalar)."""
        b = self._train_batch(batch)
        state.model.train()
        loss = self.loss_fn(state.model, b)
        state = self._apply_step(state, loss)
        return state, mesh.all_reduce_values({"loss": loss})["loss"]

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """Eval-mode forward (running statistics): [M, 2]."""
        b = self._device_batch(batch)
        state.model.eval()
        out = state.model(self._crops_from_batch(b).permute(0, 3, 1, 2))
        state.model.train()
        return out

    def evaluate(self, state, records) -> float:
        """Mean angle error in degrees over a record set."""
        loader = AngleBatchLoader(records, self.cfgs, train=False,
                                  angle_index=self.angle_index)
        total_err, total_cnt = 0.0, 0
        for batch in loader.epoch(shuffle=False):
            m = batch["meta"]["count"]
            pred = self.eval_step(state, batch)[:m].float().cpu().numpy()
            err, cnt = get_angle_error(pred, batch["meta"]["angles_gt"])
            total_err += err * cnt
            total_cnt += cnt
        mean_err = total_err / max(total_cnt, 1)
        if self.logger:
            self.logger.info(f"angle error: {mean_err:.3f} deg "
                             f"({total_cnt} instances)")
        return mean_err
