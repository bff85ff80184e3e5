"""Stage-2 training: the keypoint (IGR) model, any heatmap family with a
'coordinates' head (the W48 / W32 HRNet, PoseNetTPU), with the layers of
``extra.freeze_layers`` frozen (port of ``egonet_tpu/train/igrs.py``).

One step: the host batch goes to the device (``h2d``), every instance is
cropped there by the separable warp (``warp``) and normalized
(``normalize``), the model runs in train mode (``forward``), the Gaussian
targets are rendered (``targets``), the composite loss is taken
(``loss``), then ``backward`` and the ``optimizer`` step.  Each stage is a
named range (``utils/profiling.TRAIN_SPANS``), so a trace charges the
device time to it.  The cross-ratio term switches on from epoch 1.  The
trainer runs on CUDA unless asked for the CPU (``device="cpu"``); fp32
runs keep TF32 off.

In a process group of several ranks (``parallel/mesh``; the JAX trainer's
``mesh``) the step is data parallel: every rank of a node builds the
node's batch, keeps its rows (``mesh.shard_batch``), normalizes with the
global batch's statistics and loss counts, and the gradients are summed
over the ranks before the step; rank 0's initial values are broadcast,
and only rank 0 logs, evaluates and writes files.  ``fit`` saves the full
state after each epoch through a ``TrainCheckpointManager``
(``io/train_ckpt.py``) and resumes from one (``state``, ``start_epoch``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from egonet_tpu_torch.data.loader import IGRBatchLoader
from egonet_tpu_torch.device import full_precision_fp32, resolve_device
from egonet_tpu_torch.models.factory import build_heatmap_model
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.ops import affine
from egonet_tpu_torch.ops.keypoints import gaussian_targets
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.train import losses, optim
from egonet_tpu_torch.utils.profiling import span

_FLOAT_KEYS = ("inv_mats", "joints", "mask", "sup_mask", "img_wh")


class _Laps:
    """Wall seconds by phase: each call charges the time since the
    previous call to the phase it names."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def __call__(self, phase: str):
        t = time.perf_counter()
        self.seconds[phase] = self.seconds.get(phase, 0.0) + t - self._t
        self._t = t


@dataclass
class TrainState:
    """The model in train mode, its optimizer and the count of steps
    taken (the schedule reads it)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class CropTrainer:
    """What the IGR and angle trainers share: a heatmap model trained on
    crops that the device warps out of the batch's frames; its initial
    state, the host batch's copy to the device and the crops."""

    float_keys = _FLOAT_KEYS

    def __init__(self, cfgs: dict, dtype=torch.float32,
                 steps_per_epoch: int = 1, logger=None, device=None):
        self.cfgs = cfgs
        self.dtype = dtype
        self.logger = logger if mesh.is_main() else None
        self.device = resolve_device(device)
        self.steps_per_epoch = int(steps_per_epoch)
        full_precision_fp32()
        self.input_size = tuple(cfgs["heatmapModel"]["input_size"])  # (w, h)
        self.model = build_heatmap_model(cfgs, dtype=dtype)

    def _freeze_layers(self):
        return (self.cfgs["heatmapModel"].get("extra") or {}).get(
            "freeze_layers", [])

    def init_state(self, rng_seed: int = 0, variables=None) -> TrainState:
        """The model with the JAX package's initial values for
        ``rng_seed``, or with ``variables`` (a ``state_dict``, loaded
        strictly), on the device in train mode (rank 0's values on every
        rank), with the frozen layers (``extra.freeze_layers``) left out of
        the optimizer."""
        model = self.model
        if variables is None:
            numpy_init(model, rng_seed)
        else:
            model.load_state_dict(variables, strict=True)
        model.to(self.device, memory_format=torch.channels_last)
        mesh.broadcast_module(model)
        model.train()
        params = optim.apply_freezing(model, self._freeze_layers())
        opt, self.schedule = optim.prepare_optim(self.cfgs, params,
                                                 self.steps_per_epoch)
        return TrainState(model, opt, 0)

    def _device_batch(self, batch):
        """Host batch -> device tensors (pinned, asynchronous copies on the
        card).  ``img_idx`` stays on the host (the warp reads each
        instance's frame as a view); ``meta`` and a data-parallel shard's
        place (``shard``) are kept as they are."""
        if isinstance(batch.get("mask"), torch.Tensor):
            return batch                    # already transferred (prefetch)
        out = {"img_idx": np.asarray(batch["img_idx"])}
        for k in ("meta", "shard"):
            if k in batch:
                out[k] = batch[k]
        cuda = self.device.type == "cuda"
        with span("h2d"):
            for k in ("images",) + self.float_keys:
                if k not in batch:
                    continue
                t = torch.from_numpy(np.ascontiguousarray(batch[k]))
                if cuda:
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=cuda)
        return out

    def _crops_from_batch(self, batch):
        """Warp + normalize every instance of the batch on the device (+
        the xy channels of add_xy models).  Returns NHWC float32."""
        w, h = self.input_size
        with span("warp"):
            patches = affine.warp_affine_separable(
                batch["images"], batch["inv_mats"], batch["img_idx"], (h, w))
        with span("normalize"):
            return affine.normalize_crop_patches(
                self.cfgs, patches, batch["inv_mats"], batch.get("img_wh"),
                (h, w))

    def _train_batch(self, batch):
        """This rank's rows of a host batch (all of it in one process) on
        the device."""
        return self._device_batch(mesh.shard_batch(batch))

    def _apply_step(self, state: TrainState, loss):
        """Backward, the gradients summed over the ranks, and the optimizer
        step at the schedule's rate."""
        with span("backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh.all_reduce_grads(state.model.parameters())
        with span("optimizer"):
            optim.set_lr(state.optimizer, self.schedule(state.step))
            state.optimizer.step()
        state.step += 1
        return state


def _real_rows(batch) -> int:
    """How many of the batch's rows (a shard's, in a data-parallel run)
    are real instances: the padding follows them."""
    m = batch["meta"]["count"]
    if "shard" not in batch:
        return m
    start, stop, _ = batch["shard"]
    return max(0, min(m, stop) - start)


class IGRTrainer(CropTrainer):
    def __init__(self, cfgs: dict, dtype=torch.float32,
                 steps_per_epoch: int = 1, logger=None, device=None):
        super().__init__(cfgs, dtype, steps_per_epoch, logger, device)
        self.loss_cfg = losses.CompositeLossConfig(cfgs)
        hm = cfgs["heatmapModel"]
        self.heatmap_size = tuple(hm.get("heatmap_size", (64, 64)))
        self.sigma = float(hm.get("sigma", 1.0))
        self.use_tw = bool(cfgs.get("training_settings", {})
                           .get("use_target_weight", False))

    # ------------------------------------------------------------------

    def loss_fn(self, model, batch, apply_cr: bool):
        """(total, {component: value}) of one device batch."""
        crops = self._crops_from_batch(batch)
        with span("forward"):
            outputs = model(crops.permute(0, 3, 1, 2))
        joints = batch["joints"]                            # [M, K, 3]
        w, h = self.input_size
        with span("targets"):
            targets, tweight = gaussian_targets(
                joints[..., :2], joints[..., 2],
                (self.heatmap_size[1], self.heatmap_size[0]), (h, w),
                self.sigma)
        with span("loss"):
            return losses.composite_loss(
                outputs, targets, joints[..., :2], self.loss_cfg,
                mask=batch["mask"], apply_cr=apply_cr,
                target_weight=tweight if self.use_tw else None,
                sup_mask=batch.get("sup_mask"))

    def train_step(self, state: TrainState, batch, apply_cr: bool = False):
        """One step; returns (state, {"loss", components...} as device
        scalars of the global batch: reading one waits for the step)."""
        b = self._train_batch(batch)
        state.model.train()
        total, comps = self.loss_fn(state.model, b, apply_cr)
        state = self._apply_step(state, total)
        return state, mesh.all_reduce_values({"loss": total, **comps})

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """Eval-mode forward (running statistics; bf16 models run the fused
        kernels): {"maps", "coords"}."""
        b = self._device_batch(batch)
        state.model.eval()
        crops = self._crops_from_batch(b)
        maps, coords = state.model(crops.permute(0, 3, 1, 2))
        state.model.train()
        return {"maps": maps, "coords": coords}

    # ------------------------------------------------------------------

    def evaluate(self, state, records, metrics=None):
        """Validation metrics over a record set; one validation loader is
        kept across calls, so its decoded frames are reused."""
        from egonet_tpu_torch.train.metrics import Evaluator
        metrics = metrics or self.cfgs.get("testing_settings", {}).get(
            "eval_metrics", ["JointDistance2DSIP"])
        evaluator = Evaluator(metrics, cfgs=self.cfgs,
                              num_joints=self.cfgs["heatmapModel"]
                              ["num_joints"])
        cached = getattr(self, "_eval_loader", None)
        if cached is None or cached[0] is not records:
            cached = (records,
                      IGRBatchLoader(records, self.cfgs, train=False,
                                     shard_hosts=False))
            self._eval_loader = cached
        for batch in cached[1].epoch(shuffle=False):
            meta = batch["meta"]
            out = self.eval_step(state, batch)
            m = meta["count"]
            evaluator.update((out["maps"][:m].float().cpu().numpy(),
                              out["coords"][:m].float().cpu().numpy()),
                             meta_data=meta, logger=self.logger)
        if self.logger:
            evaluator.report(self.logger)
        return evaluator

    def save_snapshot(self, state, path_prefix: str):
        """Write ``<path_prefix>.msgpack`` (flax's) and ``.pth``; returns
        the ``.pth`` path."""
        from egonet_tpu_torch.io import checkpoint
        checkpoint.save_variables(path_prefix + ".msgpack", state.model)
        return checkpoint.save_torch_state_dict(path_prefix + ".pth",
                                                state.model)

    @torch.no_grad()
    def debug_dump(self, state, batch, prefix: str):
        """Keypoint and heatmap debug grids of one batch's real instances
        (``visualization/debug.save_debug_images``)."""
        from egonet_tpu_torch.visualization import debug as vdbg
        b = self._device_batch(batch)
        crops = self._crops_from_batch(b).cpu().numpy()
        out = self.eval_step(state, b)
        m = _real_rows(b)
        w, h = self.input_size
        coords = out["coords"][:m].float().cpu().numpy() * np.array([w, h])
        joints = b["joints"][:m]
        targets, _ = gaussian_targets(
            joints[..., :2], joints[..., 2],
            (self.heatmap_size[1], self.heatmap_size[0]), (h, w), self.sigma)
        return vdbg.save_debug_images(
            self.cfgs, crops[:m], joints.cpu().numpy(), coords,
            targets.cpu().numpy(), out["maps"][:m].float().cpu().numpy(),
            prefix)

    def fit(self, train_records, valid_records=None, epochs=None,
            seed: int = 0, report_every: int | None = None, eval_hook=None,
            snapshot_dir: str | None = None, state=None,
            ss_record=None, ss_img_root: str = "", ss_max_per_img: int = 6,
            ckpt_manager=None, start_epoch: int = 0, loader_kwargs=None):
        """The training loop: a loader per run, cross-ratio from epoch 1,
        logging every ``report_every`` batches, debug grids at each
        period's batch 0 (``training_settings.debug``), evaluation every
        ``eval_every`` batches and after each epoch (``eval_during``), and
        snapshots at ``snapshot_epochs``.  Each step's loss is read one step
        late, so the host never waits for the step it just launched.
        ``ckpt_manager`` (``io/train_ckpt.TrainCheckpointManager``) saves
        the full state after every epoch (asynchronously, drained at the
        end); to resume exactly, pass the ``state`` restored from it and
        ``start_epoch`` = its latest step.  With either, each epoch's
        shuffle is keyed by (seed, epoch), so a resumed run sees the
        batches the uninterrupted one would.
        Returns (state, history: per epoch loss, seconds and ``split``,
        the epoch's wall seconds by what the host was doing: ``load``
        waiting for the loader's next batch, ``step`` launching the steps
        and waiting for them on the device, ``debug`` writing the grids,
        ``eval`` evaluating mid-epoch)."""
        settings = self.cfgs.get("training_settings", {})
        epochs = epochs or int(settings.get("total_epochs", 1))
        report_every = report_every or int(settings.get("report_every", 30))
        eval_during = bool(settings.get("eval_during", False))
        eval_every = int(settings.get("eval_every", 0) or 0)
        eval_start_epoch = int(settings.get("eval_start_epoch", 0) or 0)
        snapshot_epochs = set(settings.get("snapshot_epochs", []))
        debug_cfg = settings.get("debug", {}) or {}
        main = mesh.is_main()
        dump_debug = bool(debug_cfg.get("save")) and snapshot_dir and main
        eval_during = eval_during and main
        loader = IGRBatchLoader(train_records, self.cfgs, train=True,
                                seed=seed, ss_record=ss_record,
                                ss_img_root=ss_img_root,
                                ss_max_per_img=ss_max_per_img,
                                **(loader_kwargs or {}))
        if state is None:
            state = self.init_state(seed)
        history = []
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch)
            if ckpt_manager is not None or start_epoch:
                loader.reseed((seed + 1) * 1_000_003 + epoch)
            apply_cr = epoch >= 1 and self.loss_cfg.use_cr
            t0 = time.time()
            laps = _Laps()
            n_batches = 0
            running = 0.0
            pending_loss = None
            for batch in loader.prefetched_epoch(device_fn=self._train_batch):
                laps("load")
                state, metrics = self.train_step(state, batch, apply_cr)
                n_batches += 1
                if pending_loss is not None:
                    running += float(pending_loss)
                pending_loss = metrics["loss"]
                laps("step")
                if self.logger and n_batches > 1 \
                        and n_batches % report_every == 0:
                    self.logger.info(
                        f"epoch {epoch} batch {n_batches} "
                        f"loss {running / (n_batches - 1):.5f}")
                # 0-based batch index: the debug grids include each
                # period's batch 0; evaluation never runs on batch 0
                batch_idx = n_batches - 1
                if dump_debug and batch_idx % report_every == 0:
                    self._settle(laps)
                    self.debug_dump(
                        state, batch,
                        f"{snapshot_dir}/debug/e{epoch}_b{batch_idx}")
                    laps("debug")
                if (eval_during and valid_records and eval_every
                        and epoch >= eval_start_epoch and batch_idx
                        and batch_idx % eval_every == 0):
                    self._settle(laps)
                    self.evaluate(state, valid_records)
                    laps("eval")
            if pending_loss is not None:
                running += float(pending_loss)
            laps("step")
            dt = time.time() - t0
            history.append({"epoch": epoch,
                            "loss": running / max(n_batches, 1),
                            "seconds": dt, "split": laps.seconds})
            if self.logger:
                self.logger.info(
                    f"epoch {epoch} done: loss "
                    f"{history[-1]['loss']:.5f} ({dt:.1f}s)")
            if eval_during and valid_records:
                self.evaluate(state, valid_records)
            if snapshot_dir and (epoch + 1) in snapshot_epochs and main:
                self.save_snapshot(state,
                                   f"{snapshot_dir}/HC_epoch{epoch + 1}")
            if ckpt_manager is not None:
                ckpt_manager.save(epoch + 1, state)
            if eval_hook is not None:
                eval_hook(self, state, epoch)
        if ckpt_manager is not None:
            ckpt_manager.wait_until_finished()
        if settings.get("plot_loss") and snapshot_dir and history and main:
            self._plot_loss_curve(history, f"{snapshot_dir}/loss.png")
        return state, history

    def _settle(self, laps):
        """Wait for the steps in flight and charge the wait to ``step``, so
        a debug dump or an evaluation that follows is timed alone."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        laps("step")

    @staticmethod
    def _plot_loss_curve(history, path):
        """The loss curve as a PNG (needs matplotlib; raises without it)."""
        try:
            import matplotlib
        except ImportError as exc:
            raise RuntimeError(
                "training_settings.plot_loss needs matplotlib, which is not "
                "installed") from exc
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure()
        plt.plot([h["epoch"] for h in history],
                 [h["loss"] for h in history], "b-o")
        plt.xlabel("epoch")
        plt.ylabel("training loss")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
