"""Stage-2 training CLI of the PyTorch port: the HRNet keypoint (IGR)
model -> ``HC.pth`` and ``HC.msgpack`` (port of ``tools/train_igrs.py``).

    python -m egonet_tpu_torch.tools.train_igrs --cfg <yaml>
    torchrun --nproc_per_node=N -m egonet_tpu_torch.tools.train_igrs --cfg <yaml>

On a host without PyYAML, call ``main(cfgs=<dict>)`` (e.g.
``config.train_igrs_config()`` plus ``dataset.root`` and ``dirs``).
Trains on CUDA unless the config says ``device: cpu``, in fp32 (TF32 off)
unless it says ``bf16: true`` (the JAX CLI's default; the inference
config's default is bf16).  Starts from ``training_settings.resume`` (a
``.pth``, or a flax ``.msgpack`` such as the JAX CLI's ``HC.msgpack``)
where it exists, else from ``heatmapModel.pretrained`` filtered by
``extra.pretrained_layers``, else from the seeded initialization; prints
the model summary; fits; writes ``HC.pth`` and ``HC.msgpack`` (and
snapshots, debug grids) under ``<dirs.output>/<dataset
name>/checkpoints/``.

Under torchrun (``WORLD_SIZE`` > 1) every rank joins the process group
(``parallel/mesh.init_from_env``: rank ``LOCAL_RANK`` on card
``LOCAL_RANK``, nccl; gloo with ``device: cpu``) and the step is data
parallel; rank 0 logs and writes the files.  ``training_settings.
exact_resume`` (true: ``<checkpoints>/orbax``, the JAX CLI's directory
name; a string: that directory) keeps the full train state after every
epoch (``io/train_ckpt.py``) and, when the directory holds a step, resumes
from the latest one at its epoch; the run is then made under
``device.deterministic`` (deterministic algorithms, cuBLAS's fixed
workspace), without which a resumed run on the card is not bit-equal to
an uninterrupted one.
"""

from __future__ import annotations

import copy
import os

import torch

from egonet_tpu_torch import config as cfg_mod
from egonet_tpu_torch.data import kitti as libkitti
from egonet_tpu_torch.device import deterministic
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.utils.logger import get_logger


def start_device(cfgs: dict):
    """The run's device: under torchrun (``WORLD_SIZE`` > 1) this rank's,
    after joining the process group; else the config's (CUDA unless
    ``device: cpu``)."""
    from egonet_tpu_torch.device import resolve_device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return mesh.init_from_env(device=cfgs.get("device"))
    return resolve_device(cfgs.get("device"))


def exact_resume(settings: dict, ckpt_dir: str, state, logger):
    """(manager, state, start epoch) of ``training_settings.exact_resume``:
    (None, state, 0) when it is off; else a ``TrainCheckpointManager`` on
    its directory (true: ``<ckpt_dir>/orbax``) and, when that holds a
    step, ``state`` restored from the latest one and that step."""
    exact_dir = settings.get("exact_resume")
    if not exact_dir:
        return None, state, 0
    from egonet_tpu_torch.io.train_ckpt import TrainCheckpointManager
    if not isinstance(exact_dir, str):
        exact_dir = os.path.join(ckpt_dir, "orbax")
    manager = TrainCheckpointManager(exact_dir)
    latest = manager.latest_step()
    if latest is None:
        return manager, state, 0
    logger.info(f"exact resume from {exact_dir} @ epoch {latest}")
    return manager, manager.restore(state, step=latest), int(latest)


def main(argv=None, cfgs=None) -> dict:
    """Returns {"ckpt_dir", "history", "params", "flops", "checkpoints":
    the full-state saves' timings and sizes (``exact_resume``)}."""
    cfgs = cfg_mod.parse_args(argv) if cfgs is None else copy.deepcopy(cfgs)
    with deterministic(bool(cfgs["training_settings"].get("exact_resume"))):
        return _train(cfgs)


def _train(cfgs: dict) -> dict:
    settings = cfgs["training_settings"]
    device = start_device(cfgs)
    logger, out_dir = get_logger(cfgs)

    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.io.weights import (from_jax_variables,
                                            load_torch_state_dict)
    from egonet_tpu_torch.models.init import numpy_init
    from egonet_tpu_torch.train.igrs import IGRTrainer
    from egonet_tpu_torch.utils.summary import model_summary, \
        per_layer_summary

    train_set = libkitti.KITTIDataset(cfgs, "train", logger)
    valid_set = libkitti.KITTIDataset(cfgs, "valid", logger)
    batch = int(settings["batch_size"])
    # steps an epoch from this node's record shard (data/loader.host_shard)
    per_node = -(-len(train_set.records) // mesh.node()[1])
    loader_steps = max(1, -(-per_node // batch))
    dtype = torch.bfloat16 if cfgs.get("bf16", False) else torch.float32
    trainer = IGRTrainer(cfgs, dtype=dtype, steps_per_epoch=loader_steps,
                         logger=logger, device=device)

    variables = None
    resume_path = settings.get("resume")
    if resume_path and isinstance(resume_path, str) \
            and os.path.exists(resume_path):
        logger.info(f"resuming from {resume_path}")
        variables = (from_jax_variables(checkpoint.load_variables(
            resume_path)) if resume_path.endswith(".msgpack")
            else load_torch_state_dict(resume_path))
    if variables is None:
        variables = checkpoint.warm_start_variables(
            cfgs, numpy_init(trainer.model, 0), logger=logger)

    w, h = cfgs["heatmapModel"]["input_size"]
    in_ch = 5 if cfgs["heatmapModel"].get("add_xy") else 3
    sample = torch.zeros((1, in_ch, h, w), device=device)
    trainer.model.to(device).eval()
    summary = model_summary(trainer.model, sample)
    logger.info(summary["text"])
    if settings.get("verbose_summary"):
        logger.info("\n" + per_layer_summary(trainer.model, sample))

    state = trainer.init_state(0, variables=variables)
    ckpt_out = os.path.join(out_dir, "checkpoints")
    os.makedirs(ckpt_out, exist_ok=True)
    manager, state, start_epoch = exact_resume(settings, ckpt_out, state,
                                               logger)
    try:
        state, history = trainer.fit(
            train_set.records, valid_set.records, state=state,
            snapshot_dir=ckpt_out,
            ss_record=getattr(train_set, "ss_record", None),
            ss_img_root=getattr(train_set, "ss_img_root", ""),
            ss_max_per_img=getattr(train_set, "ss_max_per_img", 6),
            ckpt_manager=manager, start_epoch=start_epoch)
    finally:
        if manager is not None:
            manager.close()
    logger.info(f"training done: {history[-1] if history else 'no steps'}")
    if mesh.is_main():
        checkpoint.save_variables(os.path.join(ckpt_out, "HC.msgpack"),
                                  state.model)
        checkpoint.save_torch_state_dict(os.path.join(ckpt_out, "HC.pth"),
                                         state.model)
        logger.info(f"saved HC.pth/HC.msgpack under {ckpt_out}")
    return {"ckpt_dir": ckpt_out, "history": history,
            "params": summary["params"], "flops": summary["flops"],
            "checkpoints": manager.saves if manager is not None else []}


if __name__ == "__main__":
    main()
