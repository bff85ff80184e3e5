"""Stage-2 training CLI of the PyTorch port: the HRNet keypoint (IGR)
model -> ``HC.pth`` (port of ``tools/train_igrs.py``).

    python -m egonet_tpu_torch.tools.train_igrs --cfg <yaml>

On a host without PyYAML, call ``main(cfgs=<dict>)`` (e.g.
``config.train_igrs_config()`` plus ``dataset.root`` and ``dirs``).
Trains on CUDA unless the config says ``device: cpu``, in fp32 (TF32 off)
unless it says ``bf16: true`` (the JAX CLI's default; the inference
config's default is bf16).  Starts from ``training_settings.resume`` (a
``.pth``) where it exists, else from ``heatmapModel.pretrained`` filtered
by ``extra.pretrained_layers``, else from the seeded initialization;
prints the model summary; fits; writes ``HC.pth`` (and snapshots, debug
grids) under ``<dirs.output>/<dataset name>/checkpoints/``.  Exact resume
(``training_settings.exact_resume``) is not ported yet and raises.
"""

from __future__ import annotations

import copy
import os

import torch

from egonet_tpu_torch import config as cfg_mod
from egonet_tpu_torch.data import kitti as libkitti
from egonet_tpu_torch.utils.logger import get_logger


def main(argv=None, cfgs=None) -> dict:
    """Returns {"ckpt_dir", "history", "params", "flops"}."""
    cfgs = cfg_mod.parse_args(argv) if cfgs is None else copy.deepcopy(cfgs)
    settings = cfgs["training_settings"]
    if settings.get("exact_resume"):
        raise NotImplementedError(
            "training_settings.exact_resume (full-state resume, "
            "io/orbax_ckpt.py) is not ported yet (ROADMAP queue 1)")
    from egonet_tpu_torch.device import resolve_device
    device = resolve_device(cfgs.get("device"))
    logger, out_dir = get_logger(cfgs)

    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.io.weights import load_torch_state_dict
    from egonet_tpu_torch.models.init import numpy_init
    from egonet_tpu_torch.train.igrs import IGRTrainer
    from egonet_tpu_torch.utils.summary import model_summary, \
        per_layer_summary

    train_set = libkitti.KITTIDataset(cfgs, "train", logger)
    valid_set = libkitti.KITTIDataset(cfgs, "valid", logger)
    batch = int(settings["batch_size"])
    loader_steps = max(1, -(-len(train_set.records) // batch))
    dtype = torch.bfloat16 if cfgs.get("bf16", False) else torch.float32
    trainer = IGRTrainer(cfgs, dtype=dtype, steps_per_epoch=loader_steps,
                         logger=logger, device=device)

    variables = None
    resume_path = settings.get("resume")
    if resume_path and isinstance(resume_path, str) \
            and os.path.exists(resume_path):
        if resume_path.endswith(".msgpack"):
            raise NotImplementedError(
                "flax .msgpack checkpoints are not read by the port "
                "(ROADMAP queue 1); resume from a .pth")
        logger.info(f"resuming from {resume_path}")
        variables = load_torch_state_dict(resume_path)
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
    state, history = trainer.fit(
        train_set.records, valid_set.records, state=state,
        snapshot_dir=ckpt_out,
        ss_record=getattr(train_set, "ss_record", None),
        ss_img_root=getattr(train_set, "ss_img_root", ""),
        ss_max_per_img=getattr(train_set, "ss_max_per_img", 6))
    logger.info(f"training done: {history[-1] if history else 'no steps'}")
    checkpoint.save_torch_state_dict(os.path.join(ckpt_out, "HC.pth"),
                                     state.model)
    logger.info(f"saved HC.pth under {ckpt_out}")
    return {"ckpt_dir": ckpt_out, "history": history,
            "params": summary["params"], "flops": summary["flops"]}


if __name__ == "__main__":
    main()
