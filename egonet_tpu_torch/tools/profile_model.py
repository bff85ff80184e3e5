"""Profile the port's device program (``EgoNet._core``), or with
``--train`` one IGR train step, and print where the time goes: by kernel
category, by stage (``utils/profiling.SPANS``, or ``TRAIN_SPANS`` for the
train step), the top kernels and the device's idle gaps, each by what
the card waited for (port of ``tools/profile_model.py``).

    python -m egonet_tpu_torch.tools.profile_model [--cfg <yaml>] [--train]
        [--batch 384] [--iters 2] [--trace-dir DIR]

Three warm steps, then ``--iters`` traced steps.  Inference runs on
inputs already on the card (the root bench's inputs,
``tools/bench.build_core_inputs``), ``--batch`` crops.  ``--train`` runs
``IGRTrainer.train_step`` in bf16, as the JAX tool does, on a synthetic
batch of 24 frames of 384x1280 and MAX_INS_CNT (140) crops, the host
batch copied to the card inside each step (``h2d``).  The Chrome trace
stays in ``--trace-dir`` for Perfetto.  Without ``--cfg`` it runs the
shipped W48 config (``config.demo_config()``, or
``config.train_igrs_config()`` with ``--train``); without PyYAML call
``main(cfgs=...)``.  Any keypoint model the facade takes runs: a
'coordinates' head (the native and pedestrian configs too: a training
config, which holds no lifter, profiles its keypoint model inside the
demo's pipeline), its time charged to the ``backbone`` span, or
PoseResNet's 'heatmap' head, its maps charged to ``backbone`` and their
soft-argmax to ``readout``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None, cfgs=None, device=None) -> dict:
    """Returns ``utils/profiling.summarize_trace``'s dict."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--train", action="store_true",
                        help="profile one stage-2 (IGR) training step")
    parser.add_argument("--batch", type=int, default=384,
                        help="instance count (inference)")
    parser.add_argument("--trace-dir", default="egonet_profile")
    parser.add_argument("--iters", type=int, default=2)
    args = parser.parse_args(argv)

    from egonet_tpu_torch import config
    from egonet_tpu_torch.utils import profiling
    if cfgs is None:
        cfgs = (config.load_config(args.cfg) if args.cfg
                else config.train_igrs_config() if args.train
                else config.demo_config())
    if args.train:
        return _profile_train(cfgs, args, device)
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.tools.bench import build_core_inputs
    # a training config (KITTI_tpu_native.yml, KITTI_train_IGRs_Ped.yml)
    # holds no lifter: its keypoint model runs in the demo's pipeline
    cfgs = {**config.demo_config(), **cfgs}
    model = EgoNet(cfgs, pre_trained=False, device=device)
    dev_args = build_core_inputs(model, args.batch)

    def step():
        out = model._core(*dev_args, alpha_mode="proj")
        float(out[-1, -2])                    # waits for the device

    with torch.inference_mode():
        for _ in range(3):
            step()
        with profiling.trace(args.trace_dir, model.device):
            for _ in range(args.iters):
                step()
    summary = profiling.summarize_trace(args.trace_dir, iters=args.iters)
    print(summary["text"])
    print(f"trace: {args.trace_dir}/{profiling.TRACE_FILE}")
    return summary


def _train_batch(rng, images: int = 24, canvas_hw=(384, 1280)):
    """The JAX tool's synthetic IGR batch: random frames, MAX_INS_CNT crops
    at half scale, joints inside the crop, every slot real."""
    from egonet_tpu_torch.constants import MAX_INS_CNT
    m = MAX_INS_CNT
    batch = {
        "images": rng.randint(0, 255, (images, *canvas_hw, 3), np.uint8),
        "inv_mats": np.tile(np.array([[0.5, 0, 10], [0, 0.5, 10]],
                                     np.float32)[None], (m, 1, 1)),
        "img_idx": rng.randint(0, images, m).astype(np.int32),
        "joints": rng.uniform(5, 250, (m, 33, 3)).astype(np.float32),
        "mask": np.ones(m, np.float32),
        "sup_mask": np.ones(m, np.float32),
    }
    batch["joints"][..., 2] = 1.0
    return batch


def _profile_train(cfgs, args, device) -> dict:
    """Trace ``--iters`` IGR train steps (bf16, after 3 warm ones); the
    summary is charged to ``profiling.TRAIN_SPANS``."""
    from egonet_tpu_torch.train.igrs import IGRTrainer
    from egonet_tpu_torch.utils import profiling
    trainer = IGRTrainer(cfgs, dtype=torch.bfloat16, device=device)
    state = trainer.init_state(0)
    batch = _train_batch(np.random.RandomState(0))

    def step():
        _, metrics = trainer.train_step(state, batch, apply_cr=True)
        float(metrics["loss"])                # waits for the device

    for _ in range(3):
        step()
    with profiling.trace(args.trace_dir, trainer.device):
        for _ in range(args.iters):
            step()
    summary = profiling.summarize_trace(args.trace_dir, iters=args.iters,
                                        spans=profiling.TRAIN_SPANS)
    print(summary["text"])
    print(f"trace: {args.trace_dir}/{profiling.TRACE_FILE}")
    return summary


if __name__ == "__main__":
    main()
