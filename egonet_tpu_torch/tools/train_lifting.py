"""Stage-1 training CLI of the PyTorch port: the FC lifter -> ``L.pth``,
``L.msgpack`` (flax's) and ``LS.npy`` (port of ``tools/train_lifting.py``).

    python -m egonet_tpu_torch.tools.train_lifting --cfg <yaml>
    torchrun --nproc_per_node=N -m egonet_tpu_torch.tools.train_lifting --cfg <yaml>

On a host without PyYAML, call ``main(cfgs=<dict>)`` (e.g.
``config.train_lifting_config()`` plus ``dataset.root`` and ``dirs``).
Trains on CUDA unless the config says ``device: cpu``.  The files go to
``<dirs.output>/<dataset name>/checkpoints/``.  Under torchrun the step
is data parallel, and ``training_settings.exact_resume`` resumes exactly,
under deterministic algorithms, as in ``tools/train_igrs.py``.
"""

from __future__ import annotations

import copy
import os

from egonet_tpu_torch import config as cfg_mod
from egonet_tpu_torch.data import kitti as libkitti
from egonet_tpu_torch.device import deterministic
from egonet_tpu_torch.parallel import mesh
from egonet_tpu_torch.tools.train_igrs import exact_resume, start_device
from egonet_tpu_torch.utils.logger import get_logger


def main(argv=None, cfgs=None) -> dict:
    """Returns {"ckpt_dir", "history", "train_pairs", "valid_pairs"}."""
    cfgs = cfg_mod.parse_args(argv) if cfgs is None else copy.deepcopy(cfgs)
    with deterministic(bool(cfgs["training_settings"].get("exact_resume"))):
        return _train(cfgs)


def _train(cfgs: dict) -> dict:
    device = start_device(cfgs)
    logger, out_dir = get_logger(cfgs)

    from egonet_tpu_torch.io import checkpoint
    from egonet_tpu_torch.train.lifting import LiftingTrainer

    train_set, valid_set = libkitti.prepare_data(cfgs, logger)
    logger.info(f"lifting pairs: train {len(train_set.input)}, "
                f"valid {len(valid_set.input)}")
    # lifter sizes from the representation where the config leaves them
    cfgs["FCModel"].setdefault("input_size", int(train_set.input.shape[1]))
    cfgs["FCModel"].setdefault("output_size", int(train_set.output.shape[1]))

    batch = int(cfgs["training_settings"].get("batch_size", 2048))
    per_node = -(-len(train_set.input) // mesh.node()[1])
    steps = max(1, per_node // batch)
    trainer = LiftingTrainer(cfgs, steps_per_epoch=steps, logger=logger,
                             device=device)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    manager, state, start_epoch = exact_resume(
        cfgs["training_settings"], ckpt_dir, trainer.init_state(0), logger)
    try:
        state, history = trainer.fit(train_set, valid_set, state=state,
                                     ckpt_manager=manager,
                                     start_epoch=start_epoch)
    finally:
        if manager is not None:
            manager.close()
    if not mesh.is_main():
        return {"ckpt_dir": ckpt_dir, "history": history,
                "train_pairs": len(train_set.input),
                "valid_pairs": len(valid_set.input)}
    if cfgs.get("evaluate") or cfgs.get("visualize"):
        trainer.evaluate(
            state, valid_set,
            visualize_dir=out_dir if cfgs.get("visualize") else None)

    checkpoint.save_variables(os.path.join(ckpt_dir, "L.msgpack"),
                              state.model)
    checkpoint.save_torch_state_dict(os.path.join(ckpt_dir, "L.pth"),
                                     state.model)
    checkpoint.save_lifter_stats(os.path.join(ckpt_dir, "LS.npy"),
                                 train_set.statistics)
    logger.info(f"saved L.pth/L.msgpack/LS.npy under {ckpt_dir}")
    return {"ckpt_dir": ckpt_dir, "history": history,
            "train_pairs": len(train_set.input),
            "valid_pairs": len(valid_set.input)}


if __name__ == "__main__":
    main()
