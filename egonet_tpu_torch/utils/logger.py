"""File + console logger and output directory (copy of
``egonet_tpu/utils/logger.py``): output directory ``<dirs.output>/<dataset
name>/``, log file ``<name>_<timestamp>.log``; ``AverageMeter``."""

from __future__ import annotations

import logging
import os
import time


def get_logger(cfgs: dict):
    """Returns (logger, final_output_dir)."""
    output_dir = cfgs["dirs"]["output"]
    dataset = cfgs.get("dataset", {}).get("name", "run")
    final_output_dir = os.path.join(output_dir, dataset)
    os.makedirs(final_output_dir, exist_ok=True)

    timestamp = time.strftime("%Y-%m-%d-%H-%M")
    name = cfgs.get("name", "experiment").replace(" ", "_")[:60]
    log_file = os.path.join(final_output_dir, f"{name}_{timestamp}.log")

    logger = logging.getLogger(f"egonet_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    logger.propagate = False
    return logger, final_output_dir


class AverageMeter:
    """Running average of a value seen ``n`` at a time (the reference's
    libs/common/utils.py:149-183)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0
