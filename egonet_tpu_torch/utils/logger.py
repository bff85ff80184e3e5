"""File + console logger and output directory (copy of ``get_logger`` from
``egonet_tpu/utils/logger.py``): output directory ``<dirs.output>/<dataset
name>/``, log file ``<name>_<timestamp>.log``."""

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
