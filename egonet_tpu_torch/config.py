"""Configuration: the shipped demo config as a Python dict, YAML loading
and the entry points' command line.

A GPU host may lack PyYAML, so :func:`demo_config` needs no
YAML at all and :func:`load_config` imports ``yaml`` only when called (by
:func:`parse_args`, when ``--cfg`` is read).  The dict below equals
``yaml.safe_load`` of ``egonet_tpu/configs/KITTI_inference_demo.yml``
(asserted by the tests).
"""

from __future__ import annotations

import argparse
import copy

import torch

_DEMO = {
    "name": "kitti_car_inference",
    "exp_type": "inference",
    "model_type": "heatmapModel",
    "use_pred_box": True,
    "use_gt_box": True,
    "train": False,
    "save": False,
    "evaluate": False,
    "inference": True,
    "dirs": {
        "output": "./outputs/inference",
        "ckpt": "./checkpoints",
        "load_prediction_file": "./resources/D4LCN/data",
    },
    "dataset": {
        "name": "KITTI",
        "split": "valid",
        "detect_classes": ["Car"],
        "3d_kpt_sample_style": "bbox9",
        "interpolate": {"flag": True, "style": "bbox12",
                        "coef": [0.332, 0.667]},
        "pre-process": False,
        "root": "./data/KITTI",
        "scaling_factor": 0.2,
        "rotation_factor": 30.0,
        "pth_transform": {"mean": [0.485, 0.456, 0.406],
                          "std": [0.229, 0.224, 0.225]},
        "2d_kpt_style": "bbox9",
        "lft_in_rep": "coordinates2d",
        "lft_out_rep": "R3d+T",
    },
    "FCModel": {
        "name": "lifter",
        "refine_3d": False,
        "norm_twoD": False,
        "num_blocks": 2,
        "input_size": 66,
        "output_size": 96,
        "num_neurons": 1024,
        "dropout": 0.5,
        "leaky": False,
    },
    "heatmapModel": {
        "name": "hrnet",
        "add_xy": False,
        "jitter_bbox": False,
        "jitter_params": {"shift": [0.1, 0.1], "scaling": [0.4, 0.4]},
        "input_size": [256, 256],
        "augment_input": False,
        "head_type": "coordinates",
        "pixel_shuffle": False,
        "heatmap_size": [64, 64],
        "init_weights": True,
        "num_joints": 33,
        "extra": {
            "pretrained_layers": ["conv1", "bn1", "conv2", "bn2", "layer1",
                                  "transition1", "stage2", "transition2",
                                  "stage3", "transition3", "stage4"],
            "final_conv_kernel": 1,
            "stage2": {"num_modules": 1, "num_branches": 2,
                       "block": "basic", "num_blocks": [4, 4],
                       "num_channels": [48, 96], "fuse_method": "sum"},
            "stage3": {"num_modules": 4, "num_branches": 3,
                       "block": "basic", "num_blocks": [4, 4, 4],
                       "num_channels": [48, 96, 192], "fuse_method": "sum"},
            "stage4": {"num_modules": 3, "num_branches": 4,
                       "block": "basic", "num_blocks": [4, 4, 4, 4],
                       "num_channels": [48, 96, 192, 384],
                       "fuse_method": "sum"},
        },
    },
    "testing_settings": {
        "batch_size": 1,
        "num_threads": 0,
        "shuffle": True,
        "pin_memory": False,
        "apply_dropout": False,
        "unnormalize": False,
        "alpha_mode": "proj",
    },
}


def demo_config() -> dict:
    """The shipped W48 inference configuration, as a fresh dict."""
    return copy.deepcopy(_DEMO)


def load_config(path: str) -> dict:
    """Read a reference-schema YAML config (needs PyYAML)."""
    import yaml
    with open(path, "r") as f:
        cfgs = yaml.safe_load(f)
    cfgs["config_path"] = path
    return cfgs


def str2bool(value) -> bool:
    """Boolean command-line values: the usual spellings, anything else
    raises (``type=bool`` would make ``--visualize False`` true)."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("1", "true", "t", "yes", "y", "on"):
        return True
    if v in ("0", "false", "f", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def parse_args(argv=None) -> dict:
    """``--cfg <yaml>`` (required), ``--visualize`` and ``--batch_to_show``,
    as the JAX package's entry points take them -> the config dict."""
    parser = argparse.ArgumentParser(description="egonet_tpu_torch entry point")
    parser.add_argument("--cfg", type=str, required=True,
                        help="experiment configuration file path")
    parser.add_argument("--visualize", default=False, type=str2bool,
                        nargs="?", const=True)
    parser.add_argument("--batch_to_show", default=1_000_000, type=int)
    args, _unknown = parser.parse_known_args(argv)
    cfgs = load_config(args.cfg)
    cfgs["visualize"] = args.visualize
    cfgs["batch_to_show"] = args.batch_to_show
    return cfgs


def config_dtype(cfgs: dict | None) -> torch.dtype:
    """The compute dtype a config asks for: bf16 unless ``bf16: false``
    (the same default the JAX entry points read)."""
    return torch.bfloat16 if (cfgs or {}).get("bf16", True) else torch.float32
