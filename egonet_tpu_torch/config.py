"""Configuration: the shipped demo and training configs as Python dicts,
YAML loading and the entry points' command line.

A GPU host may lack PyYAML, so :func:`demo_config`,
:func:`train_lifting_config`, :func:`train_igrs_config`,
:func:`train_igrs_ped_config`, :func:`tpu_native_config` and
:func:`default_demo_config` need no YAML at all, and
:func:`read_yaml_file` (through :func:`load_config`) imports ``yaml`` only
when called (by :func:`parse_args`, when ``--cfg`` is read).  The dicts below equal
``yaml.safe_load`` of ``egonet_tpu/configs/KITTI_inference_demo.yml``,
``KITTI_train_lifting.yml``, ``KITTI_train_IGRs.yml``,
``KITTI_train_IGRs_Ped.yml`` and ``KITTI_tpu_native.yml`` (asserted by the
tests).
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


_TRAIN_DIRS = {"output": "./outputs/training_record",
               "debug": "./outputs/training_record/debug"}
_INTERP = {"flag": True, "style": "bbox12", "coef": [0.332, 0.667]}

_TRAIN_LIFTING = {
    "name": "lifter",
    "exp_type": "2dto3d",
    "model_type": "FCModel",
    "train": True,
    "save": True,
    "visualize": False,
    "evaluate": False,
    "dirs": _TRAIN_DIRS,
    "metrics": {"R3D": {"T_style": "direct", "R_style": "euler"}},
    "dataset": {
        "name": "KITTI",
        "detect_classes": ["Car"],
        "3d_kpt_sample_style": "bbox9",
        "interpolate": _INTERP,
        "pre-process": False,
        "root": "./data/KITTI",
        "lft_in_rep": "coordinates2d",
        "lft_out_rep": "R3d",
    },
    "cascade": {"num_stages": 1},
    "FCModel": {
        "name": "lifter",
        "refine_3d": False,
        "norm_twoD": False,
        "num_blocks": 2,
        "num_neurons": 1024,
        "dropout": 0.5,
        "leaky": False,
        "loss_type": "MSELoss1D",
        "loss_reduction": "mean",
    },
    "heatmapModel": {"num_joints": 33},
    "training_settings": {
        "total_epochs": 300,
        "eval_start_epoch": 250,
        "resume": False,
        "batch_size": 2048,
        "num_threads": 4,
        "shuffle": True,
        "pin_memory": False,
        "report_every": 500,
        "eval_every": 500,
        "eval_during": False,
        "lft_aug": True,
        "lft_aug_times": 100,
        "eval_metrics": ["RError3D"],
        "plot_loss": False,
    },
    "testing_settings": {"apply_dropout": False, "unnormalize": True,
                         "batch_size": 1024, "num_threads": 4,
                         "shuffle": False},
    "optimizer": {"optim_type": "adam", "lr": 0.001, "weight_decay": 0.0,
                  "momentum": 0.9, "milestones": [50, 100, 150, 250],
                  "gamma": 0.5},
}

_TRAIN_IGRS = {
    "name": "kitti_kpt_loc",
    "exp_type": "instanceto2d",
    "model_type": "heatmapModel",
    "train": True,
    "save": True,
    "visualize": False,
    "evaluate": False,
    "dirs": _TRAIN_DIRS,
    "dataset": {
        "name": "KITTI",
        "detect_classes": ["Car"],
        "3d_kpt_sample_style": "bbox9",
        "interpolate": _INTERP,
        "pre-process": False,
        "root": "./data/KITTI",
        "scaling_factor": 0.2,
        "rotation_factor": 30.0,
        "pth_transform": {"mean": [0.485, 0.456, 0.406],
                          "std": [0.229, 0.224, 0.225]},
        "2d_kpt_style": "bbox9",
    },
    "ss": {"flag": False, "record_path": "", "img_root": "",
           "max_per_img": 6},
    "heatmapModel": {
        "name": "hrnet",
        "add_xy": False,
        "jitter_bbox": True,
        "jitter_params": {"shift": [0.1, 0.1], "scaling": [0.4, 0.4]},
        "input_size": [256, 256],
        "augment_input": True,
        "head_type": "coordinates",
        "pixel_shuffle": False,
        "heatmap_size": [64, 64],
        "loss_type": "JointsCompositeLoss",
        "loss_spec_list": ["mse", "l1", "sl1"],
        "loss_weight_list": [1.0, 0.1, "None"],
        "cr_loss_threshold": 0.15,
        "init_weights": True,
        "num_joints": 33,
        "pretrained": "./resources/start_point.pth",
        "target_type": "gaussian",
        "sigma": 1,
        "extra": _DEMO["heatmapModel"]["extra"],
    },
    "training_settings": {
        "total_epochs": 45,
        "resume": False,
        "batch_size": 24,
        "num_threads": 16,
        "shuffle": True,
        "pin_memory": False,
        "use_target_weight": False,
        "report_every": 30,
        "eval_every": 130,
        "eval_during": False,
        "eval_metrics": ["JointDistance2DSIP"],
        "plot_loss": False,
        "snapshot_epochs": [],
        "debug": {"save": True, "save_images_kpts": True,
                  "save_hms_gt": True, "save_hms_pred": True},
    },
    "testing_settings": {"batch_size": 2, "num_threads": 4,
                         "shuffle": False, "pin_memory": False,
                         "apply_dropout": False, "unnormalize": False,
                         "eval_metrics": ["JointDistance2DSIP"]},
    "optimizer": {"optim_type": "adam", "lr": 0.001, "weight_decay": 0.0,
                  "momentum": 0.9, "milestones": [10, 20, 30, 40],
                  "gamma": 0.5},
}


def _stage(n_modules, n_branches, widths):
    return {"num_modules": n_modules, "num_branches": n_branches,
            "block": "basic", "num_blocks": [4] * n_branches,
            "num_channels": list(widths), "fuse_method": "sum"}


# KITTI_train_IGRs_Ped.yml: the W32 pedestrian model (192x192 crops, 48x48
# heatmaps, widths 32/64/128/256, stem to stage2 frozen)
_TRAIN_IGRS_PED = copy.deepcopy(_TRAIN_IGRS)
_TRAIN_IGRS_PED.update({
    "name": "kitti_kpt_loc_pedestrian",
    "dirs": {"output": "./outputs/training_record_ped",
             "debug": "./outputs/training_record_ped/debug"}})
_TRAIN_IGRS_PED["dataset"].update({"detect_classes": ["Pedestrian"],
                                   "enlarge_factor": 1.05,
                                   "pre-process": True})
_TRAIN_IGRS_PED["heatmapModel"].update({
    "jitter_params": {"shift": [0.1, 0.1], "scaling": [0.2, 0.2]},
    "input_size": [192, 192],
    "heatmap_size": [48, 48],
    "loss_spec_list": ["mse", "l1", "None"],
    "loss_weight_list": [1.0, 0.1, 0.0],
    "cr_loss_threshold": 0.1,
    "use_different_joints_weight": False,
    "pretrained": "./resources/start_point_w32.pth",
    "sigma": 2,
    "extra": {
        "pretrained_layers": _DEMO["heatmapModel"]["extra"][
            "pretrained_layers"],
        "freeze_layers": ["conv1", "bn1", "conv2", "bn2", "layer1",
                          "transition1", "stage2"],
        "final_conv_kernel": 1,
        "stage2": _stage(1, 2, (32, 64)),
        "stage3": _stage(4, 3, (32, 64, 128)),
        "stage4": _stage(3, 4, (32, 64, 128, 256))}})
_TRAIN_IGRS_PED["training_settings"].update({
    "total_epochs": 40, "begin_epoch": 1, "end_epoch": 10,
    "snapshot_epochs": [20, 30, 40], "batch_size": 2, "num_threads": 0,
    "report_every": 100, "eval_every": 1000, "eval_during": True})
_TRAIN_IGRS_PED["testing_settings"].update({"num_threads": 0,
                                           "save_debug": False})
_TRAIN_IGRS_PED["optimizer"]["milestones"] = [10, 20, 30]

# KITTI_tpu_native.yml: PoseNetTPU (stride-8 grid, depths 1/3/9, widths
# 256/512/1024, expansion 2/3/4, head 128) with the W48 recipe
_TPU_NATIVE = copy.deepcopy(_TRAIN_IGRS)
_TPU_NATIVE.update({
    "name": "kitti_kpt_loc_tpu_native",
    "dirs": {"output": "./outputs/tpu_native_record",
             "debug": "./outputs/tpu_native_record/debug"}})
_TPU_NATIVE["heatmapModel"].update({
    "name": "tpu_native", "pretrained": "",
    "extra": {"grid_stride": 8, "depths": [1, 3, 9],
              "widths": [256, 512, 1024], "expansion": [2, 3, 4],
              "head_width": 128}})
_TPU_NATIVE["training_settings"]["debug"] = {
    "save": False, "save_images_kpts": True, "save_hms_gt": True,
    "save_hms_pred": True}


def demo_config() -> dict:
    """The shipped W48 inference configuration, as a fresh dict."""
    return copy.deepcopy(_DEMO)


def train_lifting_config() -> dict:
    """The shipped lifter training configuration, as a fresh dict."""
    return copy.deepcopy(_TRAIN_LIFTING)


def train_igrs_config() -> dict:
    """The shipped HRNet-W48 IGR training configuration, as a fresh
    dict."""
    return copy.deepcopy(_TRAIN_IGRS)


def train_igrs_ped_config() -> dict:
    """The shipped HRNet-W32 pedestrian IGR training configuration
    (``KITTI_train_IGRs_Ped.yml``), as a fresh dict."""
    return copy.deepcopy(_TRAIN_IGRS_PED)


def tpu_native_config() -> dict:
    """The shipped PoseNetTPU IGR training configuration
    (``KITTI_tpu_native.yml``), as a fresh dict."""
    return copy.deepcopy(_TPU_NATIVE)


def native_demo_config() -> dict:
    """The demo inference configuration with the PoseNetTPU backbone at
    its defaults (``heatmapModel.name: tpu_native``, ``extra: {}``): the
    native half of the root bench."""
    cfg = demo_config()
    cfg["heatmapModel"]["name"] = "tpu_native"
    cfg["heatmapModel"]["extra"] = {}
    return cfg


# keys every loaded config has (the JAX package's ``config._DEFAULTS``)
_DEFAULTS = {
    "visualize": False,
    "batch_to_show": 1_000_000,
    "use_gpu": False,          # unused; kept for the reference's YAML
}


def read_yaml_file(path: str) -> dict:
    """``yaml.safe_load`` of the file at ``path`` (needs PyYAML)."""
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


def load_config(path: str, overrides: dict | None = None) -> dict:
    """Read a reference-schema YAML config (:func:`read_yaml_file`), fill
    the keys of ``_DEFAULTS`` it lacks, and lay ``overrides`` over it
    (:func:`merge_config`)."""
    cfgs = read_yaml_file(path)
    cfgs["config_path"] = path
    for key, val in _DEFAULTS.items():
        cfgs.setdefault(key, val)
    if overrides:
        cfgs = merge_config(cfgs, overrides)
    return cfgs


def default_demo_config() -> dict:
    """The shipped inference configuration as :func:`load_config` returns
    it from ``KITTI_inference_demo.yml`` (:func:`demo_config` with the keys
    of ``_DEFAULTS``), without YAML or a file: so it has no
    ``config_path``, which the inference CLI would copy into its output
    directory."""
    cfgs = demo_config()
    for key, val in _DEFAULTS.items():
        cfgs.setdefault(key, val)
    return cfgs


def merge_config(base: dict, overrides: dict) -> dict:
    """A deep copy of ``base`` with ``overrides`` laid over it: nested
    dicts merge key by key, any other value replaces."""
    out = copy.deepcopy(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


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
