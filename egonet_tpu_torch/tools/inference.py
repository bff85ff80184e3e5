"""Inference CLI of the PyTorch port: refine the orientation of externally
detected boxes (and/or ground-truth boxes) on a KITTI directory, write
KITTI txts under ``<dirs.output>/{gt_box_test,submission}/data/``, and
score the submission with the C++ evaluator (port of
``tools/inference.py``).

    python -m egonet_tpu_torch.tools.inference --cfg <yaml> \\
        [--visualize false] [--batch_to_show N]

On a host without PyYAML, call ``main(cfgs=<dict>)`` with a config dict
(``config.demo_config()`` plus the paths).  The model runs on CUDA unless
the config says ``device: cpu``.
"""

from __future__ import annotations

import copy
import os
import shutil
import subprocess
import time

import numpy as np

from egonet_tpu_torch import config as cfg_mod
from egonet_tpu_torch.data import kitti
from egonet_tpu_torch.io import kitti_writer
from egonet_tpu_torch.ops.affine import modify_bbox
from egonet_tpu_torch.utils.logger import get_logger


def filter_conf(record, thres=0.0):
    """Keep the detections with score >= thres."""
    annots = record["raw_txt_format"]
    indices = [i for i in range(len(annots))
               if annots[i].get("score", 1.0) >= thres]
    if not indices:
        return False, record
    filtered = {
        "bbox_2d": record["bbox_2d"][indices],
        "kpts_3d": record["kpts_3d"][indices],
        "raw_txt_format": [annots[i] for i in indices],
        "scores": [annots[i].get("score", 1.0) for i in indices],
        "K": record["K"],
    }
    return True, filtered


def gather_dict(request, references, thres=0.0, target_ar=1.0, enlarge=1.2):
    """The model's input dict from prepared detections (boxes enlarged by
    ``enlarge`` and aspect-fixed before cropping)."""
    ret = {"path": [], "boxes": [], "kpts_3d_before": [],
           "raw_txt_format": [], "scores": [], "K": []}
    for img_path in request["path"]:
        img_name = os.path.basename(img_path)
        if img_name not in references:
            print(f"Warning: {img_name} not included in detected images!")
            continue
        ok, ref = filter_conf(references[img_name], thres)
        if not ok:
            continue
        boxes = np.array([
            modify_bbox(b, target_ar=target_ar, enlarge=enlarge)["bbox"]
            for b in ref["bbox_2d"]])
        ret["path"].append(img_path)
        ret["boxes"].append(boxes)
        ret["kpts_3d_before"].append(ref["kpts_3d"])
        ret["raw_txt_format"].append(ref["raw_txt_format"])
        ret["scores"].append(ref["scores"])
        ret["K"].append(ref["K"])
    return ret


def make_output_dir(cfgs, name):
    save_dir = os.path.join(cfgs["dirs"]["output"], name, "data")
    os.makedirs(save_dir, exist_ok=True)
    return save_dir


def inference(dataset, model, results, cfgs, logger):
    """The inference loop, double-buffered: batch i is dispatched to the
    device before batch i-1 is finalized and written, so host prep and txt
    emission overlap device work."""
    alpha_mode = cfgs.get("testing_settings", {}).get("alpha_mode", "proj")
    batch_size = int(cfgs.get("testing_settings", {}).get("batch_size", 1))
    names = dataset.image_names
    enlarge = cfgs["dataset"].get("enlarge_factor", 1.2)
    width, height = cfgs["heatmapModel"]["input_size"]
    thres = cfgs.get("conf_thres", 0.0)
    visualize = cfgs.get("visualize", False)

    pending = []                       # [(handle, save_dir)] in flight

    def flush(limit: int):
        while len(pending) > limit:
            handle, save_dir = pending.pop(0)
            records = model.finalize(handle)
            model.post_process(records,
                               save_dict={"flag": True,
                                          "save_dir": save_dir},
                               visualize=visualize)

    for start in range(0, len(names), batch_size):
        chunk = names[start:start + batch_size]
        paths = [dataset.paths.image_path(n) for n in chunk]
        if cfgs.get("use_gt_box"):
            save_dir = make_output_dir(cfgs, "gt_box_test")
            annot = {"path": [], "boxes": [], "K": [], "raw_txt_format": [],
                     "kpts": [], "kpts_3d_gt": [], "pose_vecs_gt": []}
            for p, n in zip(paths, chunk):
                rec = dataset.annot_dict.get(n)
                if not rec or "bbox_2d" not in rec:
                    continue
                annot["path"].append(p)
                annot["boxes"].append(rec["bbox_2d"])
                annot["K"].append(rec["K"])
                annot["raw_txt_format"].append(rec["raw_txt_format"])
                annot["kpts"].append(rec.get("kpts"))
                annot["kpts_3d_gt"].append(rec.get("kpts_3d_gt"))
                annot["pose_vecs_gt"].append(rec.get("pose_vecs_gt"))
            if annot["path"]:
                # the GT path always computes alpha from the predicted
                # translation ('trans'); only the submission path reads
                # testing_settings.alpha_mode
                pending.append((model.dispatch_annot_dict(
                    annot, enlarge=1.1, alpha_mode="trans"), save_dir))
                flush(1)
        if cfgs.get("use_pred_box") and "pred" in results:
            annot = gather_dict({"path": paths}, results["pred"],
                                thres=thres, target_ar=height / width,
                                enlarge=enlarge)
            if annot["path"]:
                save_dir = make_output_dir(cfgs, "submission")
                # boxes are enlarged twice on this path: gather_dict by
                # enlarge_factor (1.2), then the crop by 1.1 again on the
                # aspect-fixed box
                pending.append((model.dispatch_annot_dict(
                    annot, enlarge=1.1, alpha_mode=alpha_mode), save_dir))
                flush(1)
        if start // batch_size >= cfgs.get("batch_to_show", 10 ** 9) - 1:
            break
    flush(0)


def main(argv=None, cfgs=None) -> dict:
    """Run the CLI from ``argv`` (``--cfg`` ...) or from a config dict.
    Returns {"image_store": the decoded-image store's stats, "transport":
    the facade's transport stats, "inference_s": seconds of the inference
    loop (decode, host prep, device, txt files), "evaluation": the
    evaluator's output or None}."""
    if cfgs is None:
        cfgs = cfg_mod.parse_args(argv)
    else:
        cfgs = copy.deepcopy(cfgs)
        cfgs.setdefault("visualize", False)
        cfgs.setdefault("batch_to_show", 1_000_000)
    if cfgs.get("visualize"):
        raise NotImplementedError("--visualize is not ported yet (queued)")
    logger, final_output_dir = get_logger(cfgs)
    if cfgs.get("config_path"):
        shutil.copyfile(cfgs["config_path"],
                        os.path.join(final_output_dir, "saved_config.yml"))

    split = cfgs["dataset"]["split"]
    dataset = kitti.get_dataset(cfgs, logger, split)
    results = {}
    if cfgs.get("use_pred_box"):
        results["pred"] = dataset.read_predictions(
            cfgs["dirs"]["load_prediction_file"])

    from egonet_tpu_torch.models.egonet import EgoNet
    model = EgoNet(cfgs, pre_trained=cfgs.get("pre_trained", True),
                   device=cfgs.get("device"))
    t0 = time.perf_counter()
    inference(dataset, model, results, cfgs, logger)
    summary = {"image_store": (dict(model.image_store.stats)
                               if model.image_store is not None else None),
               "transport": dict(model.transport_stats),
               "inference_s": time.perf_counter() - t0,
               "evaluation": None}

    output_dir = os.path.join(cfgs["dirs"]["output"], "submission")
    if split == "test":
        calib_dir = os.path.join(cfgs["dataset"]["root"], "testing", "calib")
        kitti_writer.generate_empty_files(output_dir, calib_dir)
        return summary
    if not os.path.isdir(output_dir):
        return summary
    from egonet_tpu_torch.eval.native import ensure_evaluator
    evaluator = ensure_evaluator()
    if evaluator is None:
        msg = ("not evaluated: the C++ evaluator could not be built (run "
               "`make -C tools/kitti-eval`), and the Python evaluator is not "
               "ported yet")
        logger.info(msg)
        print(msg)
        return summary
    label_dir = os.path.join(cfgs["dataset"]["root"], "training", "label_2")
    out = subprocess.check_output([evaluator, label_dir, output_dir]).decode()
    print(out)
    summary["evaluation"] = out
    return summary


if __name__ == "__main__":
    main()
