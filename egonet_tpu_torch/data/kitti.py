"""KITTI dataset layer (port of ``egonet_tpu/data/kitti.py``): label and
calibration parsing, the projection of labeled cuboids to screen
keypoints, the directory layout, the per-image annotation records the
inference CLI reads (ground-truth boxes and external-detector
predictions), and the training data: per-image keypoint records for the
IGR model ('instanceto2d'), in-RAM normalized (input, output) pairs for
the lifter ('2dto3d') and finetuning records ('finetune').

Image sizes come from the PNG header (:func:`png.image_size`), so no image
library is needed.
"""

from __future__ import annotations

import csv
import os
from os.path import join as pjoin

import numpy as np

from egonet_tpu_torch.constants import (DEFAULT_INTERP_COEF, FIELDNAMES,
                                        FIELDNAMES_P, TYPE_ID_CONVERSION)
from egonet_tpu_torch.data import cuboid, png
from egonet_tpu_torch.ops import affine


# ---------------------------------------------------------------------------
# label / calibration parsing
# ---------------------------------------------------------------------------

def read_label_file(path: str, classes, fieldnames=FIELDNAMES) -> list:
    """Parse one KITTI label txt -> list of per-instance dicts."""
    annotations = []
    with open(path, "r") as f:
        reader = csv.DictReader(f, delimiter=" ", fieldnames=fieldnames)
        for row in reader:
            if row["type"] not in classes:
                continue
            d = {
                "class": row["type"],
                "label": TYPE_ID_CONVERSION[row["type"]],
                "truncation": float(row["truncated"]),
                "occlusion": float(row["occluded"]),
                "alpha": float(row["alpha"]),
                "dimensions": [float(row["dl"]), float(row["dh"]),
                               float(row["dw"])],   # (l, h, w)
                "locations": [float(row["lx"]), float(row["ly"]),
                              float(row["lz"])],
                "rot_y": float(row["ry"]),
                "bbox": [float(row["xmin"]), float(row["ymin"]),
                         float(row["xmax"]), float(row["ymax"])],
            }
            if "score" in fieldnames and row.get("score") is not None:
                d["score"] = float(row["score"])
            annotations.append(d)
    return annotations


def read_calib_file(path: str) -> np.ndarray:
    """The P2 projection matrix [3, 4] of a KITTI calib txt."""
    with open(path, "r") as f:
        for row in csv.reader(f, delimiter=" "):
            if row and row[0] == "P2:":
                vals = [float(v) for v in row[1:] if v != ""]
                return np.array(vals, dtype=np.float32).reshape(3, 4)
    raise ValueError(f"no P2 entry in {path}")


def decompose_projection(P: np.ndarray):
    """P = K [I | K^-1 t]: returns (K [3,3], shift [3,1])."""
    K = P[:, :3]
    shift = np.linalg.inv(K) @ P[:, 3].reshape(3, 1)
    return K, shift


STD_ROT = np.array([15.0, 50.0, 15.0]) * np.pi / 180.0
STD_TRANS = np.array([0.2, 0.01, 0.2])


def augment_pose_vector(locs, rot_y, obj_class, dimension,
                        augment: bool, augment_times: int,
                        rng: np.random.RandomState | None = None):
    """The original pose plus ``augment_times`` perturbed 6DoF poses."""
    rng = rng or np.random
    aug_ids = [(obj_class, dimension)]
    pose = np.concatenate([np.asarray(locs, dtype=np.float64),
                           np.array([0.0, float(rot_y), 0.0])]).reshape(1, 6)
    aug_pose_vecs = [pose]
    if not augment:
        return aug_ids, aug_pose_vecs
    rots = rng.randn(augment_times, 3) * STD_ROT.reshape(1, 3)
    rots[:, 1] += float(rot_y)
    trans = 1 + rng.randn(augment_times, 3) * STD_TRANS.reshape(1, 3)
    trans *= np.asarray(locs).reshape(1, 3)
    for i in range(augment_times):
        aug_ids.append((obj_class, dimension))
        aug_pose_vecs.append(
            np.concatenate([trans[i], rots[i]]).reshape(1, 6))
    return aug_ids, aug_pose_vecs


def get_2d_3d_pairs(label_path: str,
                    calib_path: str,
                    classes=("Car",),
                    img_size=(1242, 375),
                    interp_coef=DEFAULT_INTERP_COEF,
                    augment: bool = False,
                    augment_times: int = 1,
                    random_yaw: bool = False,
                    filter_outlier: bool = True,
                    visibility_threshold: float = 0.3,
                    fieldnames=FIELDNAMES,
                    rng: np.random.RandomState | None = None) -> dict:
    """Project every labeled cuboid to screen coordinates.

    Returns lists (one entry per surviving instance): kpts_2d [33, 3]
    (u, v, visibility), kpts_3d [33, 3] camera coords, pose_vecs [1, 6],
    ids (class, dims), bboxes [1, 4], rotations [1, 2] (alpha, ry), raw
    (the parsed label dicts); plus 'K' [3, 3] and 'shift'."""
    rng = rng or np.random
    anns = read_label_file(label_path, classes, fieldnames)
    K, shift = decompose_projection(read_calib_file(calib_path))

    cam_coords, pose_vecs, ids = [], [], []
    bboxes, rotations, raw_kept = [], [], []
    for a in anns:
        l, h, w = a["dimensions"]
        corners = cuboid.construct_box_3d(l, h, w, interpolate=True,
                                          interp_coef=interp_coef)
        aug_ids, aug_poses = augment_pose_vector(
            a["locations"], a["rot_y"], a["label"], a["dimensions"],
            augment, augment_times, rng if augment else None)
        for pose in aug_poses:
            if random_yaw:
                pose = pose.copy()
                pose[0, 4] += rng.randn() * np.pi
            cam_coords.append(cuboid.place_cuboid(corners, pose, shift))
        ids += aug_ids
        pose_vecs += aug_poses
        bboxes += [np.array(a["bbox"]).reshape(1, 4)] * len(aug_poses)
        rotations += [np.array([a["alpha"], a["rot_y"]]).reshape(1, 2)] \
            * len(aug_poses)
        raw_kept += [a] * len(aug_poses)

    out = {"K": K, "shift": shift, "raw": [], "kpts_2d": [], "kpts_3d": [],
           "pose_vecs": [], "ids": [], "bboxes": [], "rotations": []}
    if not cam_coords:
        return out

    all_pts = np.vstack(cam_coords)                       # [N*33, 3]
    projected = cuboid.project_3d_to_2d(all_pts, K)[:2].T  # [N*33, 2]
    n = len(cam_coords)
    width, height = img_size
    p2d = [cuboid.add_visibility(p, width, height)
           for p in np.split(projected, n, axis=0)]
    for i in range(n):
        if filter_outlier and p2d[i][:, 2].sum() / len(p2d[i]) \
                < visibility_threshold:
            continue
        out["kpts_2d"].append(p2d[i])
        out["kpts_3d"].append(cam_coords[i])
        out["pose_vecs"].append(pose_vecs[i])
        out["ids"].append(ids[i])
        out["bboxes"].append(bboxes[i])
        out["rotations"].append(rotations[i])
        out["raw"].append(raw_kept[i])
    return out


def to_lifter_representation(kpts_2d, kpts_3d, out_rep: str = "R3d"):
    """Input / output vectors for the lifter.  'R3d': output = the 32
    points relative to the first (center) point; 'R3d+T': [root, 32
    relative points].  The input is the flattened (u, v) coordinates.
    Returns (input [66], output [96 or 99], root [1, 3])."""
    inp = np.asarray(kpts_2d)[:, :2].reshape(-1).astype(np.float64)
    p3d = np.asarray(kpts_3d)
    root = p3d[[0], :]
    rel = p3d[1:, :] - root
    if out_rep == "R3d":
        out = rel.reshape(-1)
    elif out_rep == "R3d+T":
        out = np.concatenate([root, rel], axis=0).reshape(-1)
    else:
        raise NotImplementedError(out_rep)
    return inp, out, root


# ---------------------------------------------------------------------------
# split / directory layout
# ---------------------------------------------------------------------------

class KITTIPaths:
    """Directory layout of a KITTI object-detection root.  'valid' and
    'trainvalid' are index subsets of the official training split, so their
    files live under <root>/training/."""

    def __init__(self, root: str, split: str):
        self.root = root
        self.split = split
        base = "testing" if split == "test" else "training"
        self.image_dir = pjoin(root, base, "image_2")
        self.label_dir = pjoin(root, base, "label_2")
        self.calib_dir = pjoin(root, base, "calib")
        self.keypoint_dir = pjoin(root, base, "keypoints")
        self.list_file = {
            "train": pjoin(root, "training/ImageSets/train.txt"),
            "valid": pjoin(root, "training/ImageSets/val.txt"),
            "trainvalid": pjoin(root, "training/ImageSets/trainval.txt"),
            "test": pjoin(root, "testing/ImageSets/test.txt"),
        }[split]

    def image_names(self) -> list:
        with open(self.list_file, "r") as f:
            return [line.strip() + ".png" for line in f.read().splitlines()
                    if line.strip()]

    def image_path(self, name: str) -> str:
        return pjoin(self.image_dir, name)

    def label_path(self, name: str) -> str:
        return pjoin(self.label_dir, name[:-3] + "txt")

    def calib_path(self, name: str) -> str:
        return pjoin(self.calib_dir, name[:-3] + "txt")


def image_size_of(path: str):
    """(width, height) from the PNG header, without decoding."""
    return png.image_size(path)


# ---------------------------------------------------------------------------
# dataset facade
# ---------------------------------------------------------------------------

class KITTIDataset:
    """Experiment-aware KITTI data facade.

    exp_type:
      'inference'    -> per-image annotation records (GT boxes, K, raw txt)
                        in ``annot_dict``
      'instanceto2d' -> per-image keypoint / box records for IGR training
                        (also 'baselinealpha', 'baselinetheta')
      '2dto3d'       -> in-RAM (input, output) pairs for lifter training
      'finetune'     -> annotation records plus finetuning ``records``
    """

    def __init__(self, cfgs: dict, split: str, logger=None):
        self.cfgs = cfgs
        self.split = split
        self.logger = logger
        self.exp_type = cfgs["exp_type"]
        self.classes = tuple(cfgs["dataset"]["detect_classes"])
        interp = cfgs["dataset"].get("interpolate", {})
        self.interp_coef = tuple(interp.get("coef", DEFAULT_INTERP_COEF))
        self.paths = KITTIPaths(cfgs["dataset"]["root"], split)
        self.enlarge_factor = cfgs["dataset"].get("enlarge_factor", 1.1)
        self.statistics = None
        self._log(f"Initializing KITTI {split} set ({self.exp_type})")
        if self.exp_type == "inference":
            self.annot_dict = self.gather_annotations()
            self.image_names = list(self.annot_dict.keys())
        elif self.exp_type in ("instanceto2d", "baselinealpha",
                               "baselinetheta"):
            self.records = self._prepare_instance_records(cfgs)
        elif self.exp_type == "2dto3d":
            self._prepare_lifting_pairs(cfgs)
        elif self.exp_type == "finetune":
            self.annot_dict = self.gather_annotations(
                add_gt=True, filter_outlier=True, use_raw_bbox=False)
            self.image_names = list(self.annot_dict.keys())
            self.records = self._finetune_records()
        else:
            raise NotImplementedError(self.exp_type)

        # optional weak self-supervision from unlabeled images
        self.ss_record = None
        if cfgs.get("ss", {}).get("flag"):
            self.ss_record = np.load(cfgs["ss"]["record_path"],
                                     allow_pickle=True).item()
            self.ss_img_root = cfgs["ss"]["img_root"]
            self.ss_max_per_img = int(cfgs["ss"].get("max_per_img", 6))
        self._log(f"KITTI {split} set ready")

    def _finetune_records(self) -> list:
        """Per-image records for end-to-end finetuning: GT keypoints, boxes
        derived from projected cuboids, 3D targets and intrinsics."""
        records = []
        for name in self.image_names:
            rec = self.annot_dict[name]
            if "kpts" not in rec:
                continue
            records.append({
                "path": self.paths.image_path(name),
                "boxes": rec["bbox_2d"],
                "kpts": rec["kpts"][:, :, :2],
                "kpts_vis": rec["kpts"][:, :, 2],
                "kpts_3d": rec["kpts_3d_gt"],
                "K": rec["K"],
                "pose_vecs": rec.get("pose_vecs_gt"),
            })
        return records

    def _log(self, msg):
        if self.logger is not None:
            self.logger.info(msg)

    def gather_annotations(self, add_gt: bool = True,
                           filter_outlier: bool = False,
                           use_raw_bbox: bool = False) -> dict:
        """Per-image annotation records.  GT-box inference crops from the
        box of the projected cuboid's keypoints (kpts2cs, enlarge 1.01),
        not the raw label box, which is clipped for truncated cars."""
        records = {}
        for name in self.paths.image_names():
            if self.split == "test":
                records[name] = {}
                continue
            rec = self.read_single_file(
                name, self.paths.label_path(name),
                fieldnames=FIELDNAMES, add_gt=add_gt,
                use_raw_bbox=use_raw_bbox, filter_outlier=filter_outlier)
            if rec is not None:
                records[name] = rec
        return records

    def read_single_file(self, image_name: str, label_path: str,
                         fieldnames=FIELDNAMES_P, add_gt: bool = False,
                         use_raw_bbox: bool = True,
                         filter_outlier: bool = False):
        """Annotation record for one image, or None without instances."""
        try:
            img_size = image_size_of(self.paths.image_path(image_name))
        except FileNotFoundError:
            img_size = (1242, 375)
        pairs = get_2d_3d_pairs(
            label_path, self.paths.calib_path(image_name),
            classes=self.classes, img_size=img_size,
            interp_coef=self.interp_coef,
            filter_outlier=filter_outlier, fieldnames=fieldnames)
        if not pairs["raw"]:
            return None
        rec = {"K": pairs["K"], "raw_txt_format": pairs["raw"]}
        kpts_2d = np.stack(pairs["kpts_2d"])          # [N, 33, 3]
        kpts_3d = np.stack(pairs["kpts_3d"])          # [N, 33, 3]
        rec["kpts_3d"] = kpts_3d
        if add_gt:
            rec["kpts"] = kpts_2d
            rec["kpts_3d_gt"] = kpts_3d
            rec["pose_vecs_gt"] = np.vstack(pairs["pose_vecs"])
        if use_raw_bbox:
            rec["bbox_2d"] = np.vstack(pairs["bboxes"])
        else:
            boxes = []
            for kp in kpts_2d:
                c, s, _, _ = affine.kpts2cs(kp[:, :2], enlarge=1.01)
                boxes.append(np.array(affine.cs2bbox(c, s)).reshape(1, 4))
            rec["bbox_2d"] = np.vstack(boxes)
        if add_gt:
            rec["boxes"] = rec["bbox_2d"]
        return rec

    def show_annot(self, image_name: str, save_dir: str,
                   label_path: str | None = None) -> tuple:
        """Save ``<name>_original.png`` and ``<name>_annotated.png``, the
        latter with the projected ground-truth cuboids drawn over the frame
        (the reference's car_instance.show_annot, :1012-1050, in
        wireframes); returns both paths.  Needs matplotlib."""
        from egonet_tpu_torch.data.image_store import decode_image
        from egonet_tpu_torch.visualization import points as vp
        plt = vp.pyplot()
        rec = self.read_single_file(
            image_name, label_path or self.paths.label_path(image_name),
            fieldnames=FIELDNAMES, add_gt=True)
        if rec is None:
            raise ValueError(f"no annotations for {image_name}")
        img = decode_image(self.paths.image_path(image_name))
        os.makedirs(save_dir, exist_ok=True)
        paths = []
        for suffix, annotate in (("original", False), ("annotated", True)):
            fig = plt.figure(figsize=(11.3, 9))
            ax = fig.add_subplot(111)
            ax.imshow(img)
            if annotate:
                for kp in rec["kpts"]:
                    ax.plot(kp[1:9, 0], kp[1:9, 1], "ro", markersize=2)
                    vp.plot_2d_bbox(ax, kp[1:9, :2])
            out = pjoin(save_dir, f"{image_name}_{suffix}.png")
            fig.savefig(out, dpi=100, bbox_inches="tight")
            plt.close(fig)
            paths.append(out)
        return tuple(paths)

    def read_predictions(self, pred_dir: str) -> dict:
        """Read external-detector txts (label format + score column).  Raw
        detector boxes are used only on the test split; elsewhere the box
        is re-derived from the detector's projected 3D cuboid."""
        records = {}
        use_raw_bbox = self.split == "test"
        for file_name in sorted(os.listdir(pred_dir)):
            if not file_name.endswith(".txt"):
                continue
            image_name = file_name[:-4] + ".png"
            rec = self.read_single_file(
                image_name, pjoin(pred_dir, file_name),
                fieldnames=FIELDNAMES_P, add_gt=False,
                use_raw_bbox=use_raw_bbox)
            if rec is not None:
                records[image_name] = rec
        return records

    # -------------------- IGR training --------------------

    def _instance_record_cache_path(self):
        """Cache file of the prepared keypoint records (the enlarge factor
        is part of the key: the records embed boxes computed with it)."""
        coef = "".join(f"{c:g}" for c in self.interp_coef)
        name = (f"records_bbox12_{coef}_e{self.enlarge_factor:g}_"
                f"{self.split}_{'-'.join(self.classes)}.npy")
        return pjoin(self.paths.keypoint_dir, name)

    def _prepare_instance_records(self, cfgs,
                                  visibility_threshold: int = 4) -> list:
        """Per-image training records: image path, instance boxes (from the
        projected keypoints), keypoints and gt rotations; cached as .npy
        next to the dataset when ``dataset.pre-process`` is set."""
        cache = self._instance_record_cache_path()
        if os.path.exists(cache):
            self._log(f"Found prepared keypoints at {cache}")
            return list(np.load(cache, allow_pickle=True))
        records = []
        for name in self.paths.image_names():
            img_path = self.paths.image_path(name)
            try:
                img_size = image_size_of(img_path)
            except FileNotFoundError:
                continue
            pairs = get_2d_3d_pairs(
                self.paths.label_path(name), self.paths.calib_path(name),
                classes=self.classes, img_size=img_size,
                interp_coef=self.interp_coef, filter_outlier=True,
                visibility_threshold=0.25)
            boxes, kpts, rots = [], [], []
            for i, kp in enumerate(pairs["kpts_2d"]):
                if kp[:, 2].sum() < visibility_threshold:
                    continue
                pts = kp[:, :2]
                c, s, _, _ = affine.kpts2cs(pts, enlarge=self.enlarge_factor)
                boxes.append(np.array(
                    list(map(int, affine.cs2bbox(c, s)))).reshape(1, 4))
                kpts.append(pts[None])
                rots.append(pairs["rotations"][i].reshape(1, 2))
            if not boxes:
                continue
            records.append({
                "path": img_path,
                "boxes": np.concatenate(boxes),
                "kpts": np.concatenate(kpts),
                "rots": np.concatenate(rots),
            })
        if cfgs["dataset"].get("pre-process", False):
            try:
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                np.save(cache, np.array(records, dtype=object))
                self._log(f"Saved prepared keypoints at {cache}")
            except OSError:
                pass
        return records

    # -------------------- lifter training --------------------

    def _prepare_lifting_pairs(self, cfgs):
        """``input`` / ``output`` float32 arrays and ``roots``; the train
        split is augmented (``lft_aug`` x ``lft_aug_times`` perturbed poses,
        random yaw) from ``RandomState(cfgs['seed'])``."""
        ts = cfgs.get("training_settings", {})
        augment = bool(ts.get("lft_aug", False)) and self.split == "train"
        augment_times = int(ts.get("lft_aug_times", 1))
        out_rep = cfgs["dataset"].get("lft_out_rep", "R3d")
        rng = np.random.RandomState(cfgs.get("seed", 0))
        inputs, outputs, roots = [], [], []
        for name in self.paths.image_names():
            try:
                img_size = image_size_of(self.paths.image_path(name))
            except FileNotFoundError:
                img_size = (1242, 375)
            pairs = get_2d_3d_pairs(
                self.paths.label_path(name), self.paths.calib_path(name),
                classes=self.classes, img_size=img_size,
                interp_coef=self.interp_coef,
                augment=augment, augment_times=augment_times,
                random_yaw=(self.split == "train"), rng=rng)
            for kp2, kp3 in zip(pairs["kpts_2d"], pairs["kpts_3d"]):
                inp, out, root = to_lifter_representation(kp2, kp3, out_rep)
                inputs.append(inp)
                outputs.append(out)
                roots.append(root)
        self.input = np.asarray(inputs, dtype=np.float32)
        self.output = np.asarray(outputs, dtype=np.float32)
        self.roots = np.concatenate(roots) if roots else np.zeros((0, 3))

    def normalize(self, statistics: dict | None = None):
        """Standardize the pairs; computes the statistics (the LS.npy
        contents) when not given."""
        if statistics is None:
            statistics = {
                "mean_in": self.input.mean(axis=0, keepdims=True),
                "std_in": self.input.std(axis=0, keepdims=True),
                "mean_out": self.output.mean(axis=0, keepdims=True),
                "std_out": self.output.std(axis=0, keepdims=True),
            }
        self.statistics = statistics
        self.input = (self.input - statistics["mean_in"]) / statistics["std_in"]
        self.output = ((self.output - statistics["mean_out"])
                       / statistics["std_out"])
        return statistics

    def __len__(self):
        if self.exp_type == "inference":
            return len(self.image_names)
        if self.exp_type == "2dto3d":
            return len(self.input)
        return len(self.records)


def prepare_data(cfgs: dict, logger=None):
    """(train, valid) dataset pair; the lifter statistics come from the
    train split."""
    train_set = KITTIDataset(cfgs, "train", logger)
    valid_set = KITTIDataset(cfgs, "valid", logger)
    if cfgs["exp_type"] == "2dto3d":
        stats = train_set.normalize()
        valid_set.normalize(stats)
    return train_set, valid_set


def get_dataset(cfgs: dict, logger=None, split: str = "valid"):
    return KITTIDataset(cfgs, split, logger)
