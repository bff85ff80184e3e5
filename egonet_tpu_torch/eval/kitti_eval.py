"""KITTI object-detection evaluation (AP / AOS / AP_BEV / AP_3D) in Python.
A numpy copy of ``egonet_tpu/eval/kitti_eval.py`` (same functions, same
summaries and stats files), kept in the port so that it imports nothing of
the JAX package.

An independent implementation of the official evaluation protocol, written
from the behavioural spec of the vendored evaluator
(the reference's tools/kitti-eval/evaluate_object_3d_offline_r40.cpp):

  * difficulty gates MIN_HEIGHT/MAX_OCCLUSION/MAX_TRUNCATION (:43-45),
  * class-specific minimum overlaps (:55),
  * 41-point recall discretization and threshold selection (:346-379),
  * ignore/don't-care semantics incl. neighboring classes (:381-454),
  * greedy matching + AOS similarity (1+cos d)/2 (:456-616),
  * precision/AOS envelope max-filter and the R40 (mean of points 1..40)
    and R11 (every 4th point / 11) AP summaries (:696-701, :719-723).

BEV overlaps use a self-contained convex polygon clipper (Sutherland-
Hodgman) instead of Boost.Geometry.  This module is both the unit-testable
reference for the C++ binary in tools/kitti-eval/ and a usable evaluator on
its own.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

CLASS_NAMES = ("car", "pedestrian", "cyclist")
DIFFICULTIES = ("easy", "moderate", "hard")
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
# rows: metric (image, ground, 3d); cols: class
MIN_OVERLAP = ((0.7, 0.5, 0.5), (0.7, 0.5, 0.5), (0.7, 0.5, 0.5))
# the test server uses looser BEV/3D gates for ped/cyclist
# (the reference's tools/kitti-eval/evaluate_object_3d.cpp:54)
MIN_OVERLAP_SERVER = ((0.7, 0.5, 0.5), (0.5, 0.25, 0.25), (0.5, 0.25, 0.25))
N_SAMPLE_PTS = 41

METRIC_IMAGE, METRIC_GROUND, METRIC_3D = 0, 1, 2


@dataclass
class Obj:
    type: str
    truncation: float = -1.0
    occlusion: int = -1
    alpha: float = -10.0
    x1: float = -1.0
    y1: float = -1.0
    x2: float = -1.0
    y2: float = -1.0
    h: float = 0.0
    w: float = 0.0
    l: float = 0.0
    t1: float = -1000.0
    t2: float = -1000.0
    t3: float = -1000.0
    ry: float = -10.0
    score: float = -1000.0


def parse_label_line(line: str, is_detection: bool):
    f = line.split()
    if len(f) < 15:
        return None
    o = Obj(type=f[0], truncation=float(f[1]), occlusion=int(float(f[2])),
            alpha=float(f[3]), x1=float(f[4]), y1=float(f[5]),
            x2=float(f[6]), y2=float(f[7]), h=float(f[8]), w=float(f[9]),
            l=float(f[10]), t1=float(f[11]), t2=float(f[12]),
            t3=float(f[13]), ry=float(f[14]))
    if is_detection:
        if len(f) < 16:
            return None
        o.score = float(f[15])
    return o


def load_objects(path: str, is_detection: bool) -> list:
    objs = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            o = parse_label_line(line, is_detection)
            if o is not None:
                objs.append(o)
    return objs


# ---------------------------------------------------------------------------
# Overlap kernels
# ---------------------------------------------------------------------------

def image_box_overlap(d: Obj, g: Obj, criterion: int = -1) -> float:
    x1, y1 = max(d.x1, g.x1), max(d.y1, g.y1)
    x2, y2 = min(d.x2, g.x2), min(d.y2, g.y2)
    w, h = x2 - x1, y2 - y1
    if w <= 0 or h <= 0:
        return 0.0
    inter = w * h
    a_area = (d.x2 - d.x1) * (d.y2 - d.y1)
    b_area = (g.x2 - g.x1) * (g.y2 - g.y1)
    if criterion == -1:
        return inter / (a_area + b_area - inter)
    if criterion == 0:
        return inter / a_area
    return inter / b_area


def bev_corners(o: Obj) -> np.ndarray:
    """Footprint rectangle in the (x, z) ground plane, CCW-agnostic [4, 2]."""
    c, s = math.cos(o.ry), math.sin(o.ry)
    xs = np.array([o.l / 2, o.l / 2, -o.l / 2, -o.l / 2])
    zs = np.array([o.w / 2, -o.w / 2, -o.w / 2, o.w / 2])
    x = c * xs + s * zs + o.t1
    z = -s * xs + c * zs + o.t3
    return np.stack([x, z], axis=1)


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, z = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(z, -1))
                           - np.dot(z, np.roll(x, -1))))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clipping of a convex polygon by a convex polygon."""
    # ensure the clip polygon is counter-clockwise
    cx, cz = clip[:, 0], clip[:, 1]
    signed = 0.5 * (np.dot(cx, np.roll(cz, -1)) - np.dot(cz, np.roll(cx, -1)))
    if signed == 0:
        # a fully degenerate clip polygon (zero l and/or w collapses it to
        # a line/point) has no interior: every edge test would trivially
        # pass and the whole subject would count as intersection — Boost
        # (the reference's geometry backend) returns an empty intersection
        return np.zeros((0, 2))
    if signed < 0:
        clip = clip[::-1]
    output = [tuple(p) for p in subject]
    n = len(clip)
    for i in range(n):
        a = clip[i]
        b = clip[(i + 1) % n]
        if not output:
            return np.zeros((0, 2))
        inputs = output
        output = []

        def inside(p):
            return ((b[0] - a[0]) * (p[1] - a[1])
                    - (b[1] - a[1]) * (p[0] - a[0])) >= 0

        def intersect(p, q):
            dx1, dz1 = q[0] - p[0], q[1] - p[1]
            dx2, dz2 = b[0] - a[0], b[1] - a[1]
            denom = dx1 * dz2 - dz1 * dx2
            if denom == 0:
                return q
            t = ((a[0] - p[0]) * dz2 - (a[1] - p[1]) * dx2) / denom
            return (p[0] + t * dx1, p[1] + t * dz1)

        s = inputs[-1]
        for e in inputs:
            if inside(e):
                if not inside(s):
                    output.append(intersect(s, e))
                output.append(e)
            elif inside(s):
                output.append(intersect(s, e))
            s = e
    return np.array(output) if output else np.zeros((0, 2))


def bev_intersection_area(d: Obj, g: Obj) -> float:
    pd, pg = bev_corners(d), bev_corners(g)
    return _polygon_area(_clip_polygon(pd, pg))


def ground_box_overlap(d: Obj, g: Obj, criterion: int = -1) -> float:
    inter = bev_intersection_area(d, g)
    d_area = d.l * d.w
    g_area = g.l * g.w
    if criterion == -1:
        union = d_area + g_area - inter
        return inter / union if union > 0 else 0.0
    if criterion == 0:
        return inter / d_area if d_area > 0 else 0.0
    return inter / g_area if g_area > 0 else 0.0


def box3d_overlap(d: Obj, g: Obj, criterion: int = -1) -> float:
    inter_area = bev_intersection_area(d, g)
    ymax = min(d.t2, g.t2)
    ymin = max(d.t2 - d.h, g.t2 - g.h)
    inter_vol = inter_area * max(0.0, ymax - ymin)
    d_vol = d.h * d.l * d.w
    g_vol = g.h * g.l * g.w
    if criterion == -1:
        union = d_vol + g_vol - inter_vol
        return inter_vol / union if union > 0 else 0.0
    if criterion == 0:
        return inter_vol / d_vol if d_vol > 0 else 0.0
    return inter_vol / g_vol if g_vol > 0 else 0.0


OVERLAP_FN = {METRIC_IMAGE: image_box_overlap,
              METRIC_GROUND: ground_box_overlap,
              METRIC_3D: box3d_overlap}


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

def clean_data(cls_idx: int, gts: list, dets: list, difficulty: int):
    """Ignore flags: 0 = evaluate, 1 = ignore, -1 = don't evaluate."""
    cls_name = CLASS_NAMES[cls_idx]
    ignored_gt, dontcare = [], []
    n_gt = 0
    for g in gts:
        gtype = g.type.lower()
        if gtype == cls_name:
            valid = 1
        elif cls_name == "pedestrian" and gtype == "person_sitting":
            valid = 0
        elif cls_name == "car" and gtype == "van":
            valid = 0
        else:
            valid = -1
        ignore = (g.occlusion > MAX_OCCLUSION[difficulty]
                  or g.truncation > MAX_TRUNCATION[difficulty]
                  or (g.y2 - g.y1) < MIN_HEIGHT[difficulty])
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            n_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
    for g in gts:
        if g.type.lower() == "dontcare":
            dontcare.append(g)
    ignored_det = []
    for d in dets:
        height = abs(d.y1 - d.y2)
        if int(height) < MIN_HEIGHT[difficulty]:
            ignored_det.append(1)
        elif d.type.lower() == cls_name:
            ignored_det.append(0)
        else:
            ignored_det.append(-1)
    return ignored_gt, dontcare, ignored_det, n_gt


def compute_statistics(cls_idx, gts, dets, dontcare, ignored_gt, ignored_det,
                       compute_fp, metric, compute_aos=False, thresh=0.0,
                       overlap_table=MIN_OVERLAP, ovl=None):
    """Greedy matching for one frame at one score threshold.

    ``ovl`` (optional): precomputed overlap matrix ovl[j][i] =
    overlap_fn(dets[j], gts[i], -1).  It depends only on (metric, frame)
    but this function runs once per recall threshold per difficulty —
    recomputing the BEV clipper there dominates full-split runtime.
    """
    min_overlap = overlap_table[metric][cls_idx]
    overlap_fn = OVERLAP_FN[metric]
    NO_DETECTION = -10000000.0
    tp = fp = fn = 0
    scores = []
    delta = []
    assigned = [False] * len(dets)
    ignored_threshold = [compute_fp and d.score < thresh for d in dets]

    for i, g in enumerate(gts):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j, d in enumerate(dets):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = ovl[j][i] if ovl is not None else overlap_fn(d, g, -1)
            if (not compute_fp and overlap > min_overlap
                    and d.score > valid_detection):
                det_idx = j
                valid_detection = d.score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION
                  and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            scores.append(dets[det_idx].score)
            if compute_aos:
                delta.append(g.alpha - dets[det_idx].alpha)
            assigned[det_idx] = True

    similarity = 0.0
    if compute_fp:
        for j, d in enumerate(dets):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        for dc in dontcare:
            for j, d in enumerate(dets):
                if (assigned[j] or ignored_det[j] in (-1, 1)
                        or ignored_threshold[j]):
                    continue
                if overlap_fn(d, dc, 0) > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            sims = [0.0] * fp + [(1.0 + math.cos(dl)) / 2.0 for dl in delta]
            similarity = sum(sims) if (tp > 0 or fp > 0) else -1.0
    return {"tp": tp, "fp": fp, "fn": fn, "scores": scores,
            "similarity": similarity}


def get_thresholds(scores: list, n_gt: int) -> list:
    thresholds = []
    scores = sorted(scores, reverse=True)
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return thresholds


def eval_class(gt_frames, det_frames, cls_idx, difficulty, metric,
               compute_aos=False, overlap_table=MIN_OVERLAP, ovl=None):
    """Returns (precision[41], aos[41] or None).

    ``ovl``: optional per-frame overlap matrices (see compute_statistics);
    computed here when not supplied so the clipper runs once per frame
    instead of once per threshold."""
    if ovl is None:
        fn = OVERLAP_FN[metric]
        ovl = [[[fn(d, g, -1) for g in gts] for d in dets]
               for gts, dets in zip(gt_frames, det_frames)]
    n_gt = 0
    all_scores = []
    cleaned = []
    for f_idx, (gts, dets) in enumerate(zip(gt_frames, det_frames)):
        ignored_gt, dc, ignored_det, frame_n_gt = clean_data(
            cls_idx, gts, dets, difficulty)
        n_gt += frame_n_gt
        cleaned.append((ignored_gt, dc, ignored_det))
        stat = compute_statistics(cls_idx, gts, dets, dc, ignored_gt,
                                  ignored_det, False, metric,
                                  overlap_table=overlap_table,
                                  ovl=ovl[f_idx])
        all_scores += stat["scores"]

    thresholds = get_thresholds(all_scores, n_gt)
    agg = [{"tp": 0, "fp": 0, "fn": 0, "similarity": 0.0}
           for _ in thresholds]
    for f_idx, ((gts, dets), (ignored_gt, dc, ignored_det)) in enumerate(
            zip(zip(gt_frames, det_frames), cleaned)):
        for t, thr in enumerate(thresholds):
            stat = compute_statistics(cls_idx, gts, dets, dc, ignored_gt,
                                      ignored_det, True, metric,
                                      compute_aos, thr,
                                      overlap_table=overlap_table,
                                      ovl=ovl[f_idx])
            agg[t]["tp"] += stat["tp"]
            agg[t]["fp"] += stat["fp"]
            agg[t]["fn"] += stat["fn"]
            if stat["similarity"] != -1:
                agg[t]["similarity"] += stat["similarity"]

    precision = [0.0] * N_SAMPLE_PTS
    aos = [0.0] * N_SAMPLE_PTS if compute_aos else None
    for i, a in enumerate(agg):
        denom = a["tp"] + a["fp"]
        precision[i] = a["tp"] / denom if denom else 0.0
        if compute_aos:
            aos[i] = a["similarity"] / denom if denom else 0.0
    for i in range(len(agg)):
        precision[i] = max(precision[i:])
        if compute_aos:
            aos[i] = max(aos[i:])
    return precision, aos


def ap_r40(vals) -> float:
    return sum(vals[1:]) / 40.0 * 100.0


def ap_r11(vals) -> float:
    return sum(vals[0::4]) / 11.0 * 100.0


def evaluate(gt_dir: str, result_dir: str, metrics=("image", "ground", "3d"),
             write_stats: bool = True, server: bool = False,
             n_testimages: int = 7518) -> dict:
    """Full offline evaluation over ``result_dir/data/*.txt``.

    ``server=True`` reproduces the test-server variant
    (the reference's tools/kitti-eval/evaluate_object_3d.cpp): a FIXED
    0..n_testimages-1 index range where every submission file must exist,
    and looser ped/cyclist ground/3D overlap gates.

    Returns {class: {metric: {difficulty: {"precision": [...],
    "aos": [...]|None, "ap_r40": x, "ap_r11": x, "aos_r40": x|None}}}}.
    """
    data_dir = os.path.join(result_dir, "data")
    if server:
        if n_testimages <= 0:
            raise ValueError(f"server mode needs a positive image count, "
                             f"got {n_testimages}")
        names = [f"{i:06d}.txt" for i in range(n_testimages)]
        missing = [n for n in names
                   if not os.path.exists(os.path.join(data_dir, n))]
        if missing:
            raise FileNotFoundError(
                f"server mode requires all {n_testimages} submission files; "
                f"missing {missing[0]} (+{len(missing) - 1} more)")
    else:
        # only KITTI frame files ("######.txt"): a stray notes.txt must not
        # abort the evaluation looking for its ground truth
        names = sorted(f for f in os.listdir(data_dir)
                       if len(f) == 10 and f.endswith(".txt")
                       and f[:6].isdigit())
    overlap_table = MIN_OVERLAP_SERVER if server else MIN_OVERLAP
    gt_frames, det_frames = [], []
    compute_aos = True
    present = set()
    eval_ground_cls = set()
    eval_3d_cls = set()
    for name in names:
        gts = load_objects(os.path.join(gt_dir, name), is_detection=False)
        dets = load_objects(os.path.join(data_dir, name), is_detection=True)
        gt_frames.append(gts)
        det_frames.append(dets)
        for d in dets:
            if d.alpha == -10:
                compute_aos = False
            if d.type.lower() in CLASS_NAMES:
                ci = CLASS_NAMES.index(d.type.lower())
                if d.x1 >= 0:
                    present.add(ci)
                if d.t1 != -1000:
                    eval_ground_cls.add(ci)
                if d.t2 != -1000:
                    eval_3d_cls.add(ci)

    metric_ids = {"image": METRIC_IMAGE, "ground": METRIC_GROUND,
                  "3d": METRIC_3D}
    # per-metric overlap matrices, shared across classes/difficulties/
    # thresholds (the matrix depends only on the metric and the frames)
    ovl_cache: dict = {}

    def metric_ovl(metric):
        if metric not in ovl_cache:
            fn = OVERLAP_FN[metric]
            ovl_cache[metric] = [
                [[fn(d, g, -1) for g in gts] for d in dets]
                for gts, dets in zip(gt_frames, det_frames)]
        return ovl_cache[metric]

    results: dict = {}
    for cls_idx in sorted(present):
        cls = CLASS_NAMES[cls_idx]
        results[cls] = {}
        for metric_name in metrics:
            metric = metric_ids[metric_name]
            if metric == METRIC_GROUND and cls_idx not in eval_ground_cls:
                continue
            if metric == METRIC_3D and cls_idx not in eval_3d_cls:
                continue
            aos_ok = compute_aos and metric == METRIC_IMAGE
            results[cls][metric_name] = {}
            for diff_idx, diff in enumerate(DIFFICULTIES):
                precision, aos = eval_class(gt_frames, det_frames, cls_idx,
                                            diff_idx, metric, aos_ok,
                                            overlap_table=overlap_table,
                                            ovl=metric_ovl(metric))
                entry = {
                    "precision": precision,
                    "aos": aos,
                    "ap_r40": ap_r40(precision),
                    "ap_r11": ap_r11(precision),
                }
                if aos is not None:
                    entry["aos_r40"] = ap_r40(aos)
                    entry["aos_r11"] = ap_r11(aos)
                results[cls][metric_name][diff] = entry
    if write_stats:
        _write_stats(result_dir, results)
    return results


def _write_stats(result_dir: str, results: dict):
    """stats_<class>_detection[_ground|_3d].txt files: one precision row per
    difficulty, matching the reference's saveStats layout."""
    suffix = {"image": "detection", "ground": "detection_ground",
              "3d": "detection_3d"}
    for cls, metrics in results.items():
        for metric_name, diffs in metrics.items():
            path = os.path.join(result_dir,
                                f"stats_{cls}_{suffix[metric_name]}.txt")
            with open(path, "w") as f:
                for diff in DIFFICULTIES:
                    row = diffs[diff]["precision"]
                    f.write(" ".join(f"{v:f}" for v in row) + " \n")
            if metric_name == "image" and diffs["easy"]["aos"] is not None:
                path = os.path.join(result_dir, f"stats_{cls}_orientation.txt")
                with open(path, "w") as f:
                    for diff in DIFFICULTIES:
                        row = diffs[diff]["aos"]
                        f.write(" ".join(f"{v:f}" for v in row) + " \n")


def format_summary(results: dict, style: str = "r40") -> str:
    lines = []
    suffix = {"image": "detection", "ground": "detection_ground",
              "3d": "detection_3d"}
    for cls, metrics in results.items():
        for metric_name, diffs in metrics.items():
            key = "ap_" + style
            vals = [diffs[d][key] for d in DIFFICULTIES]
            lines.append(f"{cls}_{suffix[metric_name]} AP: "
                         f"{vals[0]:.6f} {vals[1]:.6f} {vals[2]:.6f}")
            if metric_name == "image" and "aos_" + style in diffs["easy"]:
                vals = [diffs[d]["aos_" + style] for d in DIFFICULTIES]
                # the official evaluator prints "AP:" even for the
                # orientation metric (r40.cpp:723: "%s AP:" with
                # file_name "<cls>_orientation")
                lines.append(f"{cls}_orientation AP: "
                             f"{vals[0]:.6f} {vals[1]:.6f} {vals[2]:.6f}")
    return "\n".join(lines)


def main(argv=None):
    """CLI twin of the C++ binary:
    ``python -m egonet_tpu_torch.eval.kitti_eval [--server[=N]] [--plot]
    <gt_dir> <result_dir>``."""
    import argparse
    parser = argparse.ArgumentParser(description="KITTI offline evaluation")
    parser.add_argument("gt_dir")
    parser.add_argument("result_dir")
    parser.add_argument("--server", nargs="?", const=7518, default=None,
                        type=int, metavar="N",
                        help="test-server mode: fixed 0..N-1 index range, "
                             "looser ped/cyclist ground/3D gates")
    parser.add_argument("--plot", action="store_true",
                        help="also render PR/AOS figures to "
                             "<result_dir>/plot/")
    args = parser.parse_args(argv)
    if args.server is not None and args.server <= 0:
        parser.error("--server expects a positive image count")
    results = evaluate(args.gt_dir, args.result_dir,
                       server=args.server is not None,
                       n_testimages=args.server
                       if args.server is not None else 7518)
    print(format_summary(results, style="r40"))
    print(format_summary(results, style="r11"))
    if args.plot:
        from egonet_tpu_torch.eval.plots import plot_pr_curves
        for p in plot_pr_curves(args.result_dir):
            print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
