"""KITTI-format label emission, byte-compatible with the JAX package's
writer (``egonet_tpu/io/kitti_writer.py``): field order, fixed-point
precisions, the h w l reorder, the trailing space on every line, and the
rule that only rot_y and alpha of a detector line are overwritten; and the
empty files a test-split submission needs."""

from __future__ import annotations

import os


def instance_str(dic: dict) -> str:
    """One KITTI prediction line (with trailing space, no newline)."""
    parts = [
        dic["class"] + " ",
        "{:.1f} ".format(dic["truncation"]),
        "{:.1f} ".format(dic["occlusion"]),
        "{:.6f} ".format(dic["alpha"]),
        "{:.6f} {:.6f} {:.6f} {:.6f} ".format(*dic["bbox"][:4]),
        "{:.6f} {:.6f} {:.6f} ".format(dic["dimensions"][1],
                                       dic["dimensions"][2],
                                       dic["dimensions"][0]),
        "{:.6f} {:.6f} {:.6f} ".format(*dic["locations"][:3]),
        "{:.6f} ".format(dic["rot_y"]),
        "{:.8f} ".format(dic.get("score", 1.0)),
    ]
    return "".join(parts)


def prediction_str(raw_txt_format: list, euler_angles, alphas) -> str:
    """Rewrite the detector's lines with refined rot_y/alpha.

    raw_txt_format: per-instance dicts parsed from the detector txt;
    euler_angles: [N, 3]; alphas: [N]."""
    return "\n".join(
        instance_str(dict(raw_txt_format[i], rot_y=float(euler_angles[i][1]),
                          alpha=float(alphas[i])))
        for i in range(len(euler_angles)))


def save_txt_file(img_path: str, pred_str: str, save_dir: str) -> str:
    """Write <save_dir>/<image_stem>.txt with the prediction string."""
    file_name = os.path.basename(img_path)[:-3] + "txt"
    os.makedirs(save_dir, exist_ok=True)
    save_path = os.path.join(save_dir, file_name)
    with open(save_path, "w") as f:
        f.write(pred_str)
    return save_path


def apolloscape_str(roll, pitch, yaw, x, y, z, score) -> str:
    """An ApolloScape submission line: pitch, yaw, roll, x, y, z and score
    at 3 decimals (the reference's format.py:11-23)."""
    return ("{pitch:.3f} {yaw:.3f} {roll:.3f} {x:.3f} {y:.3f} {z:.3f} "
            "{score:.3f}").format(pitch=pitch, yaw=yaw, roll=roll,
                                  x=x, y=y, z=z, score=score)


def generate_empty_files(output_dir: str, label_dir: str) -> int:
    """Write an empty ``<output_dir>/data/<name>.txt`` for every
    ``<label_dir>/<name>.txt`` that has no prediction file (a test-split
    submission needs one file per frame).  Returns how many it wrote."""
    data_dir = os.path.join(output_dir, "data")
    detected = set(os.listdir(data_dir)) if os.path.isdir(data_dir) else set()
    os.makedirs(data_dir, exist_ok=True)
    count = 0
    for file_name in os.listdir(label_dir):
        if not file_name.endswith(".txt"):
            continue
        if file_name not in detected:
            open(os.path.join(data_dir, file_name), "w").close()
            count += 1
    return count
