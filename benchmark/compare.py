"""The comparison that decides ``correct``: the program's answers for a
seeded sample of the crops it finished in the window against the plain
reference's (``reference/egonet_ref.py``) for the same frames and boxes.

Readings, per sample (the numbers a configuration's ``limits`` name are
compared, each against its limit; the others are printed alone):

  missing           answers due that never came, came with another
                    number of crops than boxes, or hold a value that is
                    not finite
  kpts_2d           the widest gap of a screen keypoint, as a share of
                    its crop's source width
  kpts_3d_m         the widest gap of a lifted cuboid point, in metres
  ry_deg            the widest gap of the yaw (KITTI rot_y), in degrees
  alpha_deg         the widest gap of the observation angle alpha
  <name>_median     the median over crops of each crop's widest gap
"""

from __future__ import annotations

import sys

import numpy as np


def _angle_gap_deg(a, b):
    d = np.mod(np.asarray(a, np.float64) - np.asarray(b, np.float64)
               + np.pi, 2 * np.pi) - np.pi
    return np.degrees(np.abs(d))


def gaps(port: dict, ref: dict, missing: int) -> dict:
    """Port answers ({'kpts_2d' [N, K, 2], 'kpts_3d' [N, P, 3], 'euler'
    [N, 3], 'alpha' [N]}) against the reference's (the same keys and
    'crop_w' [N])."""
    per_crop = {
        "kpts_2d": np.abs(port["kpts_2d"] - ref["kpts_2d"]).max(axis=(1, 2))
        / ref["crop_w"],
        "kpts_3d_m": np.abs(port["kpts_3d"] - ref["kpts_3d"]).max(axis=(1, 2)),
        "ry_deg": _angle_gap_deg(port["euler"][:, 1], ref["euler"][:, 1]),
        "alpha_deg": _angle_gap_deg(port["alpha"], ref["alpha"]),
    }
    out = {"missing": float(missing)}
    for name, v in per_crop.items():
        out[name] = float(np.max(v))
        out[name + "_median"] = float(np.median(v))
    return out


def finite(*arrays) -> bool:
    return all(np.all(np.isfinite(np.asarray(a, np.float64)))
               for a in arrays)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {'value', 'limit'}} for every limited number).
    Prints the readings without a limit on standard error, then each
    number compared beside its limit; ``missing`` is always compared
    (limit 0), and a limited number that was not read fails."""
    limits = dict(limits, missing=limits.get("missing", 0))
    for name, v in values.items():
        if name not in limits:
            print(f"reading {name} {v} (no limit)", file=sys.stderr)
    out, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        ok &= bool(v is not None and np.isfinite(v) and v <= lim)
        out[name] = {"value": v, "limit": lim}
    for name, row in out.items():
        print(f"compared {name} {row['value']} limit {row['limit']}",
              file=sys.stderr, flush=True)
    return ok, out
