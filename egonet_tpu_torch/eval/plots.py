"""Precision-recall curve artifacts from evaluator stats files (a copy of
``egonet_tpu/eval/plots.py``; matplotlib is imported only when a figure is
drawn).

The reference evaluator emits per-class/per-metric PR figures through
gnuplot scripts + ps2pdf
(the reference's tools/kitti-eval/evaluate_object_3d_offline_r40.cpp:708-776).
This module stands in for them: it reads the ``stats_<class>_*.txt``
files either evaluator variant writes (one precision row per difficulty,
41 recall sample points) and renders matplotlib PNGs into
``<result_dir>/plot/``.

Styling: one axis pair, thin 2px lines, recessive grid, a legend plus
per-series line styles so difficulty identity never rides on color alone
(Okabe-Ito colorblind-safe hues).
"""

from __future__ import annotations

import os

import numpy as np

N_SAMPLE_PTS = 41

# (label, CVD-safe color, linestyle): solid/dashed/dotted doubles as the
# identity channel for colorblind/print readers
_SERIES = (("Easy", "#0072B2", "-"),
           ("Moderate", "#E69F00", "--"),
           ("Hard", "#009E73", ":"))

_TITLES = {
    "detection": "2D detection (AP)",
    "detection_ground": "Birds-eye view (AP_BEV)",
    "detection_3d": "3D detection (AP_3D)",
    "orientation": "Orientation similarity (AOS)",
}


def read_stats_file(path: str) -> np.ndarray:
    """Parse one stats_* file -> [3, 41] (difficulty x recall samples)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64)
    if arr.shape != (3, N_SAMPLE_PTS):
        raise ValueError(f"{path}: expected 3x{N_SAMPLE_PTS} stats rows, "
                         f"got {arr.shape}")
    return arr


def plot_stats_file(stats_path: str, out_path: str) -> str:
    """Render one PR/AOS figure (3 difficulty curves) to a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = read_stats_file(stats_path)
    recall = np.linspace(0.0, 1.0, N_SAMPLE_PTS)

    name = os.path.basename(stats_path)[len("stats_"):-len(".txt")]
    cls, _, suffix = name.partition("_")

    fig, ax = plt.subplots(figsize=(5.0, 4.0), dpi=120)
    for row, (label, color, style) in zip(curves, _SERIES):
        ax.plot(recall, row, style, color=color, linewidth=2, label=label)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Orientation similarity" if suffix == "orientation"
                  else "Precision")
    ax.set_title(f"{cls.capitalize()} — {_TITLES.get(suffix, suffix)}")
    ax.grid(True, color="#dddddd", linewidth=0.6)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    ax.legend(frameon=False, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_pr_curves(result_dir: str, out_dir: str | None = None) -> list:
    """Render every stats_* file under ``result_dir`` into PNGs
    (default ``<result_dir>/plot/<class>_<suffix>.png``, mirroring the
    reference's plot directory).  Returns the written paths."""
    out_dir = out_dir or os.path.join(result_dir, "plot")
    written = []
    stats = sorted(f for f in os.listdir(result_dir)
                   if f.startswith("stats_") and f.endswith(".txt"))
    if stats:
        os.makedirs(out_dir, exist_ok=True)
    for fname in stats:
        stem = fname[len("stats_"):-len(".txt")]
        out = os.path.join(out_dir, f"{stem}.png")
        written.append(plot_stats_file(os.path.join(result_dir, fname), out))
    return written


def main(argv=None):
    import sys
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        print("Usage: python -m egonet_tpu_torch.eval.plots <result_dir>")
        return 1
    for path in plot_pr_curves(args[0]):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
