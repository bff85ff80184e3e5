"""The port's Python KITTI evaluator and PR plots
(``egonet_tpu_torch/eval/{kitti_eval,plots}.py``) against the JAX
package's (``egonet_tpu/eval/{kitti_eval,plots}.py``) on the same
synthetic ground-truth and detection directories: the same results, the
same R40 / R11 summaries, byte-equal stats files and the same figure
names."""

import os
import shutil

import numpy as np
import pytest

from egonet_tpu.eval import kitti_eval as jax_ke
from egonet_tpu.eval import plots as jax_plots
from egonet_tpu_torch.eval import kitti_eval as ke
from egonet_tpu_torch.eval import plots

CLASSES = {"car": ("Car", "Van"), "ped_cyc": ("Pedestrian", "Cyclist",
                                              "Person_sitting"),
           "all": ("Car", "Pedestrian", "Cyclist")}
DIMS = {"Car": (1.5, 1.6, 3.9), "Van": (2.0, 1.8, 4.5),
        "Pedestrian": (1.8, 0.6, 0.9), "Person_sitting": (1.2, 0.6, 0.9),
        "Cyclist": (1.7, 0.6, 1.8)}


def _line(cls, trunc, occ, alpha, box, dims, loc, ry, score=None):
    s = (f"{cls} {trunc:.2f} {occ} {alpha:.2f} "
         + " ".join(f"{v:.2f}" for v in (*box, *dims, *loc)) + f" {ry:.2f}")
    return s if score is None else s + f" {score:.4f}"


def _scenario(root, seed, classes, dontcare=False, trunc=False,
              n_frames=6):
    """Noisy detections of well-separated objects: misses, box / location
    / angle noise, false positives; optional DontCare regions and
    truncated ground truth.  Returns (gt_dir, result_dir)."""
    rng = np.random.RandomState(seed)
    gt_dir = os.path.join(root, "label_2")
    data_dir = os.path.join(root, "results", "data")
    os.makedirs(gt_dir)
    os.makedirs(data_dir)
    for f in range(n_frames):
        gts, dets = [], []
        for i in range(7):
            cls = CLASSES[classes][(i + f) % len(CLASSES[classes])]
            x = 10.0 + 170.0 * i
            box = (x, 100.0, x + rng.uniform(40, 120),
                   100.0 + rng.uniform(30, 90))
            loc = (-30.0 + 8.0 * i, 1.6, 12.0 + rng.uniform(0, 30))
            t = float(rng.choice([0.0, 0.1, 0.2, 0.4])) if trunc else 0.0
            occ, ry = int(rng.randint(0, 3)), rng.uniform(-3, 3)
            alpha = rng.uniform(-3, 3)
            gts.append(_line(cls, t, occ, alpha, box, DIMS[cls], loc, ry))
            if rng.rand() < 0.15:
                continue                               # a miss
            nb = tuple(v + rng.uniform(-8, 8) for v in box)
            nl = (loc[0] + rng.uniform(-0.5, 0.5), loc[1],
                  loc[2] + rng.uniform(-0.5, 0.5))
            dets.append(_line(cls, 0.0, 0, alpha + rng.uniform(-0.4, 0.4),
                              nb, DIMS[cls], nl, ry + rng.uniform(-0.3, 0.3),
                              rng.uniform(0.3, 1.0)))
        for _ in range(2):                             # false positives
            x = rng.uniform(0, 1100)
            cls = CLASSES[classes][0]
            dets.append(_line(cls, 0.0, 0, 0.5, (x, 20.0, x + 60, 70.0),
                              DIMS[cls], (rng.uniform(-30, 30), 1.6,
                                          rng.uniform(30, 60)), 0.1,
                              rng.uniform(0.3, 1.0)))
        if dontcare:
            x = rng.uniform(0, 1000)
            gts.append(_line("DontCare", -1, -1, -10, (x, 15.0, x + 90, 80.0),
                             (-1, -1, -1), (-1000, -1000, -1000), -10))
        with open(os.path.join(gt_dir, f"{f:06d}.txt"), "w") as fh:
            fh.write("\n".join(gts) + "\n")
        with open(os.path.join(data_dir, f"{f:06d}.txt"), "w") as fh:
            fh.write("\n".join(dets) + "\n")
    return gt_dir, os.path.join(root, "results")


SCENARIOS = [
    # (seed, classes, dontcare, truncation, server)
    (0, "car", False, False, False),
    (1, "car", True, False, False),
    (2, "ped_cyc", False, False, False),
    (3, "ped_cyc", True, True, False),
    (4, "all", True, False, False),
    (5, "all", False, True, False),
    (6, "car", False, True, False),
    (7, "all", True, False, True),
    (8, "ped_cyc", False, False, True),
]


def _both(tmp_path, seed, classes, dontcare, trunc):
    """The same scenario in two directories (each evaluator writes its
    stats files into its own)."""
    gt_dir, res = _scenario(str(tmp_path / "a"), seed, classes, dontcare,
                            trunc)
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    return gt_dir, res, str(tmp_path / "b" / "results")


@pytest.mark.parametrize("seed,classes,dontcare,trunc,server", SCENARIOS)
def test_evaluate_matches_jax(tmp_path, seed, classes, dontcare, trunc,
                              server):
    gt_dir, res_t, res_j = _both(tmp_path, seed, classes, dontcare, trunc)
    kw = {"server": True, "n_testimages": 6} if server else {}
    ours = ke.evaluate(gt_dir, res_t, **kw)
    theirs = jax_ke.evaluate(gt_dir, res_j, **kw)
    assert ours == theirs
    assert ours                               # something was evaluated
    for style in ("r40", "r11"):
        assert ke.format_summary(ours, style) == \
            jax_ke.format_summary(theirs, style)
    stats = sorted(f for f in os.listdir(res_t) if f.startswith("stats_"))
    assert stats == sorted(f for f in os.listdir(res_j)
                           if f.startswith("stats_"))
    for name in stats:
        with open(os.path.join(res_t, name), "rb") as a, \
                open(os.path.join(res_j, name), "rb") as b:
            assert a.read() == b.read(), name
        np.testing.assert_array_equal(
            plots.read_stats_file(os.path.join(res_t, name)),
            jax_plots.read_stats_file(os.path.join(res_j, name)))


def test_server_mode_requires_all_files(tmp_path):
    gt_dir, res = _scenario(str(tmp_path), 0, "car")
    with pytest.raises(FileNotFoundError):
        ke.evaluate(gt_dir, res, server=True, n_testimages=7)


def test_cli_matches_jax_cli(tmp_path, capsys):
    gt_dir, res_t, res_j = _both(tmp_path, 9, "all", True, False)
    assert jax_ke.main([gt_dir, res_j, "--plot"]) == 0
    theirs = capsys.readouterr().out
    assert ke.main([gt_dir, res_t, "--plot"]) == 0
    ours = capsys.readouterr().out
    assert ours.replace(res_t, "<res>") == theirs.replace(res_j, "<res>")
    assert "car_orientation AP:" in ours


def test_plot_file_names_match_jax(tmp_path):
    gt_dir, res_t, res_j = _both(tmp_path, 10, "all", False, False)
    ke.evaluate(gt_dir, res_t)
    jax_ke.evaluate(gt_dir, res_j)
    ours = plots.plot_pr_curves(res_t)
    theirs = jax_plots.plot_pr_curves(res_j)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    assert "car_orientation.png" in {os.path.basename(p) for p in ours}
    for p in ours:
        assert p.startswith(os.path.join(res_t, "plot"))
        assert os.path.getsize(p) > 1000


def test_read_stats_file_rejects_wrong_shape(tmp_path):
    path = tmp_path / "stats_car_detection.txt"
    path.write_text("0.5 0.5\n")
    with pytest.raises(ValueError):
        plots.read_stats_file(str(path))
