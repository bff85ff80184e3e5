"""Whole-pipeline differential: the port's inference CLI
(``egonet_tpu_torch.tools.inference.main``) against the JAX package's
(``tools/inference.py``) on one synthetic KITTI fixture.

Both CLIs read the same frames, labels, calibrations and detector txts,
build the shrunk HRNet config in fp32 with ``pre_trained: false`` (the two
packages draw the same initial weights, see tests/test_torch_models.py) and
write ``gt_box_test/`` and ``submission/`` txts.  Every field other than
alpha and rot_y must be byte-equal; alpha and rot_y agree within
``ANGLE_TOL``.  The JAX CLI runs its device program under ``jit``, whose
CPU warp differs from its own eager warp (ROADMAP, faults found); the port
reproduces the eager functions, which ``test_one_frame_matches_jax_eager``
holds to 1e-4 rad.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from egonet_tpu.config import default_demo_config
from egonet_tpu_torch.config import demo_config
from tests import fixtures

torch.set_num_threads(1)

ALPHA_FIELD, RY_FIELD = 3, 14
ANGLE_TOL = 1e-3


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_inference",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "inference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(cfg, root, pred_dir, out):
    cfg = fixtures.shrink_hrnet(cfg)
    cfg["dataset"]["root"] = root
    cfg["dirs"] = {"output": out, "ckpt": out + "_ckpt",
                   "load_prediction_file": pred_dir}
    cfg["pre_trained"] = False
    cfg["bf16"] = False
    cfg["testing_settings"]["batch_size"] = 2   # both val frames in one batch
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    # 4 frames -> the valid split holds 2
    root, pred_dir = fixtures.make_kitti_root(tmp, n_images=4,
                                              with_predictions=True,
                                              smooth=True)
    jcfg = _setup(default_demo_config(), root, pred_dir, str(tmp / "out_jax"))
    cfg_path = str(tmp / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({k: v for k, v in jcfg.items() if k != "config_path"},
                       f)
    _jax_cli().main(["--cfg", cfg_path])

    from egonet_tpu_torch.tools import inference
    tcfg = _setup(demo_config(), root, pred_dir, str(tmp / "out_torch"))
    tcfg["device"] = "cpu"
    summary = inference.main(cfgs=tcfg)
    return {"root": root, "pred_dir": pred_dir, "jax": str(tmp / "out_jax"),
            "torch": str(tmp / "out_torch"), "cfg": tcfg, "summary": summary}


def _angdiff(a, b):
    d = abs(a - b) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


@pytest.mark.parametrize("path", ["gt_box_test", "submission"])
def test_txts_match_jax_cli(world, path):
    dj = os.path.join(world["jax"], path, "data")
    dt = os.path.join(world["torch"], path, "data")
    names = sorted(os.listdir(dj))
    assert names and names == sorted(os.listdir(dt))
    worst = 0.0
    for name in names:
        with open(os.path.join(dj, name)) as f:
            lj = f.read().split("\n")
        with open(os.path.join(dt, name)) as f:
            lt = f.read().split("\n")
        assert len(lj) == len(lt), name
        for a, b in zip(lj, lt):
            fa, fb = a.split(" "), b.split(" ")
            assert len(fa) == len(fb) == 17, (a, b)
            for i, (x, y) in enumerate(zip(fa, fb)):
                if i in (ALPHA_FIELD, RY_FIELD):
                    worst = max(worst, _angdiff(float(x), float(y)))
                else:
                    assert x == y, (name, i, x, y)
    print(f"{path}: max |d angle| vs the JAX CLI = {worst:.3g} rad")
    assert worst < ANGLE_TOL


def test_submission_fields_copy_detector_lines(world):
    """Every submission line keeps the detector line's fields (only alpha
    and rot_y are rewritten), and every detection gets a line."""
    sub = os.path.join(world["torch"], "submission", "data")
    for name in sorted(os.listdir(sub)):
        with open(os.path.join(world["pred_dir"], name)) as f:
            n_det = len([ln for ln in f.read().split("\n") if ln.strip()])
        with open(os.path.join(sub, name)) as f:
            lines = f.read().split("\n")
        assert len(lines) == n_det
        for ln in lines:
            vals = ln.split(" ")
            assert len(vals) == 17 and vals[-1] == ""
            assert np.isfinite([float(vals[ALPHA_FIELD]),
                                float(vals[RY_FIELD])]).all()


def test_cli_reports_decoder_and_evaluation(world):
    stats = world["summary"]["image_store"]
    assert stats["decoder"] in ("cv2", "png")
    # 2 val frames, each decoded once and read again by the second path
    assert stats["decodes"] == 2 and stats["ram_hits"] == 2
    from egonet_tpu_torch.eval.native import ensure_evaluator
    if ensure_evaluator() is not None:
        assert "AP" in world["summary"]["evaluation"]


def test_one_frame_matches_jax_eager(world):
    """The port's facade against the JAX facade run eagerly, on one frame
    of the fixture as the port's reader and CLI assemble it: angles within
    1e-4 rad."""
    from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.tools.inference import gather_dict
    cfg = world["cfg"]
    ds = kitti.get_dataset(cfg, None, "valid")
    name = ds.image_names[0]
    preds = ds.read_predictions(world["pred_dir"])
    annot = gather_dict({"path": [ds.paths.image_path(name)]}, preds,
                        target_ar=1.0, enlarge=1.2)
    jcfg = dict(cfg)
    jcfg.pop("device")
    j = JaxEgoNet(jcfg, dtype=jnp.float32)
    j._get_jitted = lambda alpha_mode, packed=False: functools.partial(
        j._core_packed if packed else j._core, alpha_mode=alpha_mode)
    t = EgoNet(cfg, device="cpu")
    rj = j.forward_annot_dict(annot, enlarge=1.1)
    rt = t.forward_annot_dict(annot, enlarge=1.1)
    for p in rj:
        d = np.abs(np.asarray(rj[p]["euler_angles"], np.float64)
                   - rt[p]["euler_angles"]) % (2 * np.pi)
        assert np.minimum(d, 2 * np.pi - d).max() < 1e-4


def test_visualize_and_cpu_fallback_raise(world, monkeypatch):
    """--visualize runs (tests/test_torch_refine_vis.py checks its PNGs);
    where matplotlib is missing it raises an ImportError naming it.  A
    config without a device raises without CUDA."""
    import sys
    from egonet_tpu_torch.tools import inference
    cfg = dict(world["cfg"], visualize=True, batch_to_show=1)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            inference.main(cfgs=cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(world["cfg"])
    cfg.pop("device")
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(cfgs=cfg)


@pytest.fixture(scope="module")
def python_eval(world, tmp_path_factory):
    """Both CLIs again with the C++ evaluator unavailable, so each scores
    with its own package's Python evaluator.  Returns what each printed,
    the port's summary and output directory."""
    import contextlib
    import io
    from egonet_tpu.eval import native as jax_native
    from egonet_tpu_torch.eval import native
    from egonet_tpu_torch.tools import inference
    tmp = tmp_path_factory.mktemp("python_eval")
    jcfg = _setup(default_demo_config(), world["root"], world["pred_dir"],
                  str(tmp / "out_jax"))
    cfg_path = str(tmp / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({k: v for k, v in jcfg.items() if k != "config_path"},
                       f)
    tcfg = _setup(demo_config(), world["root"], world["pred_dir"],
                  str(tmp / "out_torch"))
    tcfg["device"] = "cpu"
    printed = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "ensure_evaluator", lambda quiet=True: None)
        mp.setattr(native, "ensure_evaluator", lambda quiet=True: None)
        for name, run in (("jax", lambda: _jax_cli().main(["--cfg",
                                                            cfg_path])),
                          ("torch", lambda: inference.main(cfgs=tcfg))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result = run()
            printed[name] = buf.getvalue()
    return {"printed": printed, "summary": result,
            "out": str(tmp / "out_torch"),
            "labels": os.path.join(world["root"], "training", "label_2")}


def _ap_lines(text):
    return [ln for ln in text.splitlines() if " AP: " in ln]


def test_cli_scores_with_python_evaluator_without_binary(python_eval):
    """The port's CLI prints the R40 and R11 summaries of the Python
    evaluator over its own submission, as the JAX CLI's fallback does."""
    from egonet_tpu.eval import kitti_eval as jax_ke
    summary = python_eval["summary"]
    assert summary["evaluator"] == "python"
    results = jax_ke.evaluate(python_eval["labels"],
                              os.path.join(python_eval["out"], "submission"),
                              write_stats=False)
    want = (jax_ke.format_summary(results, "r40") + "\n"
            + jax_ke.format_summary(results, "r11"))
    assert summary["evaluation"] == want
    assert want in python_eval["printed"]["torch"]


def test_cli_summary_matches_jax_cli_fallback(python_eval):
    """The same summary lines as the JAX CLI's Python fallback: detection
    lines equal, orientation lines within the angle gap of the two CLIs
    (the JAX CLI runs its program under jit, ANGLE_TOL)."""
    ours = _ap_lines(python_eval["printed"]["torch"])
    theirs = _ap_lines(python_eval["printed"]["jax"])
    assert ours and len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        la, va = a.split(" AP: ")
        lb, vb = b.split(" AP: ")
        assert la == lb
        if "orientation" in la:
            np.testing.assert_allclose(np.float64(va.split()),
                                       np.float64(vb.split()), atol=0.05)
        else:
            assert va == vb, (a, b)


def test_cli_writes_pr_plots(python_eval):
    """PR-curve PNGs land in <submission>/plot, one per stats file (or the
    CLI says matplotlib is missing)."""
    plots = python_eval["summary"]["plots"]
    sub = os.path.join(python_eval["out"], "submission")
    stats = sorted(f[len("stats_"):-len(".txt")] for f in os.listdir(sub)
                   if f.startswith("stats_"))
    if plots is None:
        assert ("PR plots not written: matplotlib is not installed"
                in python_eval["printed"]["torch"])
        return
    assert stats and sorted(os.path.basename(p)[:-4] for p in plots) == stats
    for p in plots:
        assert os.path.dirname(p) == os.path.join(sub, "plot")


class _NullLogger:
    def info(self, msg):
        pass


def test_cli_without_matplotlib_says_so(tmp_path, monkeypatch, capsys):
    import importlib.util
    from egonet_tpu_torch.tools import inference
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    assert inference.write_plots(str(tmp_path), _NullLogger()) is None
    assert "PR plots not written: matplotlib is not installed" in \
        capsys.readouterr().out
