"""The port's validation metrics and 3D transformations (egonet_tpu_torch/
train/metrics.py, common/transformation.py) against the JAX package's on
the same seeded inputs: equal to the last bit or within 1e-12."""

import numpy as np
import pytest

from egonet_tpu.common import transformation as jtr
from egonet_tpu.train import metrics as jm
from egonet_tpu_torch.common import transformation as ttr
from egonet_tpu_torch.train import metrics as tm


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def _meta(rng, n, k=33):
    return {"center": rng.uniform(100, 600, (n, 2)),
            "scale": rng.uniform(0.5, 2.0, (n, 2)),
            "original_joints": rng.uniform(0, 600, (n, k, 2))}


def _cfgs(out=96):
    return {"heatmapModel": {"input_size": [64, 64], "num_joints": 33},
            "FCModel": {"output_size": out},
            "metrics": {"R3D": {"T_style": "direct", "R_style": "euler"},
                        "JD3D": {"style": "procrustes"},
                        "RTError3D": {"T_style": "direct"}}}


@pytest.mark.parametrize("names,out", [
    (["RError3D"], 96), (["RTError3D"], 99),
    (["JointDistance3D", "RotationError3D"], 96)])
def test_3d_metrics_match_jax(names, out):
    rng = np.random.RandomState(0)
    gt = rng.randn(2, 7, out)
    pred = [g + 0.1 * rng.randn(*g.shape) for g in gt]
    ev_j = jm.Evaluator(names, cfgs=_cfgs(out), num_joints=33)
    ev_t = tm.Evaluator(names, cfgs=_cfgs(out), num_joints=33)
    for p, g in zip(pred, gt):
        ev_j.update(p, ground_truth=g)
        ev_t.update(p, ground_truth=g)
    lj, lt = _Log(), _Log()
    ev_j.report(lj)
    ev_t.report(lt)
    assert lt.lines == lj.lines


def test_joint_distance_2d_sip_matches_jax():
    rng = np.random.RandomState(1)
    ev_j = jm.Evaluator(["JointDistance2DSIP"], cfgs=_cfgs(), num_joints=33)
    ev_t = tm.Evaluator(["JointDistance2DSIP"], cfgs=_cfgs(), num_joints=33)
    for n in (3, 5):
        meta = _meta(rng, n)
        pred = (rng.randn(n, 33, 16, 16), rng.rand(n, 33, 2))
        ev_j.update(pred, meta_data=meta)
        ev_t.update(pred, meta_data=meta)
    mj, mt = ev_j.metrics[0], ev_t.metrics[0]
    assert mt.mean == mj.mean and mt.count == mj.count
    np.testing.assert_array_equal(mt.PCK_counts, mj.PCK_counts)


def test_angle_error_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(9, 2)
    meta = {"angles_gt": rng.uniform(-np.pi, np.pi, 9)}
    a, b = jm.AngleError(), tm.AngleError()
    a.update(pred, meta_data=meta)
    b.update(pred, meta_data=meta)
    assert a.mean == b.mean and a.count == b.count


@pytest.mark.parametrize("arg_max", ["hard", "soft"])
def test_pixel_accuracy_matches_jax(arg_max):
    rng = np.random.RandomState(3)
    maps = rng.rand(4, 33, 16, 16).astype(np.float32)
    meta = _meta(rng, 4)
    j = jm.pixel_accuracy(maps, meta, (64.0, 64.0), arg_max)
    t = tm.pixel_accuracy(maps, meta, (64.0, 64.0), arg_max)
    # the decoders run in float32 in both packages: the soft one sums in
    # another order
    tol = 1e-12 if arg_max == "hard" else 1e-6
    assert abs(t[0] - j[0]) <= tol * abs(j[0]) and t[1] == j[1]
    for k in ("src_coord", "joints_pred", "max_vals"):
        np.testing.assert_allclose(t[2][k], j[2][k], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("weights", [None, "vector", "matrix"])
def test_rigid_transform_matches_jax(weights):
    rng = np.random.RandomState(4)
    X = rng.randn(3, 12)
    Y = rng.randn(3, 12)
    W = {None: None, "vector": rng.rand(12),
         "matrix": np.diag(rng.rand(12))}[weights]
    for a, b in zip(ttr.compute_rigid_transform(X, Y, W),
                    jtr.compute_rigid_transform(X, Y, W)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttr.procrustes_transform(X, Y),
                                  jtr.procrustes_transform(X, Y))


@pytest.mark.parametrize("scale", [False, True])
def test_similarity_transform_matches_jax(scale):
    rng = np.random.RandomState(5)
    X, Y = rng.randn(32, 3), rng.randn(32, 3)
    for a, b in zip(ttr.compute_similarity_transform(X, Y, scale),
                    jtr.compute_similarity_transform(X, Y, scale)):
        np.testing.assert_array_equal(a, b)


def test_frame_conversions_match_jax():
    rng = np.random.RandomState(6)
    P, R, T = rng.randn(10, 3), rng.randn(3, 3), rng.randn(3, 1)
    np.testing.assert_array_equal(ttr.world_to_camera_frame(P, R, T),
                                  jtr.world_to_camera_frame(P, R, T))
    np.testing.assert_array_equal(ttr.camera_to_world_frame(P, R, T),
                                  jtr.camera_to_world_frame(P, R, T))
