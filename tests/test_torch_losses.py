"""The port's training losses and keypoint ops (egonet_tpu_torch/train/
losses.py, ops/keypoints.py) against the JAX package's, in float64 on the
same seeded NumPy inputs: values, and the gradient with respect to the
prediction through torch.autograd against jax.grad, within 1e-10
(relative to the largest entry)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.ops import keypoints as jkp
from egonet_tpu.train import losses as jl
from egonet_tpu_torch.ops import keypoints as tkp
from egonet_tpu_torch.train import losses as tl

TOL = 1e-10
N, K, H, W = 4, 33, 16, 16


def _inputs(seed):
    rng = np.random.RandomState(seed)
    mask = np.array([1.0, 1.0, 0.0, 1.0])
    return {
        "maps": rng.randn(N, K, H, W),
        "target": rng.rand(N, K, H, W),
        "tw": (rng.rand(N, K) > 0.2).astype(np.float64),
        "coords": rng.rand(N, K, 2),
        "gt": rng.uniform(0, 64, (N, K, 2)),
        "mask": mask,
        "sup": mask * np.array([1.0, 0.0, 1.0, 1.0]),
        "vec": rng.randn(N, 12),
        "vec_t": rng.randn(N, 12),
    }


def _cfg(loss_weights=(1.0, 0.1, 0.01)):
    return {"heatmapModel": {"loss_spec_list": ["mse", "l1", "sl1"],
                             "loss_weight_list": list(loss_weights),
                             "cr_loss_threshold": 0.15,
                             "input_size": [64, 64]}}


# (name, input key that is differentiated, other keys, jax fn, torch fn)
CASES = {
    "masked_mean": (["vec"], ["mask"],
                    lambda v, m: jl.masked_mean(v, m[:, None]),
                    lambda v, m: tl.masked_mean(v, m[:, None])),
    "masked_mean_none": (["vec"], [], lambda v: jl.masked_mean(v, None),
                         lambda v: tl.masked_mean(v, None)),
    "heatmap_mse": (["maps"], ["target", "mask"], jl.heatmap_mse_loss,
                    tl.heatmap_mse_loss),
    "heatmap_mse_tw": (["maps"], ["target", "mask", "tw"],
                       jl.heatmap_mse_loss, tl.heatmap_mse_loss),
    "coordinate_l1": (["coords"], ["gt"],
                      lambda c, g: jl.coordinate_l1_loss(c, g, (64, 48)),
                      lambda c, g: tl.coordinate_l1_loss(c, g, (64, 48))),
    "coordinate_l1_mask": (
        ["coords"], ["gt", "mask"],
        lambda c, g, m: jl.coordinate_l1_loss(c, g, (64, 64), m),
        lambda c, g, m: tl.coordinate_l1_loss(c, g, (64, 64), m)),
    "smooth_l1": (["vec"], [], jl.smooth_l1, tl.smooth_l1),
    "cross_ratio": (["coords"], ["mask"],
                    lambda c, m: jl.cross_ratio_loss(c, mask=m),
                    lambda c, m: tl.cross_ratio_loss(c, mask=m)),
    "cross_ratio_threshold": (
        ["coords"], [],
        lambda c: jl.cross_ratio_loss(c, distance_threshold=0.05),
        lambda c: tl.cross_ratio_loss(c, distance_threshold=0.05)),
    "mse_1d": (["vec"], ["vec_t", "mask"], jl.mse_loss_1d, tl.mse_loss_1d),
    "smooth_l1_1d": (["vec"], ["vec_t", "mask"], jl.smooth_l1_loss_1d,
                     tl.smooth_l1_loss_1d),
    "decoupled_smooth_l1": (["vec"], ["vec_t", "mask"],
                            jl.decoupled_smooth_l1_loss,
                            tl.decoupled_smooth_l1_loss),
    "ohkm_mse": (["maps"], ["target", "tw"],
                 lambda p, t, w: jl.joints_ohkm_mse_loss(p, t, w, topk=8),
                 lambda p, t, w: tl.joints_ohkm_mse_loss(p, t, w, topk=8)),
    "ohkm_mse_mask": (
        ["maps"], ["target", "mask"],
        lambda p, t, m: jl.joints_ohkm_mse_loss(p, t, None, 5, m),
        lambda p, t, m: tl.joints_ohkm_mse_loss(p, t, None, 5, m)),
    "wing": (["maps"], ["gt", "mask"],
             lambda h, g, m: jl.wing_loss(h, g, image_size=(64, 64), mask=m),
             lambda h, g, m: tl.wing_loss(h, g, image_size=(64, 64), mask=m)),
    "soft_argmax": (["maps"], [],
                    lambda h: jnp.sum(jkp.soft_argmax(h)[0] ** 2),
                    lambda h: (tkp.soft_argmax(h)[0] ** 2).sum()),
    "cross_ratio_sq": (["coords"], [],
                       lambda c: jnp.sum(jkp.cross_ratio_sq(
                           c[:, 9:33].reshape(N, 6, 4, 2))),
                       lambda c: tkp.cross_ratio_sq(
                           c[:, 9:33].reshape(N, 6, 4, 2)).sum()),
}


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradient_match_jax(name, seed):
    diff_keys, other_keys, jfn, tfn = CASES[name]
    x = _inputs(seed)
    with jax.enable_x64(True):
        args = [jnp.asarray(x[k]) for k in diff_keys + other_keys]
        jval, jgrad = jax.value_and_grad(
            lambda a, *rest: jnp.sum(jfn(a, *rest)))(*args)
        jval, jgrad = float(jval), np.asarray(jgrad)
    targs = [torch.tensor(x[k], dtype=torch.float64)
             for k in diff_keys + other_keys]
    targs[0].requires_grad_(True)
    tval = tfn(*targs).sum()
    tval.backward()
    _close(float(tval.detach()), jval, f"{name} value")
    _close(targs[0].grad.numpy(), jgrad, f"{name} gradient")


@pytest.mark.parametrize("apply_cr", [False, True])
@pytest.mark.parametrize("weights", [(1.0, 0.1, 0.01), (1.0, 0.1, "None"),
                                     ("None", 1.0, 0.5)])
def test_composite_loss_matches_jax(apply_cr, weights):
    """Total, each component, and the gradients with respect to both
    outputs, with target weights, the padding mask and sup_mask."""
    x = _inputs(3)
    spec = ["mse" if weights[0] != "None" else "None", "l1", "sl1"]
    cfg = _cfg(weights)
    cfg["heatmapModel"]["loss_spec_list"] = spec
    with jax.enable_x64(True):
        jcfg = jl.CompositeLossConfig(cfg)

        def jfn(maps, coords):
            return jl.composite_loss(
                (maps, coords), jnp.asarray(x["target"]),
                jnp.asarray(x["gt"]), jcfg, mask=jnp.asarray(x["mask"]),
                target_weight=jnp.asarray(x["tw"]), apply_cr=apply_cr,
                sup_mask=jnp.asarray(x["sup"]))

        (jtot, jcomps), jgrads = jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x["maps"]), jnp.asarray(x["coords"]))
    maps = torch.tensor(x["maps"], requires_grad=True)
    coords = torch.tensor(x["coords"], requires_grad=True)
    ttot, tcomps = tl.composite_loss(
        (maps, coords), torch.tensor(x["target"]), torch.tensor(x["gt"]),
        tl.CompositeLossConfig(cfg), mask=torch.tensor(x["mask"]),
        target_weight=torch.tensor(x["tw"]), apply_cr=apply_cr,
        sup_mask=torch.tensor(x["sup"]))
    ttot.backward()
    assert sorted(tcomps) == sorted(jcomps)
    _close(float(ttot.detach()), float(jtot), "total")
    for k in jcomps:
        _close(float(tcomps[k].detach()), float(jcomps[k]), k)
    for t, j, what in ((maps, jgrads[0], "d maps"),
                       (coords, jgrads[1], "d coords")):
        if float(np.abs(np.asarray(j)).max()) == 0.0:
            assert t.grad is None or float(t.grad.abs().max()) == 0.0
        else:
            _close(t.grad.numpy(), j, what)


@pytest.mark.parametrize("fn", ["soft_argmax", "soft_argmax_sumnorm",
                                "hard_argmax"])
def test_argmax_decoders_match_jax(fn):
    x = _inputs(4)["maps"]
    x[0, 0] = -np.abs(x[0, 0])             # a map whose max is <= 0
    with jax.enable_x64(True):
        jc, jm = getattr(jkp, fn)(jnp.asarray(x))
        jc, jm = np.asarray(jc), np.asarray(jm)
    tc, tm = getattr(tkp, fn)(torch.tensor(x))
    _close(tc.numpy(), jc, f"{fn} coords")
    _close(tm.numpy(), jm, f"{fn} maxvals")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_gaussian_targets_match_jax(dtype, sigma):
    """Quantized centers (truncation toward zero for slightly negative
    coordinates), the 3-sigma cut, and zero weight for joints whose box
    misses the map."""
    rng = np.random.RandomState(5)
    joints = rng.uniform(-12, 76, (N, K, 2)).astype(dtype)
    joints[0, :3] = [[-1.5, 3.0], [70.0, 70.0], [-0.3, -0.3]]
    vis = (rng.rand(N, K) > 0.1).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jt, jw = jkp.gaussian_targets(jnp.asarray(joints), jnp.asarray(vis),
                                      (H, W), (64, 64), sigma)
        jt, jw = np.asarray(jt), np.asarray(jw)
    tt, tw = tkp.gaussian_targets(torch.from_numpy(joints),
                                  torch.from_numpy(vis), (H, W), (64, 64),
                                  sigma)
    assert tt.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tw.numpy(), jw)
    tol = TOL if dtype == "float64" else 1e-6
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=tol)
