"""The port's precision harness (``egonet_tpu_torch/precision.py``) against
the JAX package's (``egonet_tpu/precision.py``), and the port's full-width
W48 forward against the committed JAX fixture.

``tests/data/torch_w48_fixture.npz`` holds the JAX package's fp32 outputs
of the harness at the shipped W48 width (48/96/192/384, 256x256 input,
66 -> 1024 -> 96 lifter) for seeds 0 and 1, 6 instances each: screen
keypoints, the lifter output, the euler angles and alpha, and two
well-conditioned outputs of the trunk: the coordinate head's logits and
each heatmap's RMS.  The inputs and
the weights are redrawn from the seed (``models/init.py`` draws the JAX
package's initial weights value for value), so the file holds no input.
The JAX side runs ``EgoNet._core`` eagerly: under ``jit`` the CPU backend's
warp differs from its own eager warp (ROADMAP, faults found).  The slow
test ``test_regenerate_fixture`` rebuilds the fixture (about a minute on
the CPU) and compares it with the committed file; ``python -m
tests.test_torch_precision`` writes it anew.  The port-side checks need no
jax: only the generator and the checks against the JAX package import it.
"""

import os

import numpy as np
import pytest
import torch

from egonet_tpu_torch import precision
from egonet_tpu_torch.config import demo_config
from tests import fixtures

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_w48_fixture.npz")
SEEDS = (0, 1)
N = 6
KEYS = ("kpts", "lifter", "euler", "alpha", "logits", "maps_rms")
# fp32 on the CPU, port against eager JAX, full width.  With seeded random
# weights and identity BN statistics the activations grow through the 104
# residual blocks (logits of |x| ~ 300, heatmap RMS ~ 600), and 93% of the
# head's sigmoid outputs saturate at exactly 0 or 1 (gap 0).  The others
# come from logits that cancel large terms, so summation order alone moves
# them.  The port's network run in fp64 is the yardstick
# (test_fp32_rounding_against_fp64; its last sigmoid runs in fp32, worth
# < 1e-4 px): the JAX fp32 fixture lies up to 0.0095 (seed 0) and 0.041
# (seed 1) px from it, so no fp32 forward can be held to the fixture closer
# than that; the port's fp32 (oneDNN) lies up to 0.021 and 0.050 px from
# it.  Port fp32 against JAX observed max 0.026 (seed 0) and 0.059 (seed 1)
# px, median 0; the angles and the lifter output, downstream of those few
# points, agree to 2.4e-7 rad and 6e-6.
FP32_ROUNDING_PX = 0.075
KPTS_TOL_PX, KPTS_MEDIAN_TOL_PX, ANGLE_TOL_RAD = 0.1, 1e-3, 1e-3
# The trunk, well conditioned: port fp32 against JAX, relative L2 gap per
# instance, observed max 2.8e-6 (logits) and 1.6e-6 (heatmap RMS); either
# fp32 forward against the fp64 one up to 4.9e-6.  A planted fault in one
# C=192 block (test_planted_fault_fails_the_bars) moves the logits by
# 9.3e-5 (one BN bias +0.01) to 4.6e-3 (two channels swapped).
REL_TOL = 2e-5


def _shrunk():
    return fixtures.shrink_hrnet(demo_config())


class _JaxHeadCapture:
    """Stands in for the JAX EgoNet's ``hrnet`` module: runs its ``apply``
    with the coordinate head's last conv (``layer``, the sigmoid's input:
    "head2.4" in the HRNet) captured, and keeps that and the heatmaps."""

    def __init__(self, net, layer="head2.4"):
        self.net, self.layer, self.got = net, layer, {}

    def apply(self, variables, crops, **kwargs):
        (maps, coords), state = self.net.apply(
            variables, crops, capture_intermediates=(
                lambda mdl, _method: mdl.name == self.layer),
            mutable=["intermediates"], **kwargs)
        self.got = {"maps": maps,
                    "logits": state["intermediates"][self.layer][
                        "__call__"][0]}
        return maps, coords


def _jax_outputs(seed, n=N, cfgs=None, logits_layer="head2.4"):
    """The JAX harness's fp32 device program run eagerly -> the port's
    ``harness_outputs`` dict (``logits_layer``: the coordinate head's last
    conv)."""
    import jax.numpy as jnp
    from egonet_tpu.config import default_demo_config
    from egonet_tpu.models.egonet import EgoNet, pack_meta
    from egonet_tpu.ops import affine
    from egonet_tpu.precision import _plausible_ls_stats
    cfgs = cfgs or default_demo_config()
    images, boxes = precision.harness_inputs(n, seed)
    model = EgoNet(cfgs, pre_trained=False, dtype=jnp.float32, rng_seed=seed)
    model.hrnet = head = _JaxHeadCapture(model.hrnet, logits_layer)
    width, height = model.resolution
    mats = affine.crop_matrices_for_boxes(boxes, (height, width),
                                          height / width, 1.1)
    ls = {k: jnp.asarray(v) for k, v in _plausible_ls_stats().items()}
    meta = pack_meta(mats["inv"], np.zeros(n), np.ones(n), 707.0, 604.0,
                     (images.shape[2], images.shape[1]))
    flat = np.asarray(model._core(model.hrnet_vars, model.lifter_vars, ls,
                                  jnp.asarray(images), jnp.asarray(meta),
                                  alpha_mode="proj"), np.float64)
    k2 = int(cfgs["heatmapModel"]["num_joints"]) * 2
    od = int(cfgs["FCModel"]["output_size"])
    maps = np.asarray(head.got["maps"], np.float64)
    return {"kpts": flat[:, :k2].reshape(n, -1, 2),
            "lifter": flat[:, k2:k2 + od],
            "euler": flat[:, k2 + od:k2 + od + 3],
            "alpha": flat[:, -2],
            "logits": np.asarray(head.got["logits"],
                                 np.float64).reshape(n, k2),
            "maps_rms": np.sqrt((maps ** 2).mean(axis=(2, 3)))}


def generate_fixture(path=FIXTURE):
    """Write the full-width JAX fixture (float32, as the JAX program
    returns it)."""
    outs = [_jax_outputs(s) for s in SEEDS]
    np.savez_compressed(
        path, seeds=np.asarray(SEEDS), n_instances=np.asarray(N),
        widths=np.asarray([48, 96, 192, 384]),
        input_size=np.asarray([256, 256]),
        **{k: np.stack([o[k] for o in outs]).astype(np.float32)
           for k in KEYS})


def _fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _seed_slice(fix, i):
    return {k: fix[k][i].astype(np.float64) for k in KEYS}


def test_plausible_ls_stats_equal_jax():
    from egonet_tpu.precision import _plausible_ls_stats as jax_stats
    ours, theirs = precision._plausible_ls_stats(), jax_stats()
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_fixture_layout():
    fix = _fixture()
    assert list(fix["seeds"]) == list(SEEDS) and int(fix["n_instances"]) == N
    assert list(fix["widths"]) == [48, 96, 192, 384]
    assert fix["kpts"].shape == (2, N, 33, 2)
    assert fix["lifter"].shape == (2, N, 96)
    assert fix["euler"].shape == (2, N, 3)
    assert fix["alpha"].shape == (2, N)
    assert fix["logits"].shape == (2, N, 66)
    assert fix["maps_rms"].shape == (2, N, 33)
    for k in KEYS:
        assert np.isfinite(fix[k]).all(), k
    assert os.path.getsize(FIXTURE) < 32 * 1024


@pytest.fixture(scope="module")
def fullwidth_fp32():
    """The port's fp32 full-width W48 on the CPU at both fixture seeds."""
    torch.set_num_threads(2)
    return [precision.harness_outputs(
        precision.harness_model(torch.float32, s, device="cpu"), N, s)
        for s in SEEDS]


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_fullwidth_w48_fp32_matches_fixture(fullwidth_fp32, i):
    """The 104-block, 48/96/192/384 network against the JAX package's:
    the head's logits and the heatmaps' RMS within REL_TOL, kpts within
    KPTS_TOL_PX (median 1e-3), ry and alpha within 1e-3 rad."""
    out, ref = fullwidth_fp32[i], _seed_slice(_fixture(), i)
    gaps = precision.fixture_gaps(out, ref)
    print(f"seed {SEEDS[i]}: {gaps}")
    assert gaps["max_rel_d_logits"] <= REL_TOL, gaps
    assert gaps["max_rel_d_maps_rms"] <= REL_TOL, gaps
    assert gaps["max_d_kpts_px"] <= KPTS_TOL_PX, gaps
    assert gaps["median_d_kpts_px"] <= KPTS_MEDIAN_TOL_PX, gaps
    assert np.radians(gaps["max_d_ry_deg"]) <= ANGLE_TOL_RAD, gaps
    assert np.radians(gaps["max_d_alpha_deg"]) <= ANGLE_TOL_RAD, gaps
    np.testing.assert_allclose(out["lifter"], ref["lifter"], atol=1e-3)


# one BasicBlock of the C=192 branch (stage 3), and faults planted in it
FAULT_BLOCK = "stage3.0.branches.2.1"
FAULTS = {"swap_conv1_channels": lambda b: b.conv1.weight.data.index_copy_(
              0, torch.tensor([3, 7]), b.conv1.weight.data[[7, 3]]),
          "bn2_bias_+0.1": lambda b: b.bn2.bias.data[5].add_(0.1),
          "bn2_bias_+0.01": lambda b: b.bn2.bias.data[5].add_(0.01)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_bars(fault):
    """A wrong full-width network fails the fixture's bars: a fault planted
    in one of the 104 blocks moves the logits past REL_TOL and the kpts past
    KPTS_TOL_PX (observed for seed 0: 12 / 10 / 1.1 px and 4.6e-3 / 8.7e-4
    / 9.3e-5; the angles move by at most 0.0025 degrees, under their
    bar)."""
    torch.set_num_threads(2)
    model = precision.harness_model(torch.float32, SEEDS[0], device="cpu")
    FAULTS[fault](model.hrnet.get_submodule(FAULT_BLOCK))
    model.hrnet.prepare_inference()          # fold the faulted weights
    gaps = precision.fixture_gaps(
        precision.harness_outputs(model, N, SEEDS[0]),
        _seed_slice(_fixture(), 0))
    print(f"{fault}: {gaps}")
    assert gaps["max_rel_d_logits"] > REL_TOL, gaps
    assert gaps["max_d_kpts_px"] > KPTS_TOL_PX, gaps


@pytest.fixture(scope="module")
def fullwidth_fp64():
    """The port's full-width W48 in fp64 on the CPU (the yardstick of fp32
    rounding: an fp64 model keeps fp64 parameters and runs every layer,
    batch norm and head in fp64)."""
    torch.set_num_threads(2)
    outs = []
    for s in SEEDS:
        model = precision.harness_model(torch.float64, s, device="cpu")
        assert model.hrnet.conv1.weight.dtype == torch.float64
        outs.append(precision.harness_outputs(model, N, s))
    return outs


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_fp32_rounding_against_fp64(fullwidth_fp32, fullwidth_fp64, i):
    """The JAX fp32 fixture and the port's fp32 forward each lie within
    FP32_ROUNDING_PX of the port's fp64 forward (kpts), their logits and
    heatmap RMS within REL_TOL, and their angles within ANGLE_TOL_RAD: the
    fixture gap is fp32 rounding on both sides."""
    exact = fullwidth_fp64[i]
    for name, out in (("jax_fp32", _seed_slice(_fixture(), i)),
                      ("port_fp32", fullwidth_fp32[i])):
        gaps = precision.fixture_gaps(out, exact)
        print(f"seed {SEEDS[i]} {name} vs port fp64: {gaps}")
        assert gaps["max_d_kpts_px"] <= FP32_ROUNDING_PX, (name, gaps)
        assert gaps["max_rel_d_logits"] <= REL_TOL, (name, gaps)
        assert gaps["max_rel_d_maps_rms"] <= REL_TOL, (name, gaps)
        assert np.radians(gaps["max_d_ry_deg"]) <= ANGLE_TOL_RAD, (name, gaps)
        assert np.radians(gaps["max_d_alpha_deg"]) <= ANGLE_TOL_RAD, \
            (name, gaps)


@pytest.mark.parametrize("seed", SEEDS)
def test_harness_matches_jax_eager_shrunk(seed):
    """The harness end to end (inputs, meta, LS stats, device program) on
    the shrunk config against the JAX program run eagerly."""
    from egonet_tpu.config import default_demo_config
    torch.set_num_threads(1)
    out = precision.harness_outputs(
        precision.harness_model(torch.float32, seed, "cpu", _shrunk()),
        4, seed)
    ref = _jax_outputs(seed, 4, fixtures.shrink_hrnet(default_demo_config()))
    gaps = precision.fixture_gaps(out, ref)
    assert gaps["max_d_kpts_px"] <= 1e-3, gaps
    assert gaps["max_rel_d_logits"] <= REL_TOL, gaps
    assert gaps["max_rel_d_maps_rms"] <= REL_TOL, gaps
    assert np.radians(gaps["max_d_ry_deg"]) <= 1e-4, gaps
    assert np.radians(gaps["max_d_alpha_deg"]) <= 1e-4, gaps


@pytest.mark.parametrize("seed", SEEDS)
def test_fp32_self_consistency(seed):
    """fp32 against fp32 drifts by exactly 0."""
    torch.set_num_threads(1)
    stats = precision.drift_harness(torch.float32, torch.float32, 4, seed,
                                    device="cpu", cfgs=_shrunk())
    assert stats["n"] == 4
    assert stats["max_dry_deg"] == 0.0 and stats["max_dalpha_deg"] == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_angle_drift_budget_shrunk(seed):
    """bf16 against fp32 through the whole program: median under the
    0.5-degree budget of tests/test_precision.py, no instance past 5."""
    torch.set_num_threads(1)
    stats = precision.drift_harness(torch.float32, torch.bfloat16, 6, seed,
                                    device="cpu", cfgs=_shrunk())
    print(stats)
    assert stats["median_dry_deg"] < 0.5, stats
    assert stats["median_dalpha_deg"] < 0.5, stats
    assert stats["max_dalpha_deg"] < 5.0, stats


def test_fixture_gaps_wraps_angles():
    ref = {"kpts": np.zeros((2, 33, 2)), "euler": np.zeros((2, 3)),
           "alpha": np.array([np.pi - 1e-3, 0.0])}
    out = {"kpts": np.full((2, 33, 2), 0.5),
           "euler": np.array([[0.0, 2 * np.pi - 0.01, 0.0], [0, 0.01, 0]]),
           "alpha": np.array([-np.pi + 1e-3, 0.0])}
    g = precision.fixture_gaps(out, ref)
    assert g["max_d_kpts_px"] == g["median_d_kpts_px"] == 0.5
    assert g["max_d_ry_deg"] == pytest.approx(np.degrees(0.01))
    assert g["max_d_alpha_deg"] == pytest.approx(np.degrees(2e-3))


@pytest.mark.slow
def test_regenerate_fixture(tmp_path):
    """Rebuild the fixture from the JAX package and compare it with the
    committed one."""
    path = str(tmp_path / "fixture.npz")
    generate_fixture(path)
    with np.load(path) as new:
        fix = _fixture()
        assert sorted(new.files) == sorted(fix)
        for k in new.files:
            np.testing.assert_allclose(new[k], fix[k], atol=1e-4, err_msg=k)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    generate_fixture()
    print(f"wrote {FIXTURE}")
