"""PoseNetTPU through the port's facade: the slice (dispatch -> finalize ->
post_process) against the JAX package's on a shrunk model, and the
full-width native family (the root bench's ``extra = {}``: stride-8 grid,
depths 1/3/9, widths 256/512/1024, expansion 2/3/4, head 128, 256x256
crops) against a committed JAX fixture.

``tests/data/torch_native_fixture.npz`` holds the JAX package's fp32
outputs of the precision harness (``egonet_tpu_torch/precision.py``) with
the native demo config (``config.native_demo_config()``), seeds 0 and 1, 6
instances each: screen keypoints, the lifter output, the euler angles and
alpha, the coordinate head's logits (the input of its last conv,
"head2.3", is the sigmoid's) and each heatmap's RMS.  It is made as
``tests/data/torch_w48_fixture.npz`` is, the JAX program run eagerly:
``python -m tests.test_torch_native`` writes it anew (about a minute).
The port-side checks need no jax at full width.
"""

import os

import numpy as np
import pytest
import torch

from egonet_tpu_torch import precision
from egonet_tpu_torch.config import native_demo_config

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_native_fixture.npz")
SEEDS = (0, 1)
N = 6
KEYS = ("kpts", "lifter", "euler", "alpha", "logits", "maps_rms")
LOGITS_LAYER = "head2.3"         # stride 8, 32x32 grid: three stride-2 MBConvs
# the bars of the full-width W48 fixture (tests/test_torch_precision.py)
KPTS_TOL_PX, ANGLE_TOL_RAD, REL_TOL = 0.1, 1e-3, 2e-5


def _jax_cfg():
    from egonet_tpu.config import default_demo_config
    cfg = default_demo_config()
    cfg["heatmapModel"]["name"] = "tpu_native"
    cfg["heatmapModel"]["extra"] = {}
    return cfg


def generate_fixture(path=FIXTURE):
    """Write the full-width JAX fixture (float32)."""
    from tests.test_torch_precision import _jax_outputs
    outs = [_jax_outputs(s, N, _jax_cfg(), LOGITS_LAYER) for s in SEEDS]
    np.savez_compressed(
        path, seeds=np.asarray(SEEDS), n_instances=np.asarray(N),
        widths=np.asarray([256, 512, 1024]), depths=np.asarray([1, 3, 9]),
        input_size=np.asarray([256, 256]),
        **{k: np.stack([o[k] for o in outs]).astype(np.float32)
           for k in KEYS})


def _fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _seed_slice(fix, i):
    return {k: fix[k][i].astype(np.float64) for k in KEYS}


def test_native_demo_config_is_the_root_bench_family():
    """The demo config with the root bench's native switch (bench.py:
    name tpu_native, extra {})."""
    cfg = native_demo_config()
    assert cfg["heatmapModel"]["name"] == "tpu_native"
    assert cfg["heatmapModel"]["extra"] == {}
    from egonet_tpu_torch.config import demo_config
    demo = demo_config()
    demo["heatmapModel"].update(name="tpu_native", extra={})
    assert cfg == demo


def test_fixture_layout():
    fix = _fixture()
    assert list(fix["seeds"]) == list(SEEDS) and int(fix["n_instances"]) == N
    assert list(fix["widths"]) == [256, 512, 1024]
    assert fix["kpts"].shape == (2, N, 33, 2)
    assert fix["logits"].shape == (2, N, 66)
    assert fix["maps_rms"].shape == (2, N, 33)
    for k in KEYS:
        assert np.isfinite(fix[k]).all(), k
    assert os.path.getsize(FIXTURE) < 32 * 1024


def _harness(dtype, seed):
    torch.set_num_threads(2)
    return precision.harness_model(dtype, seed, "cpu", native_demo_config())


@pytest.fixture(scope="module")
def fullwidth_fp32():
    return [precision.harness_outputs(_harness(torch.float32, s), N, s)
            for s in SEEDS]


@pytest.fixture(scope="module")
def fullwidth_fp64():
    return [precision.harness_outputs(_harness(torch.float64, s), N, s)
            for s in SEEDS]


def _check_bars(gaps):
    assert gaps["max_rel_d_logits"] <= REL_TOL, gaps
    assert gaps["max_rel_d_maps_rms"] <= REL_TOL, gaps
    assert gaps["max_d_kpts_px"] <= KPTS_TOL_PX, gaps
    assert np.radians(gaps["max_d_ry_deg"]) <= ANGLE_TOL_RAD, gaps
    assert np.radians(gaps["max_d_alpha_deg"]) <= ANGLE_TOL_RAD, gaps


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_fullwidth_native_fp32_matches_fixture(fullwidth_fp32, i):
    """The full-width native family against the JAX package's: kpts within
    0.1 px, ry and alpha within 1e-3 rad, the head's logits and the
    heatmaps' RMS within 2e-5 relative."""
    gaps = precision.fixture_gaps(fullwidth_fp32[i],
                                  _seed_slice(_fixture(), i))
    print(f"seed {SEEDS[i]}: {gaps}")
    _check_bars(gaps)


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_fp32_rounding_against_fp64(fullwidth_fp32, fullwidth_fp64, i):
    """The yardstick: the JAX fp32 fixture and the port's fp32 forward each
    within the bars of the port's fp64 forward."""
    for name, out in (("jax_fp32", _seed_slice(_fixture(), i)),
                      ("port_fp32", fullwidth_fp32[i])):
        gaps = precision.fixture_gaps(out, fullwidth_fp64[i])
        print(f"seed {SEEDS[i]} {name} vs port fp64: {gaps}")
        _check_bars(gaps)


def test_planted_fault_fails_the_bars():
    """Two output channels of one MBConv's expand conv swapped (stage 2,
    block 4): the full-width forward fails the fixture's bars."""
    model = _harness(torch.float32, SEEDS[0])
    w = model.hrnet.get_submodule("stage2.4.pw1").weight.data
    w.index_copy_(0, torch.tensor([3, 7]), w[[7, 3]])
    model.hrnet.prepare_inference()
    gaps = precision.fixture_gaps(
        precision.harness_outputs(model, N, SEEDS[0]),
        _seed_slice(_fixture(), 0))
    print(f"swapped channels: {gaps}")
    assert gaps["max_rel_d_logits"] > REL_TOL, gaps
    assert gaps["max_rel_d_maps_rms"] > REL_TOL, gaps


# ---------------------------------------------------------------- the slice

def _shrunk_pair():
    """(JAX EgoNet fp32 run eagerly, the port's EgoNet fp32 on the CPU):
    a shrunk stride-8 PoseNetTPU with the same randomized weights and LS
    stats."""
    import functools
    import jax
    import jax.numpy as jnp
    from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
    from egonet_tpu_torch.io.weights import from_jax_variables
    from egonet_tpu_torch.models.egonet import EgoNet
    from tests import fixtures
    from tests.test_torch_egonet import _ls_stats
    cfg = fixtures.shrink_tpu_native(_jax_cfg(), widths=(16, 32, 64),
                                     head_width=16, grid_stride=8)
    rng = np.random.RandomState(11)
    j = JaxEgoNet(cfg, dtype=jnp.float32, rng_seed=5)
    j.hrnet_vars = jax.tree_util.tree_map(np.asarray, dict(j.hrnet_vars))
    for st in j.hrnet_vars["batch_stats"].values():
        st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = (rng.rand(*st["var"].shape) * 0.5 + 0.75).astype(
            np.float32)
    j.ls_stats = _ls_stats(rng, 96)
    ls = dict(j.ls_stats)
    j.to_device()
    j._get_jitted = lambda alpha_mode, packed=False: functools.partial(
        j._core_packed if packed else j._core, alpha_mode=alpha_mode)
    t = EgoNet(cfg, dtype=torch.float32, rng_seed=5, device="cpu")
    t.load_state(from_jax_variables(j.hrnet_vars),
                 from_jax_variables(j.lifter_vars), ls)
    return cfg, j, t


@pytest.fixture(scope="module")
def shrunk_pair():
    torch.set_num_threads(1)
    return _shrunk_pair()


@pytest.mark.parametrize("pack_mode", ["never", "always"])
def test_native_slice_fp32_matches_jax(shrunk_pair, pack_mode):
    """kpts within 1e-3 px, angles and alphas within 1e-4 rad (the W48
    slice's bars)."""
    from tests.test_torch_egonet import _annot, _compare_records
    _, j, t = shrunk_pair
    j.pack_mode = t.pack_mode = pack_mode
    annot = _annot(seed=3)
    rj = j.forward_annot_dict(annot)
    rt = t.finalize(t.dispatch_annot_dict(annot))
    _compare_records(rj, rt)
    t.post_process(rt)
    assert all(len(r["pred_str"].split("\n")) == 3 for r in rt.values())


def test_native_slice_bf16_within_drift_budget(shrunk_pair):
    """The port in bf16 against the same model in fp32: median |d ry| under
    0.5 degrees."""
    from egonet_tpu_torch.models.egonet import EgoNet
    from tests.test_torch_egonet import _angdiff, _annot
    cfg, _, t32 = shrunk_pair
    t32.pack_mode = "auto"
    t = EgoNet(cfg, dtype=torch.bfloat16, rng_seed=5, device="cpu")
    t.load_state(t32.hrnet.state_dict(), t32.lifter.state_dict(),
                 {k: v.numpy() for k, v in t32.ls_stats.items()})
    annot = _annot(seed=8, n_img=2, n_per=4)
    r32, r16 = t32.forward_annot_dict(annot), t.forward_annot_dict(annot)
    ry = np.concatenate([_angdiff(r32[p]["euler_angles"][:, 1],
                                  r16[p]["euler_angles"][:, 1]) for p in r32])
    assert np.isfinite(ry).all()
    assert np.degrees(np.median(ry)) < 0.5


def test_facade_refuses_a_model_without_coordinates():
    """The facade reads keypoints from a 'coordinates' head, or from
    PoseResNet's 'heatmap' head through its soft-argmax readout: this
    family's heatmap head (held to no reference) and its angle regression
    head are refused when the facade is built, and the message names the
    head."""
    from egonet_tpu_torch.models.egonet import EgoNet
    from tests import fixtures
    for head in ("heatmap", "angleregression"):
        cfg = fixtures.shrink_tpu_native(_jax_cfg())
        cfg["heatmapModel"]["head_type"] = head
        with pytest.raises(ValueError, match=f"coordinates.*'{head}'"):
            EgoNet(cfg, device="cpu")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    generate_fixture()
    print(f"wrote {FIXTURE}")
