"""The port's HRNet (coordinates head) and FC lifter against egonet_tpu's,
with the JAX package's variables carried over through
``egonet_tpu_torch.io.weights.from_jax_variables`` (shrunk config on the
CPU; the full W48 key set is checked from shapes alone)."""

import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from egonet_tpu.config import default_demo_config
from egonet_tpu.models.fc_lifter import build_fc_model as jax_fc
from egonet_tpu.models.hrnet import build_hrnet as jax_hrnet
from egonet_tpu.models.initialization import numpy_init as jax_init
from egonet_tpu_torch.config import _DEFAULTS, demo_config, load_config
from egonet_tpu_torch.io.weights import from_jax_variables
from egonet_tpu_torch.models import hrnet as th
from egonet_tpu_torch.models.fc_lifter import build_fc_model
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.ops import fused_block
from tests import fixtures

torch.set_num_threads(1)

DEMO_YML = os.path.join(os.path.dirname(__file__), "..", "egonet_tpu",
                        "configs", "KITTI_inference_demo.yml")


def test_demo_config_equals_yaml():
    with open(DEMO_YML) as f:
        assert demo_config() == yaml.safe_load(f)
    loaded = load_config(DEMO_YML)
    assert loaded.pop("config_path") == DEMO_YML
    # the keys every loaded config gets (the JAX loader's _DEFAULTS)
    assert {k: loaded.pop(k) for k in _DEFAULTS} == _DEFAULTS
    assert loaded == demo_config()


def _randomize_stats(variables, rng):
    """Non-trivial BN running stats, so eval BN (and its folding) is
    exercised for real."""
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    for prefix, st in variables.get("batch_stats", {}).items():
        st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = (rng.rand(*st["var"].shape) * 0.5 + 0.75).astype(
            np.float32)
    return variables


@pytest.fixture(scope="module")
def shrunk():
    """Shrunk JAX HRNet + its variables (randomized BN stats) and the
    port's HRNet loaded from them."""
    cfg = fixtures.shrink_hrnet(default_demo_config())
    jnet = jax_hrnet(cfg)
    jvars = _randomize_stats(jax_init(jnet, 3, jnp.zeros((1, 64, 64, 3))),
                             np.random.RandomState(3))
    tnet = th.build_hrnet(cfg).eval()
    tnet.load_state_dict(from_jax_variables(jvars), strict=True)
    return cfg, jnet, jvars, tnet


def test_state_dict_keys_equal_w48():
    """Full W48: the port's key set and shapes equal the converted JAX
    variables' (traced from shapes, no weights drawn)."""
    cfg = default_demo_config()
    shapes = jax.eval_shape(jax_hrnet(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = from_jax_variables(zeros)
    ours = th.build_hrnet(cfg).state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k


def test_init_matches_jax_numpy_init(shrunk):
    """The port's seeded initializer draws the JAX package's values."""
    cfg, jnet, _, _ = shrunk
    ref = from_jax_variables(jax_init(jnet, 7, jnp.zeros((1, 64, 64, 3))))
    ours = numpy_init(th.build_hrnet(cfg), 7).state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), k)


def test_hrnet_fp32_matches(shrunk, rng):
    cfg, jnet, jvars, tnet = shrunk
    x = rng.randn(3, 64, 64, 3).astype(np.float32)
    jmaps, jcoords = jnet.apply(jvars, jnp.asarray(x), train=False)
    with torch.no_grad():
        maps, coords = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert maps.shape == (3, 33, 16, 16) and coords.shape == (3, 33, 2)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jcoords), atol=1e-5)
    np.testing.assert_allclose(maps.numpy(), np.asarray(jmaps), atol=1e-4)


def test_hrnet_bf16_fused_blocks(shrunk, rng, monkeypatch):
    """bf16 eval sends every stride-1 branch block whose width the kernel
    takes (16/32/64 here; the width-8 blocks run unfused) through the
    fused block (its plain version on the CPU, BN folded) and stays close
    to the unfused bf16 path and to the JAX bf16 model."""
    cfg, _, jvars, _ = shrunk
    net = th.build_hrnet(cfg, dtype=torch.bfloat16).eval()
    net.load_state_dict(from_jax_variables(jvars))
    calls = []
    real = fused_block.fused_basic_block
    monkeypatch.setattr(fused_block, "fused_basic_block",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        _, fused = net(x.permute(0, 3, 1, 2))
        n_fused = len(calls)
        net.fuse_blocks = False
        _, unfused = net(x.permute(0, 3, 1, 2))
    # shrunk config: 1 block per branch, branches 2 + 3 + 4, less the
    # three width-8 ones
    assert n_fused == 6 and len(calls) == 6
    assert all(shape[3] % 16 == 0 for shape in calls)
    jb = jax_hrnet(cfg, dtype=jnp.bfloat16)
    _, jcoords = jb.apply(jvars, jnp.asarray(x.numpy()), train=False)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), atol=0.02)
    np.testing.assert_allclose(unfused.numpy(), np.asarray(jcoords),
                               atol=0.02)


def test_refold_on_load_state_dict(shrunk):
    cfg, _, jvars, _ = shrunk
    net = th.build_hrnet(cfg, dtype=torch.bfloat16).eval()
    net.prepare_inference()
    stale = net._inference_cache
    net.load_state_dict(from_jax_variables(jvars))
    assert net._inference_cache is not stale
    blk = next(net._fusable_blocks())
    w, b = fused_block.fold_conv_bn(blk.conv1.weight, blk.bn1)
    torch.testing.assert_close(net._inference_cache["folded"][blk][0], w)
    net.to("cpu")
    assert net._inference_cache is None


@pytest.mark.parametrize("out_size", [96, 99])
def test_lifter_matches(rng, out_size):
    cfg = default_demo_config()
    cfg["FCModel"]["output_size"] = out_size
    jl = jax_fc(cfg)
    jvars = _randomize_stats(jax_init(jl, 4, jnp.zeros((1, 66))), rng)
    tl = build_fc_model(cfg).eval()
    tl.load_state_dict(from_jax_variables(jvars), strict=True)
    x = rng.randn(5, 66).astype(np.float32)
    ref = np.asarray(jl.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
        assert got.shape == (5, out_size)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
        # dropout at test time: stochastic, BN still on running stats
        a = tl(torch.from_numpy(x), apply_dropout=True)
        assert not torch.equal(a, got)
        np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(),
                                      got.numpy())


def test_queued_options_raise(tmp_path, monkeypatch):
    """What the port refuses: an unknown head_type and an unknown
    heatmapModel.name (every model, head and option of the JAX factory
    builds, tests/test_torch_families.py); and the facade's
    post_process(visualize=True) / (refine=True) where matplotlib / cv2
    is missing, with an ImportError naming it."""
    import sys
    from egonet_tpu_torch.data import png
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.models.factory import build_heatmap_model
    c = fixtures.shrink_hrnet(demo_config())
    c["heatmapModel"]["head_type"] = "segmentation"
    with pytest.raises(NotImplementedError):
        th.build_hrnet(c)
    c = demo_config()
    c["heatmapModel"]["name"] = "vit"
    with pytest.raises(NotImplementedError):
        build_heatmap_model(c)
    net = EgoNet(fixtures.shrink_hrnet(demo_config()), device="cpu")
    frame = str(tmp_path / "000000.png")
    with open(frame, "wb") as f:
        f.write(png.encode(np.zeros((8, 8, 3), np.uint8)))
    rec = {"kpts_3d_pred": np.zeros((1, 32, 3)), "K": np.eye(3),
           "kpts_2d_pred": [np.zeros((1, 66))], "boxes": np.zeros((1, 4))}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="matplotlib"):
        net.post_process({frame: dict(rec)}, visualize=True,
                         vis_dir=str(tmp_path))
    with pytest.raises(ImportError, match="cv2"):
        net.post_process({frame: dict(rec)}, refine=True)
