"""Every heatmap model the JAX package builds, in the port: PoseNetTPU
(both grid strides, all three heads, per-stage expansion), PoseResNet
(basic and bottleneck blocks, deconv kernels 4, 3 and 2) and the HRNet's
'heatmap' (with and without ``pixel_shuffle``) and 'angleregression'
heads and its ``act_quant`` / ``fuse_merge`` options, each held against
the JAX module on the same numpy inputs and weights, small, on the CPU.

Bars: in float64 (JAX with x64) every output within 1e-10 of its scale
(its largest entry); in float32 within 1e-4 of it.  ``act_quant`` rounds
to uint8 codes, where float32 rounding on either side flips a code near a
half step: it is held in float64, codes equal everywhere and outputs
within 1e-12.  Also: the seeded initializer and the weight conversions
(``from_jax_variables`` / ``flax_to_torch`` / ``torch_to_flax``, .pth
files both ways, strict) for every family, and the FLOP counts the bench
reads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.config import default_demo_config
from egonet_tpu.io import torch_convert as tc
from egonet_tpu.models.factory import build_heatmap_model as jax_build
from egonet_tpu.models.hrnet import _pixel_shuffle as jax_shuffle
from egonet_tpu.models.initialization import numpy_init as jax_init
from egonet_tpu_torch.io.weights import from_jax_variables
from egonet_tpu_torch.models import hrnet as th
from egonet_tpu_torch.models import layers
from egonet_tpu_torch.models.factory import build_heatmap_model
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.models.resnet import PoseResNet
from egonet_tpu_torch.models.tpu_native import PoseNetTPU
from egonet_tpu_torch.utils import summary
from tests import fixtures

torch.set_num_threads(2)
SIZE = 64


def _native(head="coordinates", grid_stride=8):
    cfg = fixtures.shrink_tpu_native(default_demo_config(),
                                     widths=(16, 32, 64), head_width=16,
                                     grid_stride=grid_stride)
    cfg["heatmapModel"]["extra"]["expansion"] = [2, 3, 4]
    cfg["heatmapModel"]["head_type"] = head
    return cfg


def _resnet(layers_=18, kernels=(4, 3, 2), fk=1, bias=False):
    cfg = default_demo_config()
    hm = cfg["heatmapModel"]
    hm.update(name="resnet", num_layers=layers_, head_type="heatmap",
              heatmap_size=[16, 16])
    hm["input_size"] = [SIZE, SIZE]
    hm["extra"] = {"num_deconv_layers": 3, "num_deconv_filters": [16, 8, 8],
                   "num_deconv_kernels": list(kernels),
                   "final_conv_kernel": fk, "deconv_with_bias": bias}
    return cfg


def _hrnet(**options):
    cfg = fixtures.shrink_hrnet(default_demo_config())
    cfg["heatmapModel"].update(options)
    return cfg


CASES = {
    "native_s8_coordinates": lambda: _native("coordinates", 8),
    "native_s8_heatmap": lambda: _native("heatmap", 8),
    "native_s8_angleregression": lambda: _native("angleregression", 8),
    "native_s4_coordinates": lambda: _native("coordinates", 4),
    "native_s4_heatmap": lambda: _native("heatmap", 4),
    "native_s4_angleregression": lambda: _native("angleregression", 4),
    "resnet18_deconv_4_3_2": lambda: _resnet(18, (4, 3, 2)),
    "resnet50_deconv_4_4_4_fk3_bias": lambda: _resnet(50, (4, 4, 4), 3,
                                                      True),
    "hrnet_heatmap": lambda: _hrnet(head_type="heatmap"),
    "hrnet_heatmap_pixel_shuffle": lambda: _hrnet(
        head_type="heatmap", pixel_shuffle=True, heatmap_size=[32, 32]),
    "hrnet_angleregression": lambda: _hrnet(head_type="angleregression"),
    "hrnet_fuse_merge": lambda: _hrnet(fuse_merge=True),
}


def _randomize_stats(variables, rng):
    """Non-trivial BN running statistics (eval BN for real)."""
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    for st in variables.get("batch_stats", {}).values():
        st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = (rng.rand(*st["var"].shape) * 0.5 + 0.75).astype(
            np.float32)
    return variables


def _jax_model(cfg, f64=False, seed=3):
    """(JAX module, its variables with random BN statistics)."""
    model = jax_build(cfg, dtype=jnp.float64 if f64 else jnp.float32)
    variables = _randomize_stats(
        jax_init(model, seed, jnp.zeros((1, SIZE, SIZE, 3))),
        np.random.RandomState(seed))
    if f64:
        variables = jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), variables)
    return model, variables


def _port_model(cfg, variables, f64=False, dtype=None):
    dtype = dtype or (torch.float64 if f64 else torch.float32)
    model = build_heatmap_model(cfg, dtype=dtype).eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _outputs(out):
    return [np.asarray(o, np.float64) for o in
            (out if isinstance(out, tuple) else (out,))]


def _run_both(cfg, f64, x=None):
    x = np.random.RandomState(0).randn(3, SIZE, SIZE, 3) if x is None else x
    with jax.enable_x64(f64):
        jm, jv = _jax_model(cfg, f64)
        xj = jnp.asarray(x, jnp.float64 if f64 else jnp.float32)
        ref = _outputs(jm.apply(jv, xj, train=False))
    tm = _port_model(cfg, jv, f64)
    xt = torch.from_numpy(np.asarray(x, np.float64 if f64 else np.float32))
    with torch.no_grad():
        got = _outputs(tuple(o.numpy() for o in _as_tuple(
            tm(xt.permute(0, 3, 1, 2)))))
    return ref, got


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("f64", [True, False], ids=["fp64", "fp32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, f64):
    ref, got = _run_both(CASES[case](), f64)
    tol = 1e-10 if f64 else 1e-4
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        scale = np.abs(r).max()
        assert np.abs(g - r).max() <= tol * scale, (
            case, np.abs(g - r).max() / scale)


def test_pixel_shuffle_bit_equal_to_jax():
    rng = np.random.RandomState(1)
    for r, c in ((2, 3), (4, 5), (2, 16)):
        x = rng.randn(2, 5, 7, c * r * r).astype(np.float32)
        ref = np.asarray(jax_shuffle(jnp.asarray(x), r))     # NHWC
        got = layers.pixel_shuffle(
            torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), ref)


def _codes_of_port(model, x):
    codes = []
    real = layers.Ops.transport

    def record(self, t):
        if self.act_quant == "int8":
            codes.append(torch.clamp(torch.round(
                t.float() * (255.0 / self.act_quant_scale)), 0, 255).to(
                    torch.uint8).numpy())
        return real(self, t)
    layers.Ops.transport = record
    try:
        with torch.no_grad():
            out = _as_tuple(model(x))
    finally:
        layers.Ops.transport = real
    return codes, [o.numpy() for o in out]


def _codes_of_jax(model_cls, model, variables, x):
    codes = []
    real = model_cls._transport

    def record(self, t):
        if self.act_quant == "int8":
            codes.append(np.asarray(jnp.clip(jnp.round(
                t.astype(jnp.float32) * (255.0 / self.act_quant_scale)),
                0.0, 255.0).astype(jnp.uint8)))
        return real(self, t)
    model_cls._transport = record
    try:
        out = model.apply(variables, x, train=False)
    finally:
        model_cls._transport = real
    return codes, _outputs(out)


@pytest.mark.parametrize("family", ["hrnet", "native"])
def test_act_quant_codes_equal_jax_in_float64(family):
    """act_quant 'int8': every uint8 code of the transport equal to the JAX
    model's (in NCHW against NHWC order), outputs within 1e-12."""
    from egonet_tpu.models.hrnet import PoseHighResolutionNet as JH
    from egonet_tpu.models.tpu_native import PoseNetTPU as JN
    cfg = _hrnet() if family == "hrnet" else _native()
    cfg["heatmapModel"]["act_quant"] = "int8"
    x = np.random.RandomState(2).randn(2, SIZE, SIZE, 3)
    with jax.enable_x64(True):
        jm, jv = _jax_model(cfg, True)
        jcodes, ref = _codes_of_jax(JH if family == "hrnet" else JN, jm, jv,
                                    jnp.asarray(x))
    tm = _port_model(cfg, jv, True)
    codes, got = _codes_of_port(tm, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(codes) == len(jcodes) >= 6
    for c, j in zip(codes, jcodes):
        np.testing.assert_array_equal(c.transpose(0, 2, 3, 1), j)
    assert any(((c > 0) & (c < 255)).any() for c in codes)
    for r, g in zip(ref, got):
        assert np.abs(g - r).max() <= 1e-12 * max(np.abs(r).max(), 1.0)


def test_act_quant_gradient_is_zero_through_round():
    """round has a zero gradient in both packages: the quantized tensor's
    gradient to its input is 0 (not the straight-through 1)."""
    ops = layers.Ops(torch.float64, act_quant="int8")
    x = torch.rand(5, dtype=torch.float64, requires_grad=True)
    ops.transport(x).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    jg = jax.grad(lambda v: jnp.round(v * 31.875).sum())(jnp.ones(5))
    assert float(jnp.abs(jg).max()) == 0.0


def test_fuse_merge_on_equals_off_in_float64():
    cfg = _hrnet(fuse_merge=True)
    with jax.enable_x64(True):
        _, jv = _jax_model(cfg, True)
    on = _port_model(cfg, jv, True)
    off = _port_model(_hrnet(), jv, True)
    assert on.fuse_merge and not off.fuse_merge
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, SIZE, SIZE))
    with torch.no_grad():
        for a, b in zip(on(x), off(x)):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-12 * scale


def test_fuse_merge_bf16_uses_cached_merged_weights():
    """bf16 inference: each merged group's concatenated bf16 weights are
    cached once (and rebuilt on load_state_dict); the merged forward stays
    within bf16 rounding of the unmerged one."""
    cfg = _hrnet(fuse_merge=True)
    _, jv = _jax_model(cfg)
    net = _port_model(cfg, jv, dtype=torch.bfloat16)
    cache = net._inference_cache
    groups = net._merge_groups()
    # layer1 block 0, stage 2 (2 branches), 3 (3) and 4 (4, one output)
    assert len(groups) == 1 + 2 + 4 + 3
    for g in groups:
        torch.testing.assert_close(
            cache["cast"][g],
            torch.cat([m.weight.to(torch.bfloat16) for m in g]))
    net.load_state_dict(from_jax_variables(jv))
    assert net._inference_cache is not cache
    plain = _port_model(_hrnet(), jv, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 3, SIZE, SIZE).astype(np.float32))
    with torch.no_grad():
        _, a = net(x)
        _, b = plain(x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.02)


def _all_cases():
    cases = dict(CASES)
    cases["hrnet_coordinates"] = _hrnet
    cases["hrnet_w32_pedestrian_shape"] = lambda: fixtures.shrink_hrnet(
        _ped_config())
    return cases


def _ped_config():
    from egonet_tpu_torch.config import train_igrs_ped_config
    return train_igrs_ped_config()


@pytest.mark.parametrize("case", sorted(_all_cases()))
def test_numpy_init_equals_jax(case):
    """The seeded initializer draws the JAX package's values (conv, dense,
    depthwise (3, 3, 1, C) and transposed-conv kernels, BN 2-D and 1-D)."""
    cfg = _all_cases()[case]()
    ref = from_jax_variables(jax_init(jax_build(cfg), 7,
                                      jnp.zeros((1, SIZE, SIZE, 3))))
    ours = numpy_init(build_heatmap_model(cfg), 7).state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), k)


@pytest.mark.parametrize("case", ["native_s8_angleregression",
                                  "resnet18_deconv_4_3_2",
                                  "hrnet_angleregression"])
def test_weight_files_load_strictly_both_ways(case, tmp_path):
    """from_jax_variables equals flax_to_torch key for key; the port's .pth
    converts back (torch_to_flax) to the JAX tree's structure and values;
    a .pth of the JAX converter loads strictly into the port."""
    cfg = CASES[case]()
    _, jv = _jax_model(cfg)
    ours = from_jax_variables(jv)
    ref = tc.flax_to_torch(jv)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), k)
    path = str(tmp_path / "jax.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref.items()},
               path)
    from egonet_tpu_torch.io.weights import load_torch_state_dict
    model = build_heatmap_model(cfg)
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    path = str(tmp_path / "port.pth")
    torch.save(model.state_dict(), path)
    back = tc.torch_to_flax(tc.load_torch_state_dict(path))
    assert tc.check_conversion(jv, back) == []
    for a, b in zip(jax.tree_util.tree_leaves(jv),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_factory_builds_every_family():
    assert isinstance(build_heatmap_model(_native()), PoseNetTPU)
    cfg = _native()
    cfg["heatmapModel"]["name"] = "posenet_tpu"
    assert isinstance(build_heatmap_model(cfg), PoseNetTPU)
    for name in ("resnet", "pose_resnet"):
        cfg = _resnet()
        cfg["heatmapModel"]["name"] = name
        assert isinstance(build_heatmap_model(cfg), PoseResNet)
    for name in ("hrnet", "pose_hrnet"):
        cfg = _hrnet()
        cfg["heatmapModel"]["name"] = name
        assert isinstance(build_heatmap_model(cfg), th.PoseHighResolutionNet)


@pytest.mark.parametrize("case", ["native_s8_coordinates",
                                  "resnet18_deconv_4_3_2",
                                  "hrnet_angleregression",
                                  "hrnet_fuse_merge"])
def test_flop_count_covers_every_layer(case):
    """The FLOPs the bench's MFU reads (FlopCounterMode) equal the per-layer
    table's sum of conv, transposed-conv and dense calls, and the
    parameter count is every parameter's."""
    model = build_heatmap_model(CASES[case](),
                                dtype=torch.bfloat16).eval()
    x = torch.zeros(2, 3, SIZE, SIZE)
    flops = summary.count_flops(model, x, modules=(model,))
    rows = summary.layer_rows(model, x)
    assert flops > 0 and flops == sum(r["flops"] for r in rows)
    assert all(r["name"] != "?" for r in rows), [r for r in rows
                                                 if r["name"] == "?"]
    assert summary.count_params(model) == sum(
        v.numel() for k, v in model.state_dict().items()
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")))
