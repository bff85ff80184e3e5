"""The port's row-streaming fused BasicBlock
(egonet_tpu_torch/ops/fused_block_stencil.py) against the JAX package's
Pallas stencil kernel (interpret mode on CPU) and its XLA oracle; the
EGONET_PALLAS_STENCIL flag and probe; the HRNet wiring.

The CUDA kernel runs only on the card: the ``cuda`` cases skip without one
(``python3 chip_smoke.py`` holds the kernel against its plain version at the
W48 shapes and odd ones on every chip run)."""

import inspect
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from egonet_tpu.ops import pallas_block as pb
from egonet_tpu.ops import pallas_block_stencil as pbs
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops import fused_block as fb
from egonet_tpu_torch.ops import fused_block_stencil as st

torch.set_num_threads(1)


def _random_block(rng, C):
    w1 = rng.randn(3, 3, C, C).astype(np.float32) * 0.1
    w2 = rng.randn(3, 3, C, C).astype(np.float32) * 0.1

    def bn():
        return {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                "bias": rng.randn(C).astype(np.float32) * 0.1,
                "mean": rng.randn(C).astype(np.float32) * 0.1,
                "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    return w1, bn(), w2, bn()


def _folded(params, dtype):
    c = params["w1"].shape[0]
    return (torch.from_numpy(params["w1"]).reshape(c, 3, 3, c).to(dtype),
            torch.from_numpy(params["b1"]).reshape(-1),
            torch.from_numpy(params["w2"]).reshape(c, 3, 3, c).to(dtype),
            torch.from_numpy(params["b2"]).reshape(-1))


def test_plain_version_is_the_tiled_kernels():
    assert st.fused_basic_block_reference is fb.fused_basic_block_reference


@pytest.mark.parametrize("H,W,C,B,TW", [
    (8, 8, 8, 16, 8),
    (16, 16, 8, 8, 8),
])
def test_plain_version_bf16_matches_pallas_stencil(rng, H, W, C, B, TW):
    """bf16 operands on both sides, the JAX test's bar (atol 0.15, rtol
    0.05); the observed maximum is printed."""
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    params = pbs.pack_stencil_weights(w1, bn1, w2, bn2)
    xT = jnp.asarray(np.transpose(x, (1, 2, 3, 0))).astype(jnp.bfloat16)
    yT = pbs.fused_basic_block_stencil(xT, params, tile_cols=TW,
                                       interpret=True)
    pallas = np.transpose(np.asarray(yT, dtype=np.float32), (3, 0, 1, 2))
    got = st.fused_basic_block_stencil(
        torch.from_numpy(x).bfloat16(),
        *_folded(fb.pack_block_weights(w1, bn1, w2, bn2), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    print(f"max |plain - pallas stencil| = {np.abs(got - pallas).max():.4g}")
    np.testing.assert_allclose(got, pallas, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("H,W,C,B", [(8, 8, 8, 16), (16, 16, 8, 8),
                                     (6, 11, 16, 3)])
def test_plain_version_fp32_matches_xla_reference(rng, H, W, C, B):
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    ref = np.asarray(pb.reference_basic_block(jnp.asarray(x), w1, bn1,
                                              w2, bn2))
    got = st.fused_basic_block_stencil(
        torch.from_numpy(x),
        *_folded(fb.pack_block_weights(w1, bn1, w2, bn2), torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_pack_stencil_weights_equals_jax(rng):
    """w2p[r] is the ring-rotation permutation of the port's folded w2."""
    w1, bn1, w2, bn2 = _random_block(rng, 16)
    ours = st.pack_stencil_weights(w1, bn1, w2, bn2)
    theirs = pbs.pack_stencil_weights(w1, bn1, w2, bn2)
    for k in ("w1", "b1", "b2", "w2p"):
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
    w2 = fb.pack_block_weights(w1, bn1, w2, bn2)["w2"].reshape(16, 3, 3, 16)
    for r in range(3):
        for j in range(3):
            np.testing.assert_array_equal(
                ours["w2p"][r].reshape(16, 3, 3, 16)[:, j],
                w2[:, (j - r) % 3])


def test_probe_args_match_jax_probe():
    """The probe's input is the JAX probe's, in the port's NHWC layout."""
    x, (w1, b1, w2, b2) = st.probe_args(tile_cols=8, channels=8, width=16,
                                        batch=4, height=4)
    jx, jp = pbs.probe_args(tile_cols=8, channels=8, width=16, batch=4,
                            height=4)
    assert x.shape == (4, 4, 16, 8) and x.dtype == torch.bfloat16
    np.testing.assert_allclose(
        x.float().numpy(),
        np.transpose(np.asarray(jx, np.float32), (3, 0, 1, 2)),
        rtol=2 ** -7)
    np.testing.assert_array_equal(
        w1.float().numpy().reshape(8, -1),
        torch.from_numpy(np.array(jp["w1"])).bfloat16().float().numpy())
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jp["b2"])[0])
    y = st.fused_basic_block_stencil(x, w1, b1, w2, b2)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()


def test_stencil_flag_gating(monkeypatch):
    """EGONET_PALLAS_STENCIL: '0' off, '1' on, 'auto' consults the cached
    probe (the cache key comes from the probe's own defaults)."""
    assert st.stencil_enabled("0") is False
    assert st.stencil_enabled("1") is True
    monkeypatch.setenv("EGONET_PALLAS_STENCIL", "0")
    assert st.stencil_enabled() is False
    monkeypatch.setenv("EGONET_PALLAS_STENCIL", "1")
    assert st.stencil_enabled() is True
    key = tuple(p.default for p in
                inspect.signature(st.probe_wide_tile).parameters.values())
    assert key == tuple(p.default for p in
                        inspect.signature(pbs.probe_wide_tile)
                        .parameters.values())
    monkeypatch.setattr(st, "_PROBE_CACHE", {key: False})
    assert st.stencil_enabled("auto") is False
    st._PROBE_CACHE[key] = True
    assert st.stencil_enabled("auto") is True


def test_auto_is_off_without_cuda(monkeypatch):
    monkeypatch.setattr(st, "_PROBE_CACHE", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert st.probe_wide_tile() is False
    assert st.stencil_enabled("auto") is False


def test_wrapper_takes_plain_version_for_cpu_tensor(monkeypatch):
    calls = []

    def plain(*args):
        calls.append(args)
        return "plain"

    monkeypatch.setattr(st, "fused_basic_block_reference", plain)
    before = st.fused_basic_block_stencil.launches
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    w = torch.zeros(16, 3, 3, 16, dtype=torch.bfloat16)
    b = torch.zeros(16)
    assert st.fused_basic_block_stencil(x, w, b, w, b) == "plain"
    assert len(calls) == 1
    assert st.fused_basic_block_stencil.launches == before


def test_hrnet_stencil_flag_selects_wrapper_and_matches_tiled(monkeypatch):
    """Shrunk HRNet, bf16 eval on the CPU: stencil='1' sends the fusable
    blocks to the stencil wrapper, '0' to the tiled one, with identical
    outputs (both run the same plain version here); an explicit choice
    survives a rebuild."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.init import numpy_init
    from tests import fixtures
    monkeypatch.delenv("EGONET_PALLAS_STENCIL", raising=False)
    cfg = fixtures.shrink_hrnet(demo_config(), num_blocks=2)
    net = numpy_init(build_heatmap_model(cfg, dtype=torch.bfloat16), 3).eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 64, 64).astype(np.float32))
    calls = {"tiled": 0, "stencil": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fb, "fused_basic_block",
                        counting("tiled", fb.fused_basic_block))
    monkeypatch.setattr(st, "fused_basic_block_stencil",
                        counting("stencil", st.fused_basic_block_stencil))
    with torch.no_grad():
        net.prepare_inference(stencil="0")
        maps0, coords0 = net(x)
        n_blocks = calls["tiled"]
        assert n_blocks > 0 and calls["stencil"] == 0
        net.prepare_inference(stencil="1")
        net.load_state_dict(net.state_dict())      # rebuilds the cache
        maps1, coords1 = net(x)
    assert net.stencil == "1"
    assert calls == {"tiled": n_blocks, "stencil": n_blocks}
    torch.testing.assert_close(maps1, maps0, atol=0, rtol=0)
    torch.testing.assert_close(coords1, coords0, atol=0, rtol=0)


def test_build_treats_a_newer_header_as_stale(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    (csrc / "k.cu").write_text("")
    assert _build._stale("k")
    (build / "libk.so").write_text("")
    os.utime(csrc / "k.cu", (1, 1))
    assert not _build._stale("k")
    (csrc / "common.cuh").write_text("")
    os.utime(csrc / "common.cuh", (2 ** 31, 2 ** 31))
    assert _build._stale("k")


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,W,B", [(48, 64, 64, 4), (96, 32, 32, 4),
                                     (192, 16, 16, 4), (384, 8, 8, 4),
                                     (32, 10, 37, 3)])
def test_kernel_matches_plain_version(C, H, W, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(C)
    dev = "cuda"
    std = (1.0 / (9 * C)) ** 0.5
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 0.5).bfloat16()
    w1 = (torch.randn(C, 3, 3, C, device=dev, generator=g) * std).bfloat16()
    w2 = (torch.randn(C, 3, 3, C, device=dev, generator=g) * std).bfloat16()
    b1 = torch.randn(C, device=dev, generator=g) * 0.1
    b2 = torch.randn(C, device=dev, generator=g) * 0.1
    before = st.fused_basic_block_stencil.launches
    y = st.fused_basic_block_stencil(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert st.fused_basic_block_stencil.launches == before + 1
    ref = st.fused_basic_block_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(y.float(), ref.float(), atol=5e-2, rtol=2e-2)
