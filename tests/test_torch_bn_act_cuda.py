"""The batch-norm epilogue's CUDA kernel (``egonet::bn_act``,
csrc/bn_act.cu), marked ``cuda``: it skips without a card.  Bit for bit
the CPU kernel (the same routine of csrc/bn_act.cuh) at layer1's shape
(at a full bucket too), head2's C = 66, the stem's and stage 4's widths,
an odd one and PoseResNet-152's widths, through each of its vector widths
(16-byte, 4-byte and 2-byte accesses) and on channel slices read in
place, one launch a call; 96 launches a dispatch of the W48 facade beside
the 104 fused blocks, 158 of PoseResNet-152's and 62 of PoseNetTPU's.  No JAX here: the CPU kernel is the yardstick
(tests/test_torch_bn_act.py holds it to the unfused path)."""

import numpy as np
import pytest
import torch

from egonet_tpu_torch.ops import fused_block as fb
from egonet_tpu_torch.ops.bn_act import bn_act

# NHWC shapes: layer1 (64x64, C = 256), the stem's C = 64, head2's C = 66,
# stage 4 of W48 (8x8, C = 384), an odd width; then PoseResNet-152's:
# layer4's, layer3's and layer2's block outputs (C = 2048, 1024, 512: one,
# two and four pixels a block), its stem at 128x128, a transposed conv's
# output (C = 256 at 32x32)
SHAPES = [(6, 64, 64, 256), (3, 64, 64, 64), (5, 8, 8, 66), (7, 8, 8, 384),
          (2, 3, 5, 35), (4, 8, 8, 2048), (4, 16, 16, 1024),
          (4, 32, 32, 512), (2, 128, 128, 64), (3, 32, 32, 256)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _operands(shape, seed):
    """x, residual (NHWC bf16) and scale, shift [C] fp32."""
    rng = np.random.RandomState(seed)
    c = shape[-1]

    def tensor():
        return torch.from_numpy(
            (rng.randn(*shape) * 2).astype(np.float32)).bfloat16()

    scale = torch.from_numpy(rng.uniform(-1.5, 1.5, c).astype(np.float32))
    shift = torch.from_numpy(rng.randn(c).astype(np.float32))
    return tensor(), tensor(), scale, shift


def _check(shape, residual, relu, offset=0):
    """The CUDA kernel against the CPU kernel, with x ``offset`` elements
    into its storage on the card."""
    x, r, scale, shift = _operands(shape, seed=sum(shape) + offset)
    r = r if residual else None
    want = bn_act(x, scale, shift, r, relu)
    dev = [None if t is None else t.cuda() for t in (x, scale, shift, r)]
    if offset:
        dev[0] = torch.empty(x.numel() + offset, dtype=x.dtype,
                             device="cuda")[offset:].view(x.shape)
        dev[0].copy_(x)
    before = bn_act.launches
    got = bn_act(*dev, relu)
    torch.cuda.synchronize()
    assert bn_act.launches == before + 1
    assert got.is_cuda and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_is_the_cpu_kernel(shape, residual, relu):
    _needs_card()
    _check(shape, residual, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 16, 16, 256), (3, 8, 8, 66)])
def test_misaligned_operands_take_a_narrower_vector(shape):
    """x one element into its storage: the 2-byte path, still bit for bit
    the CPU kernel."""
    _needs_card()
    _check(shape, residual=True, relu=True, offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_full_bucket_is_the_cpu_kernel(residual):
    """layer1 at a full W48 bucket (512 crops, 2.1 M pixels): the grid
    strides over the tensor several times, still bit for bit."""
    _needs_card()
    _check((512, 64, 64, 256), residual, relu=True)


# (N, H, W, channels before, C, channels after): fuse_merge's channel views
# of layer1's merged conv1 + downsample at a full bucket, of a fuse layer's
# merged convs, and an odd offset at head2's C = 66 (the 2-byte path)
SLICES = [(512, 64, 64, 0, 64, 256), (512, 64, 64, 64, 256, 0),
          (8, 16, 16, 48, 96, 0), (5, 8, 8, 3, 66, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,h,w,before,c,after", SLICES)
def test_channel_slice_is_the_cpu_kernel(n, h, w, before, c, after,
                                         residual):
    """x and the residual channel slices of wider NHWC tensors, read in
    place on the card (pixels before + C + after elements apart): bit for
    bit the CPU kernel on the same slices, one launch, a contiguous
    result."""
    _needs_card()
    wide = (n, h, w, before + c + after)
    xw, rw, _, _ = _operands(wide, seed=sum(wide) + residual)
    _, _, scale, shift = _operands((1, 1, 1, c), seed=c)
    x, r = (t[..., before:before + c] for t in (xw, rw))
    r = r if residual else None
    want = bn_act(x, scale, shift, r, True)
    dev = [None if t is None else t.cuda() for t in (xw, scale, shift, rw)]
    before_launches = bn_act.launches
    got = bn_act(dev[0][..., before:before + c], dev[1], dev[2],
                 dev[3][..., before:before + c] if residual else None, True)
    torch.cuda.synchronize()
    assert bn_act.launches == before_launches + 1
    assert got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_facade_dispatch_is_96_launches_a_forward(shards):
    """A dispatch of the W48 facade, alone and over a mesh of two shards
    on cuda:0: 96 bn_act launches and 104 fused blocks a shard's forward."""
    _needs_card()
    import chip_smoke
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.parallel import mesh
    model = EgoNet(demo_config(), mesh=mesh.DataMesh(["cuda:0"] * shards))
    annot = chip_smoke._frames(np, n_frames=2, n_boxes=5)
    model.finalize(model.dispatch_annot_dict(annot))
    bn_act.launches = 0
    fb.fused_basic_block.launches = 0
    records = model.finalize(model.dispatch_annot_dict(annot))
    assert bn_act.launches == 96 * shards
    assert fb.fused_basic_block.launches == 104 * shards
    assert all(np.isfinite(r["euler_angles"]).all() for r in records.values())


@pytest.mark.cuda
def test_fuse_merge_dispatch_is_96_launches_a_forward():
    """With ``fuse_merge`` 38 batch norms read channel views of a merged
    conv in place: still 96 launches a forward, and the angles within a
    degree of the unmerged model's (merged convs round differently)."""
    _needs_card()
    import chip_smoke
    from egonet_tpu_torch.config import demo_config
    annot = chip_smoke._frames(np, n_frames=2, n_boxes=5)
    ry = []
    for merge in (False, True):
        cfg = demo_config()
        cfg["heatmapModel"]["fuse_merge"] = merge
        model = chip_smoke._slice_model(torch, cfg)
        model.finalize(model.dispatch_annot_dict(annot))
        bn_act.launches = 0
        records = model.finalize(model.dispatch_annot_dict(annot))
        assert bn_act.launches == 96
        ry.append(np.concatenate([r["euler_angles"][:, 1]
                                  for r in records.values()]))
    assert np.abs(np.degrees(ry[0] - ry[1])).max() < 1.0


@pytest.mark.cuda
def test_pose_resnet152_dispatch_is_158_launches_a_forward():
    """The benchmark's PoseResNet-152 on the facade (256x256 crops, bf16):
    each of its 158 batch norms is one launch a dispatch's forward, the
    max pool's and the transposed convs' outputs included."""
    _needs_card()
    import json
    import os

    import chip_smoke
    from benchmark import harness
    with open(os.path.join(os.path.dirname(__file__), "..", "benchmark",
                           "configs", "egonet_resnet152_car.json")) as f:
        cfg = {k: v for k, v in json.load(f).items()
               if k not in harness.HARNESS_KEYS}
    model = chip_smoke._slice_model(torch, cfg)
    annot = chip_smoke._frames(np, n_frames=2, n_boxes=5)
    model.finalize(model.dispatch_annot_dict(annot))
    bn_act.launches = 0
    records = model.finalize(model.dispatch_annot_dict(annot))
    assert bn_act.launches == 158
    assert all(np.isfinite(r["euler_angles"]).all() for r in records.values())


@pytest.mark.cuda
def test_native_dispatch_is_62_launches_a_forward():
    """PoseNetTPU at its defaults on the facade in bf16: each of its 62
    batch norms is one launch a dispatch's forward (depthwise convs' and
    the pixel-shuffled FPN's outputs included), and its angles stay
    within half a degree (median) of the same model in fp32."""
    _needs_card()
    import chip_smoke
    from egonet_tpu_torch.config import native_demo_config
    annot = chip_smoke._frames(np, n_frames=2, n_boxes=5)
    ry = []
    for dtype in (torch.bfloat16, torch.float32):
        model = chip_smoke._slice_model(torch, native_demo_config(), dtype)
        model.finalize(model.dispatch_annot_dict(annot))
        bn_act.launches = 0
        records = model.finalize(model.dispatch_annot_dict(annot))
        assert bn_act.launches == (62 if dtype == torch.bfloat16 else 0)
        ry.append(np.concatenate([r["euler_angles"][:, 1]
                                  for r in records.values()]))
    d = np.abs(np.degrees(np.mod(ry[0] - ry[1] + np.pi, 2 * np.pi) - np.pi))
    assert np.isfinite(d).all() and np.median(d) < 0.5
