"""The HRNet's batch-norm epilogue as one operator, ``egonet::bn_act``
(ops/bn_act.py, csrc/bn_act.cuh), on the CPU: its CPU kernel is the
rounding sequence it states (bit for bit) and within one bf16 step of the
unfused path it replaces (``Ops.bn``'s cast to fp32, batch norm and cast
back, then the bf16 add and relu) at every width the shipped models use;
its schema, Meta kernel and contract; where ``Ops.bn`` takes it and where
it keeps the unfused path; one call per batch norm outside the fused
blocks, 96 a forward of the shipped W48 and W32 models in bf16 inference
and none in train mode or in fp32 / fp64.  The CUDA kernel's own tests
are in tests/test_torch_bn_act_cuda.py."""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.io.weights import bn_affine_tensors
from egonet_tpu_torch.models import hrnet as th
from egonet_tpu_torch.models.layers import Ops
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops.bn_act import bn_act
from tests import fixtures

torch.set_num_threads(2)
# every batch-norm width of W48 and W32 outside the fused blocks (66: the
# coordinates head's 2 x 33 keypoints), then those of PoseResNet-152 (512,
# 1024, 2048) and of PoseNetTPU at its defaults (512 to 4096) that the
# HRNet's do not hold
WIDTHS = (32, 48, 64, 66, 96, 128, 192, 256, 384, 512, 1024, 1536, 2048,
          4096)
OP = "egonet.bn_act.default"


class _Calls(TorchDispatchMode):
    """Counts the egonet operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("egonet."):
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _bn(rng, c):
    m = nn.BatchNorm2d(c).eval()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.uniform(-1.5, 1.5, c)))
        m.bias.copy_(torch.from_numpy(rng.randn(c) * 0.5))
        m.running_mean.copy_(torch.from_numpy(rng.randn(c)))
        m.running_var.copy_(torch.from_numpy(rng.uniform(0.05, 3.0, c)))
    return m


def _nchw(rng, n, c, h, w, scale=2.0):
    """A channels_last NCHW bf16 tensor, as the trunk's convs give."""
    x = torch.from_numpy((rng.randn(n, c, h, w) * scale).astype(np.float32))
    return x.bfloat16().contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _unfused(m, x, residual, relu):
    """Today's path without the operator: (its batch norm rounded to bf16,
    the result)."""
    t = F.batch_norm(x.float(), m.running_mean, m.running_var, m.weight,
                     m.bias, False, 0.0, m.eps).to(torch.bfloat16)
    y = t if residual is None else t + residual
    return t, torch.relu(y) if relu else y


def _steps(a, b):
    """How many bf16 steps lie between each element of a and b."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def _step(v):
    """One bf16 step at the magnitude of each element of v."""
    v = v.float().abs()
    e = torch.floor(torch.log2(torch.where(v > 0, v, torch.ones_like(v))))
    return torch.where(v > 0, torch.exp2(e - 7), torch.zeros_like(v))


def _bound(m, x, t, residual):
    """How far the operator may lie from the unfused path: one bf16 step of
    the batch norm's value t, plus two fp32 steps of its terms x * scale
    and shift (where they cancel, the unfused batch norm's rounded product
    is off by that much; the fused multiply-add is not), and with a
    residual one bf16 step of the sum, which rounds once more."""
    scale, shift = bn_affine_tensors(m.weight, m.bias, m.running_mean,
                                     m.running_var, m.eps)
    view = [1, -1, 1, 1]
    terms = (x.float() * scale.view(view)).abs() + shift.view(view).abs()
    bound = _step(t) + terms * 2.0 ** -22
    if residual is not None:
        bound = bound + _step(t.float() + residual.float())
    return bound


@pytest.fixture(scope="module", autouse=True)
def _ops():
    _build.load_ops("cpu")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_cpu_kernel_is_its_rounding_sequence(c, residual, relu):
    """bf16(fma(x, scale, shift)), then bf16(t + r), then max(t, 0), bit
    for bit (the fused multiply-add taken in fp64, where it is exact)."""
    rng = np.random.RandomState(c + 2 * residual + relu)
    m = _bn(rng, c)
    x = _nchw(rng, 3, c, 5, 7)
    r = _nchw(rng, 3, c, 5, 7) if residual else None
    scale, shift = bn_affine_tensors(m.weight, m.bias, m.running_mean,
                                     m.running_var, m.eps)
    got = bn_act(_nhwc(x), scale, shift, None if r is None else _nhwc(r),
                 relu)
    t = (_nhwc(x).double() * scale.double() + shift.double()).float()
    want = t.bfloat16()
    if r is not None:
        want = (want.float() + _nhwc(r).float()).bfloat16()
    if relu:
        want = torch.where(want < 0, torch.zeros_like(want), want)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 7, c)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# (channels before, C, channels after) of a slice of a wider channels_last
# tensor: fuse_merge's split of a merged conv, and odd offsets and widths
SLICES = [(0, 48, 96), (48, 96, 0), (0, 64, 256), (64, 256, 0), (3, 66, 5),
          (1, 35, 0)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("before,c,after", SLICES)
def test_cpu_kernel_reads_a_channel_slice(before, c, after, residual):
    """x (and the residual) a channel slice of a wider channels_last tensor
    (pixels C + before + after elements apart): the kernel's result is its
    result on the slice made contiguous, bit for bit, and contiguous."""
    rng = np.random.RandomState(before + c + after + residual)
    m = _bn(rng, c)
    wide = [_nchw(rng, 2, before + c + after, 5, 3) for _ in range(2)]
    x, r = (_nhwc(t)[..., before:before + c] for t in wide)
    r = r if residual else None
    scale, shift = bn_affine_tensors(m.weight, m.bias, m.running_mean,
                                     m.running_var, m.eps)
    got = bn_act(x, scale, shift, r, True)
    want = bn_act(x.contiguous(), scale, shift,
                  None if r is None else r.contiguous(), True)
    assert got.is_contiguous()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_cpu_kernel_within_one_bf16_step_of_unfused_path(c, residual, relu):
    """Against the cast, fp32 batch norm, cast, add and relu it replaces:
    within one bf16 step of each rounding (:func:`_bound`); the share of
    elements that differ is printed and stays under 2%."""
    rng = np.random.RandomState(100 + c + 2 * residual + relu)
    m = _bn(rng, c)
    x = _nchw(rng, 3, c, 9, 11)
    r = _nchw(rng, 3, c, 9, 11) if residual else None
    affine = bn_affine_tensors(m.weight, m.bias, m.running_mean,
                               m.running_var, m.eps)
    got = Ops(torch.bfloat16, affine={m: affine}).bn(m, x, relu, r)
    t, want = _unfused(m, x, r, relu)
    differ = float((got != want).float().mean())
    steps = int(_steps(got, want).max())
    print(f"C={c} residual={residual} relu={relu}: {differ:.4%} of "
          f"{want.numel()} elements differ, by {steps} bf16 steps at most")
    assert bool(((got.float() - want.float()).abs()
                 <= _bound(m, x, t, r)).all())
    assert differ < 0.02


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_opcheck(residual, relu):
    """Schema, fake tensor and the CPU kernel against each other."""
    rng = np.random.RandomState(7)
    m = _bn(rng, 48)
    x = _nhwc(_nchw(rng, 2, 48, 4, 6))
    r = _nhwc(_nchw(rng, 2, 48, 4, 6)) if residual else None
    scale, shift = bn_affine_tensors(m.weight, m.bias, m.running_mean,
                                     m.running_var, m.eps)
    torch.library.opcheck(torch.ops.egonet.bn_act.default,
                          (x, scale, shift, r, relu))


def _bad(name, device):
    rng = np.random.RandomState(3)
    x = _nhwc(_nchw(rng, 2, 16, 3, 5).to(device))
    r = _nhwc(_nchw(rng, 2, 16, 3, 5).to(device))
    scale = torch.ones(16, device=device)
    shift = torch.zeros(16, device=device)
    return {
        "x_fp32": (x.float(), scale, shift, None),
        "x_nchw": (x.permute(0, 3, 1, 2), scale, shift, None),
        "x_3d": (x[0], scale, shift, None),
        "x_strided": (x[:, :, ::2], scale, shift, None),
        "scale_short": (x, scale[:8], shift, None),
        "scale_bf16": (x, scale.bfloat16(), shift, None),
        "shift_2d": (x, scale, shift[None], None),
        "residual_shape": (x, scale, shift, r[:1]),
        "residual_fp32": (x, scale, shift, r.float()),
        "residual_nchw": (x, scale, shift, r.permute(0, 3, 1, 2)),
        # channels two apart; pixels closer than C (overlapping)
        "x_channel_gap": (_nhwc(_nchw(rng, 2, 32, 3, 5).to(device))[..., ::2],
                          scale, shift, None),
        "x_overlapping": (x.as_strided(x.shape, (15 * 8, 5 * 8, 8, 1)),
                          scale, shift, None),
        # rows and columns swapped in storage
        "residual_strided": (x, scale, shift,
                             r.transpose(1, 2).contiguous().transpose(1, 2)),
    }[name]


BAD = ("x_fp32", "x_nchw", "x_3d", "x_strided", "scale_short", "scale_bf16",
       "shift_2d", "residual_shape", "residual_fp32", "residual_nchw",
       "x_channel_gap", "x_overlapping", "residual_strided")


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", BAD)
def test_contract_refuses(name, device):
    """The CPU and Meta kernels refuse what the CUDA kernel could not run,
    with the same check (egonet_ops.h, check_bn_act)."""
    with pytest.raises(ValueError):
        torch.ops.egonet.bn_act.default(*_bad(name, device), True)


def test_meta_kernel_is_the_contract():
    x = torch.empty(5, 9, 7, 66, dtype=torch.bfloat16, device="meta")
    s = torch.empty(66, device="meta")
    y = torch.ops.egonet.bn_act.default(x, s, s, x, True)
    assert y.device.type == "meta" and y.dtype == torch.bfloat16
    assert y.shape == x.shape and y.is_contiguous()


# (what changes from the operator's case, what Ops.bn does: one operator
# call, the unfused ops, or the operator refusing the layout)
PATHS = {
    "bf16_eval": "op",
    "bf16_eval_residual": "op",
    "channel_slice": "op",
    "train_mode": "unfused",
    "fp32": "unfused",
    "fp64": "unfused",
    "nchw_input": "refused",
    "nchw_residual": "refused",
    "no_table_entry": "unfused",
}


@pytest.mark.parametrize("case", sorted(PATHS))
def test_ops_bn_takes_the_operator_only_where_it_can(case):
    """Eval mode with the module's (scale, shift) in the table (bf16
    inference): one operator call on NHWC storage (channels_last, or a
    channel slice of it), and a ValueError for any other layout, never a
    silent second path.  Otherwise the unfused path, bit for bit what it
    computed before the operator."""
    rng = np.random.RandomState(11)
    m = _bn(rng, 32)
    x = _nchw(rng, 2, 32, 6, 5)
    r = _nchw(rng, 2, 32, 6, 5) if case != "bf16_eval" else None
    dtype = {"fp32": torch.float32, "fp64": torch.float64}.get(case,
                                                               torch.bfloat16)
    if case == "fp64":
        m = m.double()
    x, r = x.to(dtype), None if r is None else r.to(dtype)
    if case == "nchw_input":
        x = x.contiguous()
    if case == "nchw_residual":
        r = r.contiguous()
    if case == "channel_slice":
        x = torch.split(_nchw(rng, 2, 80, 6, 5), [48, 32], dim=1)[1]
    affine = {} if case == "no_table_entry" else {
        m: bn_affine_tensors(m.weight, m.bias, m.running_mean,
                             m.running_var, m.eps)}
    if case == "train_mode":
        m.train()
    before = (m.running_mean.clone(), m.running_var.clone())
    ops = Ops(dtype, affine=affine)
    if PATHS[case] == "refused":
        with pytest.raises(ValueError, match="NHWC|layout"):
            ops.bn(m, x, relu=True, residual=r)
        return
    with _Calls() as calls:
        got = ops.bn(m, x, relu=True, residual=r)
    assert calls.calls.get(OP, 0) == int(PATHS[case] == "op")
    if PATHS[case] == "op":
        assert got.is_contiguous(memory_format=torch.channels_last)
        t, want = _unfused(m, x, r, True)
        assert bool(((got.float() - want.float()).abs()
                     <= _bound(m, x, t, r)).all())
        return
    if case == "train_mode":
        m.running_mean.copy_(before[0])
        m.running_var.copy_(before[1])
    stat = torch.promote_types(torch.float32, dtype)
    from egonet_tpu_torch.models.layers import batch_norm
    want = batch_norm(m, x, stat).to(dtype)
    want = torch.relu(want if r is None else want + r)
    assert torch.equal(got, want)


# (compute dtype, mode, bn_act calls, fused-block calls) a forward
FORWARDS = [("bfloat16", "eval", 96, 104), ("bfloat16", "train", 0, 0),
            ("float32", "eval", 0, 0)]


@pytest.mark.parametrize("dtype,mode,bn_acts,fused", FORWARDS)
@pytest.mark.parametrize("name", ["demo_config", "train_igrs_ped_config"])
def test_shipped_models_call_it_96_times_a_forward(name, dtype, mode,
                                                   bn_acts, fused):
    """The shipped W48 and W32 models (fake tensors: shapes and strides
    only): 96 batch-norm sites a bf16 inference forward (the stem 2,
    layer1 13, the transitions 4, the fuse layers 65, head2 12) beside the
    104 fused blocks; none in train mode or in fp32 (fp64: below, on a
    shrunk model: fake tensors do not take ``.double()``)."""
    cfg = getattr(tcfg, name)()
    w, h = cfg["heatmapModel"]["input_size"]
    with FakeTensorMode():
        net = th.build_hrnet(cfg, dtype=getattr(torch, dtype))
        net.train(mode == "train")
        x = torch.empty(3, 3, h, w)
        with torch.no_grad(), _Calls() as calls:
            net(x)
    assert calls.calls.get(OP, 0) == bn_acts
    assert calls.calls.get("egonet.fused_basic_block.default", 0) == fused
    if dtype == "bfloat16" and mode == "eval":
        assert len(net.inference_cache()["affine"]) == 96


@pytest.mark.parametrize("dtype,mode,bn_acts", [
    ("bfloat16", "eval", 62), ("bfloat16", "train", 0),
    ("float32", "eval", 0)])
def test_native_model_calls_it_once_a_batch_norm(dtype, mode, bn_acts):
    """PoseNetTPU at its defaults (fake tensors: shapes and strides only):
    each of its 62 batch norms is one call a bf16 inference forward, the
    depthwise convs' and the pixel-shuffled FPN's outputs included (the
    operator refuses any layout but NHWC storage); none in train mode or
    in fp32."""
    from egonet_tpu_torch.models.factory import build_heatmap_model
    cfg = tcfg.native_demo_config()
    w, h = cfg["heatmapModel"]["input_size"]
    with FakeTensorMode():
        net = build_heatmap_model(cfg, dtype=getattr(torch, dtype))
        net.train(mode == "train")
        x = torch.empty(3, 3, h, w)
        with torch.no_grad(), _Calls() as calls:
            net(x)
    assert calls.calls.get(OP, 0) == bn_acts
    assert sum(isinstance(m, nn.BatchNorm2d) for m in net.modules()) == 62


@pytest.mark.parametrize("name", ["demo_config", "train_igrs_ped_config"])
def test_shipped_models_with_fuse_merge_call_it_96_times(name):
    """fuse_merge splits a merged conv into channel views, which the
    operator reads in place: still 96 calls a bf16 inference forward, 38 of
    them on views."""
    cfg = getattr(tcfg, name)()
    cfg["heatmapModel"]["fuse_merge"] = True
    w, h = cfg["heatmapModel"]["input_size"]
    with FakeTensorMode():
        net = th.build_hrnet(cfg, dtype=torch.bfloat16).eval()
        x = torch.empty(3, 3, h, w)
        with torch.no_grad(), _Calls() as calls:
            net(x)
    views = sum(len(g) for g in net._merge_groups() if len(g) > 1)
    assert views == 38
    assert calls.calls.get(OP, 0) == 96
    assert calls.calls.get("egonet.fused_basic_block.default", 0) == 104


def _shrunk(dtype=torch.bfloat16, **heatmap):
    """The demo HRNet at widths 8/16/32/64 (a width-8 branch runs its
    BasicBlocks unfused) with stage 3 and 4 of two modules, batch-norm
    statistics drawn."""
    cfg = fixtures.shrink_hrnet(tcfg.demo_config(), num_modules=(1, 2, 2))
    cfg["heatmapModel"].update(heatmap)
    torch.manual_seed(0)
    net = th.build_hrnet(cfg, dtype=dtype)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(
                    rng.randn(m.num_features) * 0.1))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, m.num_features)))
    return net.eval()


@pytest.mark.parametrize("variant", ["plain", "fuse_merge", "act_quant"])
def test_shrunk_hrnet_against_the_unfused_path(variant):
    """A shrunk bf16 HRNet: one call per entry of the table a forward
    (fuse_merge's channel views of a merged conv among them), and its
    keypoints within bf16 rounding of the same model with the table
    emptied (every batch norm unfused)."""
    opts = {"fuse_merge": {"fuse_merge": True},
            "act_quant": {"act_quant": "int8"}}.get(variant, {})
    net = _shrunk(**opts)
    x = torch.from_numpy(np.random.RandomState(9).randn(
        4, 3, 64, 64).astype(np.float32))
    cache = net.inference_cache()
    with torch.no_grad(), _Calls() as calls:
        maps, coords = net(x)
    n = calls.calls.get(OP, 0)
    assert n == len(cache["affine"]) and n > 0
    affine, cache["affine"] = cache["affine"], {}
    try:
        with torch.no_grad(), _Calls() as calls:
            umaps, ucoords = net(x)
    finally:
        cache["affine"] = affine
    assert calls.calls.get(OP, 0) == 0
    gap = float((maps - umaps).abs().max())
    assert gap <= 0.02 * float(umaps.abs().max()), gap
    assert float((coords - ucoords).abs().max()) < 0.02


@pytest.mark.parametrize("dtype,mode", [("bfloat16", "train"),
                                        ("float32", "eval"),
                                        ("float64", "eval")])
def test_shrunk_hrnet_other_paths_never_call_it(dtype, mode):
    """Train mode and fp32 / fp64 models keep every batch norm unfused:
    their tables hold no (scale, shift) and nothing calls the operator."""
    net = _shrunk(getattr(torch, dtype)).train(mode == "train")
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2, 3, 64, 64).astype(np.float32))
    with torch.no_grad(), _Calls() as calls:
        net(x)
    assert calls.calls.get(OP, 0) == 0
    cache = net.inference_cache()
    assert cache is None if mode == "train" else cache["affine"] == {}


def test_table_follows_the_parameters():
    """The (scale, shift) table is built from the current statistics and
    rebuilt by load_state_dict, as the cast weights are."""
    net = _shrunk()
    m = net.stage2[0].fuse_layers[0][1][1]
    scale, _ = net.inference_cache()["affine"][m]
    assert torch.equal(scale, m.weight / torch.sqrt(m.running_var + m.eps))
    state = net.state_dict()
    key = [k for k, v in net.named_modules() if v is m][0]
    state[key + ".running_var"] = state[key + ".running_var"] * 4.0
    net.load_state_dict(state)
    new_scale, new_shift = net.inference_cache()["affine"][m]
    assert torch.equal(new_scale,
                       m.weight / torch.sqrt(m.running_var + m.eps))
    assert torch.equal(new_shift, m.bias - m.running_mean * new_scale)
    torch.testing.assert_close(new_scale, scale / 2.0, rtol=1e-4, atol=0)
    net.train()
    assert net.inference_cache() is None
