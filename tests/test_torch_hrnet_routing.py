"""Which HRNet branch blocks the port sends to a fused kernel, by width.

A kernel serves a channel width only where its default library has a plan
for it (``fused_block.takes`` / ``fused_block_stencil.takes``: C % 16 ==
0, C at most the kernel's ``_MAX_C``, a tile that fits).  The HRNet folds
and fuses only those blocks and runs the others unfused, on every device.
Here the CUDA route is faked on the CPU: the public wrapper calls a
stand-in of the C++ operator's CUDA kernel (``csrc/egonet_ops_cuda.cpp``:
the operand contract, then the width's default plan from the table
``_build`` generates for it, a width without one raising), whose launch
computes the plain version, counted by width.  A block the kernel does
not take would raise there, as it did on the card before the routing
looked at the width.
"""

import re

import numpy as np
import pytest
import torch

from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.models import hrnet as th
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops import fused_block as fb
from egonet_tpu_torch.ops import fused_block_stencil as st

torch.set_num_threads(2)
KERNELS = {"tiled": fb, "stencil": st}
WIDTHS = {"gate": (8, 16, 32, 64), "w18": (18, 36, 72, 144),
          "w48": (48, 96, 192, 384), "w64": (64, 128, 256, 512)}


def _plan_table(macro):
    """{C: plan fields} of the CUDA operator's plan table for one kernel
    (``_build._plans_prelude``, macro TILED or STENCIL)."""
    line = next(ln for ln in _build._plans_prelude().splitlines()
                if ln.startswith(f"#define EGONET_{macro}_PLANS(X) "))
    rows = re.findall(r"X\(([^)]*)\)", line.split(" ", 2)[2])
    table = {}
    for row in rows:
        c, *fields = map(int, row.split(","))
        table[c] = fields
    return table


def _wrapper(module):
    return getattr(module, "fused_basic_block" if module is fb
                   else "fused_basic_block_stencil")


@pytest.fixture
def cuda_route(monkeypatch):
    """A fake of each operator's CUDA kernel behind both public wrappers:
    the operand contract (the op's Meta kernel), the width's default plan
    from its table (raising ValueError where it has none), then the launch,
    counted by (kernel, C), which runs the plain version.  Returns the
    counts."""
    _build.load_ops("cpu")
    counts = {}
    for name, module in KERNELS.items():
        packet = getattr(torch.ops.egonet, _wrapper(module).__name__)
        table = _plan_table("TILED" if module is fb else "STENCIL")

        def op(x, w1, b1, w2, b2, plan=None, name=name, module=module,
               real=packet.default, table=table):
            assert plan is None
            real(*(t.to("meta") for t in (x, w1, b1, w2, b2)))
            c = x.shape[3]
            if c not in table:
                raise ValueError(f"no default plan at C={c}")
            default = module.plan_for(c)
            assert table[c] == [getattr(default, f)
                                for f in module._PLAN_FIELDS]
            counts[(name, c)] = counts.get((name, c), 0) + 1
            return fb.fused_basic_block_reference(x, w1, b1, w2, b2)

        monkeypatch.setattr(packet, "default", op)
    return counts


def _operands(c, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 4, 4, c, generator=g).to(torch.bfloat16)
    w = (0.05 * torch.randn(c, 3, 3, c, generator=g)).to(torch.bfloat16)
    b = 0.1 * torch.randn(c, generator=g)
    return x, w, b


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("c", [8, 18, 32, 48, 144, 384, 400, 512])
def test_takes_is_what_the_cuda_route_launches(cuda_route, kernel, c):
    """``takes(c)`` holds exactly where the faked CUDA route launches;
    elsewhere the operator's checks raise before any launch."""
    module = KERNELS[kernel]
    x, w, b = _operands(c)
    if module.takes(c):
        y = _wrapper(module)(x, w, b, w, b)
        assert cuda_route == {(kernel, c): 1}
        torch.testing.assert_close(
            y, fb.fused_basic_block_reference(x, w, b, w, b), atol=0,
            rtol=0)
    else:
        with pytest.raises(ValueError):
            _wrapper(module)(x, w, b, w, b)
        assert cuda_route == {}


def _cfg(widths):
    cfg = tcfg.demo_config()
    extra = cfg["heatmapModel"]["extra"]
    for n, s in ((2, "stage2"), (3, "stage3"), (4, "stage4")):
        extra[s].update({"num_channels": list(widths[:n]),
                         "num_blocks": [1] * n, "num_modules": 1})
    cfg["heatmapModel"]["input_size"] = [64, 64]
    cfg["heatmapModel"]["heatmap_size"] = [16, 16]
    return cfg


def _randomize_stats(net, seed):
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                   generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.num_features,
                                                 generator=g))
    return net


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("family", sorted(WIDTHS))
def test_bf16_hrnet_fuses_only_the_widths_its_kernel_takes(
        cuda_route, kernel, family):
    """A bf16 HRNet (one block per branch: 3 + 3 + 2 + 1 blocks at the
    four widths) launches the chosen kernel once per block whose width
    it takes, runs the others unfused without raising, and lands within
    bf16 rounding of its all-unfused forward (coords 0.02, maps 2% of
    their largest value)."""
    widths = WIDTHS[family]
    net = th.build_hrnet(_cfg(widths), dtype=torch.bfloat16)
    net = _randomize_stats(numpy_init(net, 3), 4).eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        net.prepare_inference(stencil="1" if kernel == "stencil" else "0")
        maps, coords = net(x)
        launched = dict(cuda_route)
        net.fuse_blocks = False
        umaps, ucoords = net(x)
    assert cuda_route == launched            # the unfused pass launches none
    per_width = dict(zip(widths, (3, 3, 2, 1)))
    want = {(kernel, c): n for c, n in per_width.items()
            if KERNELS[kernel].takes(c)}
    assert launched == want
    taken = sum(want.values())
    assert taken == sum(1 for _ in net._fusable_blocks(kernel == "stencil"))
    assert taken == {"gate": 6, "w18": 1, "w48": 9, "w64": 8}[family]
    assert torch.isfinite(coords).all() and torch.isfinite(maps).all()
    torch.testing.assert_close(coords.float(), ucoords.float(), atol=0.02,
                               rtol=0)
    # the maps reach ~12, where one bf16 step is 0.0625
    gap = float((maps.float() - umaps.float()).abs().max())
    assert gap <= 0.02 * float(umaps.float().abs().max()), gap


@pytest.mark.parametrize("name", ["demo_config", "train_igrs_ped_config"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_shipped_w48_and_w32_keep_104_fused_blocks(name, kernel):
    """The shipped W48 (48/96/192/384) and W32 (32/64/128/256) configs:
    every one of their 104 stride-1 identity branch blocks is fused by
    either kernel (built on the meta device: structure only)."""
    with torch.device("meta"):
        net = th.build_hrnet(getattr(tcfg, name)(), dtype=torch.bfloat16)
    assert sum(1 for _ in net._fusable_blocks(kernel == "stencil")) == 104
