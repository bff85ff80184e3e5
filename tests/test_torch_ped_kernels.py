"""Both fused BasicBlock kernels at the W32 pedestrian model's shapes:
branch widths 32 / 64 / 128 / 256 at 48x48 / 24x24 / 12x12 / 6x6 maps
(192x192 crops), 104 launches per forward.

On the CPU: the plain version (the function both kernels compute) at
those shapes against the JAX package's ``reference_basic_block``, each
width's launch plans (they fit in shared memory, cover every position
once and spend little of the tile on padding), and a width no plan serves
raising rather than leaving the kernel.  The kernels themselves run only
on the card: the ``cuda`` cases skip without one (``chip_smoke.py``'s
``kernel_ped`` phase runs them at batch 32 and times them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egonet_tpu.ops import pallas_block as pb
from egonet_tpu_torch.ops import fused_block as fb
from egonet_tpu_torch.ops import fused_block_stencil as st
from tests.test_torch_fused_block import _check_plan, _check_rows
from tests.test_torch_fused_block import _table_tile
from tests.test_torch_fused_block import _random_block

PED_SHAPES = ((32, 48), (64, 24), (128, 12), (256, 6))


@pytest.mark.parametrize("C,H", PED_SHAPES)
def test_plain_version_matches_xla_reference(rng, C, H):
    """fp32 operands: the folded block against the JAX package's unfolded
    reference (conv, BN, ReLU, conv, BN, residual, ReLU)."""
    torch.set_num_threads(2)
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = np.abs(rng.randn(2, H, H, C)).astype(np.float32)
    ref = np.asarray(pb.reference_basic_block(jnp.asarray(x), w1, bn1,
                                              w2, bn2))
    packed = fb.pack_block_weights(w1, bn1, w2, bn2)
    got = fb.fused_basic_block_reference(
        torch.from_numpy(x),
        torch.from_numpy(packed["w1"]).reshape(C, 3, 3, C),
        torch.from_numpy(packed["b1"]).reshape(-1),
        torch.from_numpy(packed["w2"]).reshape(C, 3, 3, C),
        torch.from_numpy(packed["b2"]).reshape(-1))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4,
                               rtol=1e-5 * C)


@pytest.mark.parametrize("C,H", PED_SHAPES)
def test_tiled_plan_fits_covers_and_wastes_little(C, H):
    """The tiled kernel's plan at each pedestrian width: its shared-memory
    layout, every GEMM row once, and tiles that divide the map (no
    padding positions computed)."""
    plan = fb.plan_for(C)
    assert _table_tile(plan) == tuple(fb.tile_for(C))
    assert C in fb._TILES
    _check_plan(plan)
    for conv in (1, 2):
        _check_rows(plan, conv)
    assert H % plan.th == 0 and H % plan.tw == 0, plan


@pytest.mark.parametrize("C,H", PED_SHAPES)
def test_stencil_plan_fits_and_spans_the_map(C, H):
    """The stencil's plan at each pedestrian width fits, and its column
    tile divides the map's width (no padded columns swept)."""
    from tests.test_torch_stencil import _check_plan as check_stencil
    plan = st.plan_for(C)
    assert plan.tile == tuple(st.tile_for(C)) and C in st._TILES
    check_stencil(plan)
    assert H % plan.tw == 0 and H % plan.rh == 0, plan


def test_a_width_no_plan_serves_raises():
    """No silent way out of the kernel: a width that is no multiple of 16
    or is past the widest the kernels serve has no plan, and the wrapper
    checks its operands before any launch: the operator's contract
    (``check_contract``, run here by its Meta kernel; the CPU kernel, the
    plain version, takes any width)."""
    for c in (24, 40):
        with pytest.raises(ValueError):
            fb.plan_for(c)
        with pytest.raises(ValueError):
            st.plan_for(c)
    with pytest.raises(ValueError):
        fb.plan_for(fb._MAX_C + 16)
    x = torch.zeros(1, 6, 6, 24, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(24, 3, 3, 24, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(24, device="meta")
    with pytest.raises(ValueError, match="not a multiple of 16"):
        fb.fused_basic_block(x, w, b, w, b)


def _kernel_case(wrapper, counter, C, H, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(C)
    std = (1.0 / (9 * C)) ** 0.5
    x = torch.relu(torch.randn(B, H, H, C, device="cuda",
                               generator=g)).bfloat16()
    w1 = (torch.randn(C, 3, 3, C, device="cuda", generator=g)
          * std).bfloat16()
    w2 = (torch.randn(C, 3, 3, C, device="cuda", generator=g)
          * std).bfloat16()
    b1 = torch.randn(C, device="cuda", generator=g) * 0.1
    b2 = torch.randn(C, device="cuda", generator=g) * 0.1
    before = counter.launches
    y = wrapper(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = fb.fused_basic_block_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(y.float(), ref.float(), atol=5e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 3])
@pytest.mark.parametrize("C,H", PED_SHAPES)
def test_tiled_kernel_matches_plain_version(C, H, B):
    _kernel_case(fb.fused_basic_block, fb.fused_basic_block, C, H, B)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [32, 3])
@pytest.mark.parametrize("C,H", PED_SHAPES)
def test_stencil_kernel_matches_plain_version(C, H, B):
    _kernel_case(st.fused_basic_block_stencil, st.fused_basic_block_stencil,
                 C, H, B)
