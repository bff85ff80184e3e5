"""An inference batch norm's epilogue as one hand-written kernel: the
operator ``egonet::bn_act`` (``csrc/bn_act.cuh``, ``csrc/bn_act.cu``,
registered in ``csrc/egonet_ops*.cpp``).

``x`` [N, H, W, C] bf16 with adjacent channels and evenly spaced pixels
(a ``channels_last`` NCHW tensor permuted, or a channel slice of one, as
``fuse_merge``'s split of a merged conv gives), ``scale`` and ``shift``
[C] fp32 (``gamma / sqrt(var + eps)`` and ``beta - mean * scale``,
``io/weights.bn_affine_tensors``), an optional ``residual`` of x's sizes,
dtype and kind of layout, and ``relu`` -> y of x's sizes (contiguous
NHWC), each element ``bf16(x * scale + shift)`` (one fused multiply-add),
then ``bf16(y + residual)``, then ``max(y, 0)``: the roundings of the
unfused path (``models/layers.Ops.bn``: the cast to fp32, the batch norm,
the cast back, then a bf16 add and relu), in one read and one write on the
card instead of three passes and one or two more.  The CPU kernel runs the
same per-element routine, bit for bit the card's; the Meta kernel holds
the contract, so ``torch.export`` traces the op as one node.

``bn_act.launches`` counts the CUDA kernel's launches (and nothing else).
"""

from __future__ import annotations

import torch

from egonet_tpu_torch.ops import _build


@_build.counted(_build.BN_ACT)
def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           residual: torch.Tensor | None = None,
           relu: bool = False) -> torch.Tensor:
    """relu?(bf16(x * scale + shift) + residual?) of NHWC bf16 ``x``, on
    its device: the CUDA kernel on the current stream of a CUDA tensor, the
    per-element loop on the CPU."""
    _build.load_ops(x.device.type)
    return torch.ops.egonet.bn_act.default(x, scale, shift, residual, relu)
