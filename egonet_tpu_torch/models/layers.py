"""Layer primitives shared by the port's models (the three heatmap
families and the FC lifter).

``batch_norm`` is the JAX package's batch norm (flax ``BatchNorm`` with
``use_fast_variance=False``): train mode normalizes with the biased batch
statistics and moves the running variance with the biased batch variance;
in a data-parallel run the statistics are the global batch's.
``Ops`` runs a model's layers in its compute dtype, from pre-cast inference
weights where a model has them, with the int8 activation transport
(``act_quant``) of the JAX package; ``CachedInference`` is the base of the
heatmap models, which builds those weights and drops them whenever the
parameters may move.  Where a model's table holds a batch norm's affine
(in bf16 inference, the HRNet's and the PoseResNet's), ``Ops.bn`` runs that
batch norm with the residual add and relu after it as one pass
(``ops/bn_act.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from egonet_tpu_torch.io.weights import bn_affine_tensors
from egonet_tpu_torch.ops import bn_act
from egonet_tpu_torch.parallel import mesh

BN_MOMENTUM = 0.1


def batch_norm(m: nn.modules.batchnorm._BatchNorm, x, stat_dtype):
    """``m`` on ``x`` computed in ``stat_dtype``.  In train mode: normalize
    with the batch statistics, and move the running buffers by the JAX
    package's rule, the biased batch variance (flax ``BatchNorm``).
    ``F.batch_norm`` moves ``running_var`` with the unbiased variance v_u
    in the same kernel that normalizes; the biased v_u (n-1)/n is restored
    from the buffer before and after (v_u = (new - (1-m) old) / m, so
    new - m v_u / n = new - (new - (1-m) old) / n), on C values, without a
    second pass over the activations."""
    x = x.to(stat_dtype)
    if not m.training:
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight,
                            m.bias, False, 0.0, m.eps)
    if mesh.active():
        return _group_batch_norm(m, x)
    # the kernel moves a copy (autograd keeps it for the backward)
    moved = m.running_var.clone()
    y = F.batch_norm(x, m.running_mean, moved, m.weight, m.bias, True,
                     m.momentum, m.eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        old = m.running_var.mul_(1.0 - m.momentum)
        old.sub_(moved).div_(n).add_(moved)
        m.num_batches_tracked.add_(1)
    return y


def _group_batch_norm(m: nn.modules.batchnorm._BatchNorm, x):
    """Train-mode batch norm over the instance axis of every rank of the
    process group (the JAX mesh step's statistics over the global batch,
    wrap rows included): the global mean, then the global biased variance
    of the centred values (two passes: E[x^2] - E[x]^2 cancels), each a
    differentiable sum over the ranks.  The global count needs no
    collective: every rank holds an equal shard of a static-shape batch
    (``parallel/mesh.shard_batch``).  The running buffers move by the
    biased variance, as in one process."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    count = x.numel() // x.shape[1] * mesh.world()
    mean = mesh.all_reduce_sum(x.sum(dims)) / count
    xc = x - mean.view(shape)
    var = mesh.all_reduce_sum((xc * xc).sum(dims)) / count
    y = xc * torch.rsqrt(var + m.eps).view(shape)
    y = y * m.weight.to(x.dtype).view(shape) + m.bias.to(x.dtype).view(shape)
    with torch.no_grad():
        m.running_mean.mul_(1.0 - m.momentum).add_(
            mean.detach().to(m.running_mean.dtype), alpha=m.momentum)
        m.running_var.mul_(1.0 - m.momentum).add_(
            var.detach().to(m.running_var.dtype), alpha=m.momentum)
        m.num_batches_tracked.add_(1)
    return y


def conv(cin, cout, k, stride=1, padding=None, bias=False, groups=1):
    if padding is None:
        padding = (k - 1) // 2
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias, groups=groups)


def bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


def conv_bn(cin, cout, k, stride=1, padding=None):
    return nn.Sequential(conv(cin, cout, k, stride, padding), bn(cout))


def pixel_shuffle(x, r: int):
    """NCHW channel-to-space in ``nn.PixelShuffle`` order (input channel
    c*r*r + dy*r + dx lands at (c, y*r + dy, x*r + dx)); the JAX package's
    NHWC ``_pixel_shuffle`` uses the same order."""
    return F.pixel_shuffle(x, r) if r > 1 else x


class Ops:
    """The primitive layers, parameterized by the compute dtype, an
    optional table of pre-cast weights (``CachedInference``), an optional
    table of batch norms' (scale, shift) and the activation transport.
    Batch norm runs in fp32 for fp32 and bf16 models, in fp64 for fp64
    ones."""

    merge = False          # the HRNet's fuse_merge switch (models/hrnet.py)

    def __init__(self, dtype, cast=None, act_quant="none",
                 act_quant_scale=8.0, affine=None):
        self.dtype = dtype
        self.stat_dtype = torch.promote_types(torch.float32, dtype)
        self.cast = cast or {}
        self.affine = affine or {}
        self.act_quant = act_quant
        self.act_quant_scale = float(act_quant_scale)

    def weight(self, m):
        w = self.cast.get(m)
        return m.weight.to(self.dtype) if w is None else w

    def conv(self, m: nn.Conv2d, x):
        b = None if m.bias is None else m.bias.to(self.dtype)
        return F.conv2d(x, self.weight(m), b, m.stride, m.padding,
                        m.dilation, m.groups)

    def conv_transpose(self, m: nn.ConvTranspose2d, x):
        b = None if m.bias is None else m.bias.to(self.dtype)
        return F.conv_transpose2d(x, self.weight(m), b, m.stride, m.padding,
                                  m.output_padding, m.groups, m.dilation)

    def linear(self, m: nn.Linear, x):
        """A dense layer in the statistics dtype (the JAX heads' Dense runs
        in fp32 at full precision, fp64 in an fp64 model)."""
        return F.linear(x.to(self.stat_dtype), m.weight.to(self.stat_dtype),
                        m.bias.to(self.stat_dtype))

    def bn(self, m: nn.BatchNorm2d, x, relu: bool = False, residual=None):
        """``m`` on ``x`` in the compute dtype, then ``+ residual`` and
        relu where asked.  In bf16 eval mode with ``m``'s (scale, shift)
        in the table one ``bn_act`` pass, which takes NHWC storage
        (``channels_last``, or a channel slice of it) and refuses any other
        layout; else (train mode, fp32, fp64) batch norm in the statistics
        dtype, the cast back, the add and the relu, each a pass."""
        affine = self.affine.get(m)
        if (affine is not None and not m.training
                and self.dtype == torch.bfloat16):
            y = bn_act.bn_act(
                x.permute(0, 2, 3, 1), *affine,
                None if residual is None else residual.permute(0, 2, 3, 1),
                relu)
            return y.permute(0, 3, 1, 2)
        y = batch_norm(m, x, self.stat_dtype).to(self.dtype)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y

    def conv_bn(self, seq: nn.Sequential, x, relu: bool = False,
                residual=None):
        return self.bn(seq[1], self.conv(seq[0], x), relu, residual)

    def transport(self, x):
        """Quantize-dequantize a post-ReLU tensor crossing a fusion boundary
        when ``act_quant`` is 'int8' (identity otherwise), as the JAX
        package does: uint8 codes clip(round(x * 255 / scale), 0, 255) of x
        in fp32 (round half to even in both), times scale / 255 in the
        compute dtype.  The rounding has a zero gradient in both: the uint8
        cast cuts the graph here, so ``0 * x`` hands the input a zero
        gradient, as JAX's does."""
        if self.act_quant != "int8":
            return x
        inv_step = 255.0 / self.act_quant_scale
        q = torch.clamp(torch.round(x.float() * inv_step), 0.0, 255.0).to(
            torch.uint8)
        y = q.to(self.dtype) * torch.tensor(1.0 / inv_step, dtype=self.dtype,
                                            device=x.device)
        return y + 0.0 * x if x.requires_grad else y


class CachedInference(nn.Module):
    """Base of the heatmap models: ``prepare_inference`` pre-casts every
    conv weight to the compute dtype once (bf16 models; channels_last) and
    derives each batch norm's fp32 (scale, shift) for ``Ops.bn``'s
    ``bn_act`` pass (bf16 models), and the
    table is dropped on ``load_state_dict`` (then rebuilt), when the
    parameters move (``.to``) and when train mode is entered.
    ``forward`` builds it on the first eval call.  Subclasses extend
    :meth:`_build_cache`."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype
        self._inference_cache = None

    def _build_cache(self, folded=frozenset()) -> dict:
        """{'cast': {conv: bf16 channels_last weight}, 'affine': {batch
        norm: (scale, shift)}} from the current parameters; the batch norms
        in ``folded`` (folded into a fused kernel's weights) get no
        entry."""
        cache = {"cast": {}, "affine": {}}
        if self.dtype == torch.bfloat16:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    cache["cast"][m] = m.weight.detach().to(
                        self.dtype, memory_format=torch.channels_last)
                elif isinstance(m, nn.BatchNorm2d) and m not in folded:
                    cache["affine"][m] = bn_affine_tensors(
                        m.weight, m.bias, m.running_mean, m.running_var,
                        m.eps)
        return cache

    def prepare_inference(self, stencil: str | None = None):
        """Build the table now.  ``stencil`` is the HRNet's choice of
        fused-block kernel (``hrnet.PoseHighResolutionNet``); a model
        without fused blocks takes it and does nothing with it."""
        with torch.no_grad():
            self._inference_cache = self._build_cache()
        return self

    def inference_cache(self):
        """The table in eval mode (built on first use), None in train
        mode."""
        if self.training:
            return None
        if self._inference_cache is None:
            self.prepare_inference()
        return self._inference_cache

    def load_state_dict(self, state_dict, strict: bool = True, **kw):
        result = super().load_state_dict(state_dict, strict=strict, **kw)
        self.prepare_inference()
        return result

    def _apply(self, fn, *args, **kw):
        self._inference_cache = None
        return super()._apply(fn, *args, **kw)

    def train(self, mode: bool = True):
        if mode:
            self._inference_cache = None
        return super().train(mode)
