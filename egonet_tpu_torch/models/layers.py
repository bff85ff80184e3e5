"""Layer primitives shared by the port's models (HRNet and the FC lifter).

``batch_norm`` is the JAX package's batch norm (flax ``BatchNorm`` with
``use_fast_variance=False``): train mode normalizes with the biased batch
statistics and moves the running variance with the biased batch variance.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
