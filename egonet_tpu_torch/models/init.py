"""Seeded NumPy initialization, matching ``egonet_tpu/models/
initialization.py`` value for value: LeCun-normal conv/linear kernels
(std = sqrt(1/fan_in), fan_in = the product of all but the kernel's last
axis), zero biases and identity batch norm (2-D and 1-D), drawn from
``np.random.default_rng(rng_seed)`` in the JAX package's order (kernels of
the modules sorted by name, each drawn in the flax kernel's shape: HWIO
for a conv, (3, 3, 1, C) for a depthwise one, IO for a dense layer, and
(kh, kw, C_out, C_in) for a transposed conv with ``transpose_kernel``) —
so ``EgoNet(cfg, rng_seed=s)`` gets the same weights in both packages."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


@torch.no_grad()
def numpy_init(model: nn.Module, rng_seed: int) -> nn.Module:
    rng = np.random.default_rng(rng_seed)
    kernels = {name: m for name, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))}
    for name in sorted(kernels):
        m = kernels[name]
        w = m.weight
        if w.dim() == 4:
            # OIHW <- HWIO; a transposed conv's [in, out, kh, kw] <- flax's
            # (kh, kw, out, in): the same axis swap
            shape = (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
            val = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])),
                             size=shape).transpose(3, 2, 0, 1)
        else:                                              # OI <- IO
            shape = (w.shape[1], w.shape[0])
            val = rng.normal(0.0, np.sqrt(1.0 / shape[0]), size=shape).T
        w.copy_(torch.from_numpy(np.ascontiguousarray(val, np.float32)))
        if m.bias is not None:
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return model
