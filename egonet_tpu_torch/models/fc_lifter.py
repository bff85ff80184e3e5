"""Fully-connected 2D->3D lifting network in PyTorch.  Port of
``egonet_tpu/models/fc_lifter.py``.

Linear(in, 1024) + BN + ReLU + Dropout, N residual blocks
(Linear-BN-ReLU-Drop x 2 with a skip), Linear(1024, out).  Module names
equal the reference ``state_dict`` keys (w1, batch_norm1, res_blocks.{i}.w1,
..., w2).  Linears run in the compute dtype; batch norm runs on fp32
statistics (fp64 in an fp64 model, whose parameters are fp64) with the JAX
package's train-mode rule (``layers.batch_norm``); the output is fp32
(fp64).  Dropout draws its mask from a ``torch.Generator`` when one is
given.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from egonet_tpu_torch.models.layers import batch_norm


def dropout(x, p: float, generator: torch.Generator | None, rows=None):
    """Inverted dropout (keep with probability 1-p, scale by 1/(1-p)), the
    mask drawn from ``generator`` (torch's global stream when None).
    ``rows`` = (start, total): ``x`` holds rows [start, start + len(x)) of
    a batch of ``total`` rows (one rank's shard of a data-parallel batch),
    and the mask is that batch's, drawn whole, so it does not depend on
    how the batch is split."""
    if p <= 0.0:
        return x
    if rows is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    else:
        start, total = rows
        keep = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)[start:start + len(x)] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class _ResBlock(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.w1 = nn.Linear(n, n)
        self.batch_norm1 = nn.BatchNorm1d(n, eps=1e-5, momentum=0.1)
        self.w2 = nn.Linear(n, n)
        self.batch_norm2 = nn.BatchNorm1d(n, eps=1e-5, momentum=0.1)


class FCModel(nn.Module):
    def __init__(self, input_size=66, output_size=96, num_neurons=1024,
                 num_blocks=2, p_dropout=0.5, leaky=False,
                 dtype=torch.float32):
        super().__init__()
        self.p_dropout = float(p_dropout)
        self.leaky = bool(leaky)
        self.dtype = dtype
        self.w1 = nn.Linear(input_size, num_neurons)
        self.batch_norm1 = nn.BatchNorm1d(num_neurons, eps=1e-5, momentum=0.1)
        self.res_blocks = nn.ModuleList(
            [_ResBlock(num_neurons) for _ in range(num_blocks)])
        self.w2 = nn.Linear(num_neurons, output_size)
        self.stat_dtype = torch.promote_types(torch.float32, dtype)
        if dtype == torch.float64:
            self.double()

    def _act(self, x):
        return F.leaky_relu(x) if self.leaky else torch.relu(x)

    def _dense(self, m: nn.Linear, x):
        return F.linear(x, m.weight.to(self.dtype), m.bias.to(self.dtype))

    def _bn(self, m: nn.BatchNorm1d, x):
        return batch_norm(m, x, self.stat_dtype).to(self.dtype)

    def forward(self, x, apply_dropout: bool | None = None,
                generator: torch.Generator | None = None, rows=None):
        """``apply_dropout=True`` keeps dropout stochastic while BN uses
        running statistics (the dropout-at-test evaluation option);
        ``generator`` draws the dropout masks, ``rows`` places ``x`` in
        the batch they are drawn for (:func:`dropout`)."""
        drop = self.training if apply_dropout is None else bool(apply_dropout)
        p = self.p_dropout if drop else 0.0
        x = x.to(self.dtype)
        y = self._act(self._bn(self.batch_norm1, self._dense(self.w1, x)))
        y = dropout(y, p, generator, rows)
        for blk in self.res_blocks:
            z = self._act(self._bn(blk.batch_norm1, self._dense(blk.w1, y)))
            z = dropout(z, p, generator, rows)
            z = self._act(self._bn(blk.batch_norm2, self._dense(blk.w2, z)))
            z = dropout(z, p, generator, rows)
            y = y + z
        return self._dense(self.w2, y).to(self.stat_dtype)


def build_fc_model(cfgs: dict, dtype=torch.float32) -> FCModel:
    """Construct from a reference-style config dict (cfgs['FCModel'])."""
    fc = cfgs["FCModel"]
    return FCModel(
        input_size=int(fc["input_size"]),
        output_size=int(fc["output_size"]),
        num_neurons=int(fc.get("num_neurons", 1024)),
        num_blocks=int(fc.get("num_blocks", 2)),
        p_dropout=float(fc.get("dropout", 0.5)),
        leaky=bool(fc.get("leaky", False)),
        dtype=dtype,
    )
