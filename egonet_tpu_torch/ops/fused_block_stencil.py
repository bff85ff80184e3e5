"""Row-streaming (stencil) fused inference BasicBlock: the Hopper CUDA
kernel, its plain PyTorch version, the ``EGONET_PALLAS_STENCIL`` flag and
its probe.

Replaces the Pallas TPU kernel ``egonet_tpu/ops/pallas_block_stencil.py:
fused_basic_block_stencil`` (body ``_stencil_kernel``).  It computes the
same function as :mod:`egonet_tpu_torch.ops.fused_block` (the stride-1,
identity-residual HRNet BasicBlock with batch norm folded, bf16 operands,
fp32 accumulation, mid rounded to bf16) on the same NHWC operands, but one
thread block sweeps all rows of a column tile: conv1 is recomputed only
over a 2-column halo, and each x row is read once per column tile, at the
price of far fewer blocks than the tiled kernel (see
``csrc/fused_basic_block_stencil.cu`` for the design and its bound).  The
TPU kernel's three rotation-permuted conv2 matrices (``w2p``) existed only
because Mosaic could not index the ring buffer dynamically; the CUDA kernel
computes the ring slot from the row index and takes the same folded weights
as the tiled kernel.

The plain version is ``fused_block.fused_basic_block_reference``, which
computes the identical function; it is re-exported here as
:func:`fused_basic_block_reference`.  The wrapper takes it only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.
``fused_basic_block_stencil.launches`` counts kernel launches (and nothing
else).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops.fused_block import (_SMEM_LIMIT, _check,
                                              fused_basic_block_reference,
                                              pack_block_weights)

_LIB_NAME = "fused_basic_block_stencil"
# (TW output columns, NB images) per block: one image and 8 columns, the
# tile that launches the most blocks; each block is a serial chain over the
# rows, so the kernel gains from more resident blocks, not from more work
# per block (chip_smoke.py times other tiles at each W48 shape)
DEFAULT_TILE = (8, 1)
_MAX_C = 384          # 8 warps x 3 N tiles of 16 channels


def pack_stencil_weights(w1, bn1, w2, bn2, eps: float = 1e-5):
    """NumPy copy of the JAX package's stencil packing: the folded weights
    plus ``w2p`` [3, C, 9C], conv2's rows permuted for each of the three
    ring rotations (permutation r reads logical dy = (j - r) mod 3 from
    ring slot j).  Nothing on the port's path uses it: the CUDA kernel
    indexes its ring directly and takes the unpermuted ``w2``."""
    base = pack_block_weights(w1, bn1, w2, bn2, eps)
    c_out, k9 = base["w2"].shape
    w2m = base["w2"].reshape(c_out, 3, 3, k9 // 9)
    perms = [w2m[:, [(j - r) % 3 for j in range(3)]].reshape(c_out, k9)
             for r in range(3)]
    return {"w1": base["w1"], "b1": base["b1"], "b2": base["b2"],
            "w2p": np.stack(perms)}


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load(_LIB_NAME)
    fn = lib.egonet_fused_basic_block_stencil
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.egonet_fused_basic_block_stencil_smem.argtypes = [ctypes.c_int] * 3
        lib.egonet_fused_basic_block_stencil_smem.restype = ctypes.c_longlong
    return lib


def tile_fits(c: int, tile) -> bool:
    """Whether a (TW, NB) tile at width c fits in one block's shared
    memory (needs the built kernel library)."""
    tw, nb = tile
    return _lib().egonet_fused_basic_block_stencil_smem(tw, nb, c) \
        <= _SMEM_LIMIT


def fused_basic_block_stencil(x, w1, b1, w2, b2, tile=None) -> torch.Tensor:
    """y = relu(conv(relu(conv(x, w1) + b1), w2) + b2 + x), NHWC bf16, by
    row streaming.

    x [N, H, W, C] bf16 contiguous, C <= 384; w1, w2 [C, 3, 3, C] bf16
    (folded, tap-major); b1, b2 [C] fp32.  ``tile`` = (TW, NB) overrides
    ``DEFAULT_TILE``.  A CPU tensor goes through
    :func:`fused_basic_block_reference`; a CUDA tensor launches the kernel
    on the current stream or raises."""
    if x.device.type == "cpu":
        return fused_basic_block_reference(x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    n, h, w, c = x.shape
    if c > _MAX_C:
        raise ValueError(f"the stencil kernel takes C <= {_MAX_C}, got {c}")
    tw, nb = tile or DEFAULT_TILE
    if not tile_fits(c, (tw, nb)):
        raise ValueError(f"a {tw}-column tile of {nb} images at C={c} "
                         "exceeds shared memory")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().egonet_fused_basic_block_stencil(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), n, h, w, c, tw, nb, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_basic_block_stencil launch failed: CUDA error {err} "
            f"(N={n} H={h} W={w} C={c} TW={tw} NB={nb})")
    fused_basic_block_stencil.launches += 1
    return y


fused_basic_block_stencil.launches = 0


# ---------------------------------------------------------------------------
# the EGONET_PALLAS_STENCIL flag and its probe
# ---------------------------------------------------------------------------

_PROBE_CACHE: dict = {}


def probe_args(tile_cols: int = 32, channels: int = 48, width: int = 64,
               batch: int = 8, height: int = 8, device="cpu"):
    """(x [B, H, W, C] bf16, (w1, b1, w2, b2) folded) for the probe, drawn
    as the JAX package's ``probe_args`` draws its [H, W, C, B] input and
    weights (numpy RandomState(0), identity batch norms).  ``tile_cols`` is
    kept for the JAX signature: the CUDA kernel masks a ragged tile."""
    del tile_cols
    rng = np.random.RandomState(0)
    x = rng.randn(height, width, channels, batch)
    ident = {"scale": np.ones(channels), "bias": np.zeros(channels),
             "mean": np.zeros(channels), "var": np.ones(channels)}
    packed = pack_block_weights(rng.randn(3, 3, channels, channels) * 0.05,
                                ident,
                                rng.randn(3, 3, channels, channels) * 0.05,
                                ident)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device).to(dtype)

    c = channels
    return (t(np.transpose(x, (3, 0, 1, 2)), torch.bfloat16),
            (t(packed["w1"].reshape(c, 3, 3, c), torch.bfloat16),
             t(packed["b1"].reshape(-1), torch.float32),
             t(packed["w2"].reshape(c, 3, 3, c), torch.bfloat16),
             t(packed["b2"].reshape(-1), torch.float32)))


def probe_wide_tile(tile_cols: int = 32, channels: int = 48,
                    width: int = 64) -> bool:
    """True iff the stencil kernel, at a ``tile_cols``-wide column tile,
    gives finite output equal to its plain version (atol 5e-2 / rtol
    2e-2).  A build or launch error propagates.  Without CUDA there is no
    kernel to probe: False.  Cached per (tile_cols, channels, width)."""
    key = (tile_cols, channels, width)
    if key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    ok = False
    if torch.cuda.is_available():
        x, folded = probe_args(tile_cols, channels, width, device="cuda")
        y = fused_basic_block_stencil(x, *folded, tile=(tile_cols, 1)).float()
        ref = fused_basic_block_reference(x, *folded).float()
        ok = bool(torch.isfinite(y).all()) and bool(
            torch.allclose(y, ref, atol=5e-2, rtol=2e-2))
    _PROBE_CACHE[key] = ok
    return ok


def stencil_enabled(flag: str | None = None) -> bool:
    """Resolve the EGONET_PALLAS_STENCIL flag: '1' selects the stencil
    kernel, '0' (default) the tiled kernel, 'auto' the stencil when
    :func:`probe_wide_tile` passes."""
    flag = flag if flag is not None else os.environ.get(
        "EGONET_PALLAS_STENCIL", "0")
    if flag == "1":
        return True
    if flag == "auto":
        return probe_wide_tile()
    return False
