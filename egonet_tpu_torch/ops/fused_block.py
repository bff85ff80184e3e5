"""Fused inference BasicBlock: the Hopper CUDA kernel, its plain PyTorch
version, and the BN folding / weight packing around them.

Replaces the Pallas TPU kernel ``egonet_tpu/ops/pallas_block.py:
fused_basic_block`` (body ``_block_kernel``).  It computes the stride-1,
identity-residual HRNet BasicBlock with batch norm folded into each conv:

    y = relu(conv3x3(relu(conv3x3(x, W1') + b1), W2') + b2 + x)

with bf16 operands, fp32 accumulation and the conv1 activation ("mid")
rounded to bf16 and kept on chip (shared memory), so device memory sees one
read of x and one write of y.  The TPU kernel's batch-minor [H, W, C, B]
layout and tap-matrix relayouts are not carried over: the kernel takes
NHWC bf16, which is the storage of a ``channels_last`` NCHW tensor.

What bounds it on the H100: per block of B crops it does 4*B*H*W*9*C^2
operations and must move 4*B*H*W*C + 36*C^2 bytes (bf16 x in, y out, both
weights).  At the W48 shapes (C/H = 48/64, 96/32, 192/16, 384/8) that is
~180 operations per byte at C=48 rising to ~1000 at C=384 — near or above
the card's ~295 ops/byte ridge, so the tensor cores, not device memory, are
the bound, and the design spends its effort on feeding them: the x tile,
the mid tile and the weights (in K slabs, read from L2 once per thread
block) sit in shared memory, every operand fragment is an ``ldmatrix``
into a ``mma.sync`` from addresses fixed outside the K loop, and the GEMM
rows are the tile's real positions only.  At C=384 the weights every block
reads from L2 bind instead.  ``csrc/fused_basic_block.cu`` has the design;
wgmma, TMA and weight multicast across clusters are later work (see
PERF.md for its times and bound).

The launch plan — tile, images per block, warp grid, K slab depth, slabs
in flight and the shared-memory layout — is reckoned here (:func:`plan_for`)
and passed to the kernel, which checks it against the layout it addresses.
The kernel library instantiates exactly the (MT, NT, KS) variants of the
plans it serves (:func:`library`), listed here and nowhere else.

The kernel is the operator ``egonet::fused_basic_block``, registered once,
in C++ (``csrc/egonet_ops.cpp``: schema, CPU kernel = the plain version in
ATen, Meta kernel = the operand contract for ``torch.export``;
``csrc/egonet_ops_cuda.cpp``: the CUDA kernel, which checks the operands and
launches each width's default plan, generated from :func:`plan_for`), so an
exported program holds one node per block and runs from torch and the
libraries alone.  The operator is the one way to the card: the wrapper
:func:`fused_basic_block` loads the libraries at first use
(``_build.load_ops``) and calls it, which runs the plain version only for a
tensor on the CPU and for a CUDA tensor launches the kernel or raises.
``fused_basic_block.launches`` counts the op's kernel launches (and nothing
else).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from egonet_tpu_torch.io.weights import fold_conv_bn_tensors
from egonet_tpu_torch.ops import _build

_LIB_NAME = "fused_basic_block"
# output tile (TH, TW, NB images per block, KS weight columns per K slab)
# per channel width, measured per shape: the W48 widths at 64/32/16/8 and
# the W32 pedestrian widths at 48/24/12/6 (chip_smoke.py times the other
# tiles of its ALT_TILES / PED_ALT_TILES beside it); other widths take
# (8, 8, 1, 48) and raise where that does not fit
_TILES = {48: (16, 32, 1, 144), 96: (16, 16, 1, 96), 192: (8, 8, 1, 96),
          384: (4, 4, 1, 48),
          32: (12, 16, 1, 48), 64: (6, 12, 1, 48), 128: (6, 6, 1, 48),
          256: (2, 6, 1, 48)}
_SMEM_LIMIT = 232448          # dynamic shared memory one block may use
_WARPS = 8
_MAX_C = 64 * _WARPS          # widest channel count 8 warps cover
# what a plan may take, per N tiles per warp: (most M tiles per warp and
# pass, which the accumulators' registers bound; K slab depths)
_PLAN_LIMITS = {3: (6, (48, 96, 144)), 1: (2, (48,)), 2: (2, (48,)),
                4: (2, (48,))}
_PLANS: dict = {}


# ---------------------------------------------------------------------------
# host-side folding and packing (NumPy copies of the JAX package's)
# ---------------------------------------------------------------------------

def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an inference-mode batch norm into conv weights + bias.
    kernel: [kh, kw, Cin, Cout] (HWIO).  Returns (kernel', bias')."""
    inv = scale / np.sqrt(var + eps)
    return kernel * inv.reshape(1, 1, 1, -1), bias - mean * inv


def pack_block_weights(w1, bn1, w2, bn2, eps: float = 1e-5):
    """(w1 [3,3,C,C] HWIO, bn1 stats dict, w2, bn2) -> {"w1", "w2":
    [C_out, 9*C_in] fp32 with tap-major (dy, dx, cin) rows; "b1", "b2":
    [1, C] fp32}.  ``w.reshape(C, 3, 3, C)`` is the kernel's layout."""
    w1f, b1 = fold_bn(np.asarray(w1, np.float32), bn1["scale"], bn1["bias"],
                      bn1["mean"], bn1["var"], eps)
    w2f, b2 = fold_bn(np.asarray(w2, np.float32), bn2["scale"], bn2["bias"],
                      bn2["mean"], bn2["var"], eps)

    def reshape(w):
        c_out = w.shape[3]
        return np.ascontiguousarray(
            np.transpose(w, (3, 0, 1, 2)).reshape(c_out, -1))

    return {"w1": reshape(w1f),
            "b1": np.asarray(b1.reshape(1, -1), np.float32),
            "w2": reshape(w2f),
            "b2": np.asarray(b2.reshape(1, -1), np.float32)}


@torch.no_grad()
def fold_conv_bn(weight: torch.Tensor, bn: torch.nn.BatchNorm2d):
    """Torch fold of a bias-free OIHW conv and its eval BN, in fp32 on the
    parameters' device.  Returns (w [C_out, 3, 3, C_in] bf16, b [C] fp32) in
    the kernel's layout."""
    return fold_conv_bn_tensors(weight, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def fused_basic_block_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the same NHWC operands.

    x [N, H, W, C]; w1, w2 [C, 3, 3, C] or [C, 9C]; b1, b2 [C] fp32.  Runs in
    fp32 on the given values: with bf16 x and weights it reproduces the
    kernel's arithmetic (exact bf16 products, fp32 sums, mid rounded to
    bf16) up to summation order; with fp32 operands it is the exact folded
    block.  Returns x's dtype."""
    c = x.shape[-1]

    def conv(h, w):
        w = w.reshape(c, 3, 3, c).float().permute(0, 3, 1, 2)   # OIHW
        return F.conv2d(h.permute(0, 3, 1, 2), w, padding=1).permute(
            0, 2, 3, 1)

    xf = x.float()
    mid = torch.relu(conv(xf, w1) + b1.float().reshape(-1))
    if x.dtype == torch.bfloat16:
        mid = mid.to(torch.bfloat16).float()
    y = torch.relu(conv(mid, w2) + b2.float().reshape(-1) + xf)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch plan of the kernel at width ``c``: fields ``th`` ..
    ``smem`` are the kernel's ``Plan`` (same names, same order)."""
    c: int
    th: int           # output tile rows
    tw: int           # output tile columns
    nb: int           # images per block
    cp: int           # shared row pitch in channels (C + 8)
    mt: int           # M tiles (16 GEMM rows) per warp and pass
    nt: int           # N tiles (16 output channels) per warp
    ks: int           # K slab depth (weight columns per slab)
    wm: int           # warps along M
    wn: int           # warps along N
    stages: int       # weight slab buffers (stages - 1 slabs in flight)
    mid_off: int      # byte offset of the mid tile in shared memory
    slab_off: int     # byte offset of the first weight slab
    slab_bytes: int   # bytes of one slab buffer
    smem: int         # dynamic shared memory of one block, bytes


_PLAN_FIELDS = [f.name for f in dataclasses.fields(TilePlan)][1:]


def _nt_for(c: int) -> int:
    """N tiles per warp: 3 where the C/16 tiles split into groups of 3 over
    at most 8 warps (every W48 width), else 4, 2 or 1 likewise, else the
    fewest per warp that 8 warps cover."""
    n16 = c // 16
    for nt in (3, 4, 2, 1):
        if n16 % nt == 0 and n16 // nt <= _WARPS:
            return nt
    for nt in (1, 2, 3, 4):
        if _cdiv(n16, nt) <= _WARPS:
            return nt
    raise ValueError(f"channel width {c} exceeds the kernel's {_MAX_C}")


def plan_for(c: int, tile=None) -> TilePlan:
    """The launch plan at channel width ``c`` for ``tile`` = (TH, TW, NB) or
    (TH, TW, NB, KS) (default :func:`tile_for`): the warp grid, the M tiles
    each warp holds per pass (all of its share where ``_PLAN_LIMITS``
    allows, passes balanced otherwise), and the K slab depth (KS, else the
    first of the limits' that fits) with the most slab buffers (3, else 2)
    that fit in one block's shared memory.  Raises if none fits."""
    tile = tuple(tile or tile_for(c))
    key = (c,) + tile
    th, tw, nb = tile[:3]
    if key in _PLANS:
        return _PLANS[key]
    if c % 16 or min(th, tw, nb) < 1:
        raise ValueError(f"no plan for C={c}, tile {th}x{tw}x{nb}")
    nt = _nt_for(c)
    wn = _cdiv(c // 16, nt)
    wm = _WARPS // wn
    mt_max, slab_depths = _PLAN_LIMITS[nt]
    slots = _cdiv(_cdiv(nb * (th + 2) * (tw + 2), 16), wm)   # of conv 1
    mt = _cdiv(slots, _cdiv(slots, mt_max))
    cp = c + 8
    xs = _align128(nb * (th + 4) * (tw + 4) * cp * 2)
    mid = _align128(nb * (th + 2) * (tw + 2) * cp * 2)
    for ks in tile[3:] or slab_depths:
        if ks not in slab_depths or (9 * c) % ks:
            continue
        slab = _align128(c * (ks + 8) * 2)
        for stages in (3, 2):
            smem = xs + mid + stages * slab
            if smem <= _SMEM_LIMIT:
                plan = TilePlan(c, th, tw, nb, cp, mt, nt, ks, wm, wn,
                                stages, xs, xs + mid, slab, smem)
                _PLANS[key] = plan
                return plan
    raise ValueError(f"a {th}x{tw} tile of {nb} images at C={c} exceeds "
                     "shared memory")


def tile_fits(c: int, tile) -> bool:
    """Whether a (TH, TW, NB[, KS]) tile at width c has a plan."""
    try:
        plan_for(c, tile)
    except ValueError:
        return False
    return True


def takes(c: int) -> bool:
    """Whether the kernel serves channel width ``c`` with its default
    plan: a multiple of 16, at most ``_MAX_C``, a tile that fits.  The
    HRNet sends a block of another width unfused."""
    return c % 16 == 0 and 16 <= c <= _MAX_C and tile_fits(c, None)


def _default_plans():
    """The default plan of every width the kernel takes."""
    return [plan_for(c) for c in range(16, _MAX_C + 1, 16) if takes(c)]


def library(plans=None):
    """The kernel library as ``_build`` takes it, (name, source, prelude):
    ``csrc/fused_basic_block.cu`` instantiating the (MT, NT, KS) variants
    of ``plans`` and no others.  By default, those of every width's default
    plan (what :func:`fused_basic_block` launches); a library of other
    plans (a tile sweep) is named by its variant list."""
    default = plans is None
    if default:
        plans = _default_plans()
    variants = sorted({(p.mt, p.nt, p.ks) for p in plans})
    prelude = "#define EGONET_VARIANTS " + " ".join(
        f"EGONET_VARIANT({mt}, {nt}, {ks})" for mt, nt, ks in variants) + "\n"
    name = _LIB_NAME if default else (
        f"{_LIB_NAME}_{zlib.crc32(prelude.encode()):08x}")
    return name, _LIB_NAME, prelude


def tile_for(c: int):
    """The (TH, TW, NB, KS) tile the kernel uses at channel width ``c``."""
    return _TILES.get(c, (8, 8, 1, 48))


@_build.counted(_build.TILED)
def fused_basic_block(x, w1, b1, w2, b2) -> torch.Tensor:
    """y = relu(conv(relu(conv(x, w1) + b1), w2) + b2 + x), NHWC bf16.

    x [N, H, W, C] bf16 contiguous; w1, w2 [C, 3, 3, C] bf16 (folded,
    tap-major); b1, b2 [C] fp32.  Calls the operator
    ``egonet::fused_basic_block``: a CPU tensor goes through the plain
    version; a CUDA tensor launches the kernel with the plan of
    :func:`tile_for` on the current stream of x's device or raises.  Under
    ``torch.export`` the op is one graph node."""
    _build.load_ops(x.device.type)
    return torch.ops.egonet.fused_basic_block.default(x, w1, b1, w2, b2)
