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
rows are the tile's real positions only.  At the deep widths the weights
every block reads from L2 bind instead: a block does (M1 + M2) / 2
operations per weight byte it streams (its real GEMM rows of conv1 and
conv2), 26 at C=384 on a 4x4 tile.  There (:func:`cluster_for`) a cluster
of 2 blocks, the same tile of two images, shares each weight slab: one TMA
load of each block's half of the slab, multicast into both blocks, so the
weights leave L2 once per cluster.
``csrc/fused_basic_block.cu`` has the design; wgmma is later work (see
PERF.md for its times and bound).

The launch plan — tile, images per block, warp grid, K slab depth, slabs
in flight and the shared-memory layout — is reckoned here (:func:`plan_for`)
and passed to the kernel, which checks it against the layout it addresses.
The kernel library instantiates exactly the (MT, NT, KS, TMA) variants of
the plans it serves (:func:`library`), listed here and nowhere else.

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
else); ``fused_basic_block.multicast_launches`` those of them made as
clusters sharing each weight slab.
"""

from __future__ import annotations

import dataclasses
import functools
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
# Clusters that share each weight slab (TMA multicast).  A block streams
# both weights, 36*C^2 bytes, for 4*9*C^2*(M1 + M2) operations, its real
# GEMM rows of conv1 and conv2: (M1 + M2) / 2 operations per weight byte
# leaving L2, whatever C is.  A plan below _MULTICAST_BELOW takes a cluster
# of _CLUSTER blocks: at the W48 and W32 tiles C=384 (26), C=192 (82),
# C=256 (22), C=128 (50) and C=64 (92); C=48 (562), C=96 (290) and C=32
# (222) stay unclustered (their 9C columns take no 64-column slab either).
# chip_smoke.py's cluster sweep (H100 80GB HBM3, 700 W; PERF.md) at batch
# 512, k = 1 / 2 / 4, ms a launch: C=384 2.730 / 1.157 / 1.226, C=192
# 1.016 / 0.799 / 0.890, C=256 0.951 / 0.400 / 0.431, C=128 0.382 / 0.291 /
# 0.310, C=64 0.333 / 0.302 / 0.323: k = 2 wins at every width and batch
# swept, and every clustered width gains; no width between 92 and 222 takes
# a slab, so the threshold only has to lie there.  _CLUSTERS: the sizes a
# plan may take (chip_smoke.py sweeps them).
_MULTICAST_BELOW = 128
_CLUSTER = 2
_CLUSTERS = (2, 4)
_TMA_KS = 64                  # a cluster plan's slab: 64 columns, 128 bytes
_BAR_BYTES = 128              # its mbarriers, after the slabs
_TMA_STAGES = 8               # most slab buffers of a cluster plan
_SM_SMEM = 233472             # shared memory of an SM, bytes
_BLOCK_RESERVED = 1024        # of it, the system's per resident block
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
    cluster: int      # blocks sharing each weight slab (1: no cluster)


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


def flop_per_weight_byte(th: int, tw: int, nb: int) -> float:
    """Operations a block of a (TH, TW, NB) tile does per weight byte it
    streams from L2: (M1 + M2) / 2, its real GEMM rows of conv1 and
    conv2."""
    return (nb * (th + 2) * (tw + 2) + nb * th * tw) / 2


def _cluster_fits(c: int, k: int) -> bool:
    """Whether 64-column slab rows divide 9C and a cluster of ``k`` blocks
    shares each slab's C rows in TMA boxes (a multiple of 8, at most
    256)."""
    return c % _TMA_KS == 0 and (c // k) % 8 == 0 and c // k <= 256


def cluster_for(c: int, th: int, tw: int, nb: int) -> int:
    """Blocks that share each weight slab at width ``c`` on a (TH, TW, NB)
    tile: ``_CLUSTER`` below ``_MULTICAST_BELOW`` operations per weight
    byte, where its slabs fit; else 1."""
    if (flop_per_weight_byte(th, tw, nb) < _MULTICAST_BELOW
            and _cluster_fits(c, _CLUSTER)):
        return _CLUSTER
    return 1


def plan_for(c: int, tile=None, cluster=None) -> TilePlan:
    """The launch plan at channel width ``c`` for ``tile`` = (TH, TW, NB) or
    (TH, TW, NB, KS) (default :func:`tile_for`): the warp grid, the M tiles
    each warp holds per pass (all of its share where ``_PLAN_LIMITS``
    allows, passes balanced otherwise), and the K slab depth (KS, else the
    first of the limits' that fits) with the most slab buffers (3, else 2)
    that fit in one block's shared memory.  ``cluster``: the blocks that
    share each weight slab (default :func:`cluster_for`).  A cluster plan
    takes 64-column swizzled slabs, whatever KS, as many as fit up to
    ``_TMA_STAGES`` (a variant of few accumulators, as the kernel's launch
    bounds say, keeps two blocks an SM where two slabs still fit so), and
    falls back to no cluster where two do not fit, unless ``cluster`` was
    given.  Raises if none fits."""
    tile = tuple(tile or tile_for(c))
    th, tw, nb = tile[:3]
    key = (c,) + tile + (cluster,)
    if key in _PLANS:
        return _PLANS[key]
    if c % 16 or min(th, tw, nb) < 1:
        raise ValueError(f"no plan for C={c}, tile {th}x{tw}x{nb}")
    k = cluster_for(c, th, tw, nb) if cluster is None else cluster
    if k not in (1,) + _CLUSTERS or (k > 1 and not _cluster_fits(c, k)):
        raise ValueError(f"no cluster of {k} at C={c}")
    nt = _nt_for(c)
    wn = _cdiv(c // 16, nt)
    wm = _WARPS // wn
    mt_max, slab_depths = _PLAN_LIMITS[nt]
    slots = _cdiv(_cdiv(nb * (th + 2) * (tw + 2), 16), wm)   # of conv 1
    mt = _cdiv(slots, _cdiv(slots, mt_max))
    cp = c + 8
    xs = _align128(nb * (th + 4) * (tw + 4) * cp * 2)
    mid = _align128(nb * (th + 2) * (tw + 2) * cp * 2)
    if k > 1:
        slab = c * _TMA_KS * 2
        slab_off = _cdiv(xs + mid, 1024) * 1024     # the swizzle's boundary
        limit = _SMEM_LIMIT
        two = _SM_SMEM // 2 - _BLOCK_RESERVED
        if mt * nt <= 6 and slab_off + 2 * slab + _BAR_BYTES <= two:
            limit = two                             # two blocks an SM
        stages = min(_TMA_STAGES, (limit - slab_off - _BAR_BYTES) // slab)
        if stages >= 2:
            plan = TilePlan(c, th, tw, nb, cp, mt, nt, _TMA_KS, wm, wn,
                            stages, xs, slab_off, slab,
                            slab_off + stages * slab + _BAR_BYTES, k)
            _PLANS[key] = plan
            return plan
        if cluster is not None:
            raise ValueError(f"a cluster plan of a {th}x{tw} tile of {nb} "
                             f"images at C={c} exceeds shared memory")
    for ks in tile[3:] or slab_depths:
        if ks not in slab_depths or (9 * c) % ks:
            continue
        slab = _align128(c * (ks + 8) * 2)
        for stages in (3, 2):
            smem = xs + mid + stages * slab
            if smem <= _SMEM_LIMIT:
                plan = TilePlan(c, th, tw, nb, cp, mt, nt, ks, wm, wn,
                                stages, xs, xs + mid, slab, smem, 1)
                _PLANS[key] = plan
                return plan
    raise ValueError(f"a {th}x{tw} tile of {nb} images at C={c} exceeds "
                     "shared memory")


def tile_fits(c: int, tile, cluster=None) -> bool:
    """Whether a (TH, TW, NB[, KS]) tile at width c has a plan (with
    ``cluster`` blocks a cluster, if given)."""
    try:
        plan_for(c, tile, cluster)
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
    ``csrc/fused_basic_block.cu`` instantiating the (MT, NT, KS, TMA)
    variants of ``plans`` (TMA: 1 for a cluster plan) and no others.  By
    default, those of every width's default plan (what
    :func:`fused_basic_block` launches); a library of other plans (a tile
    sweep) is named by its variant list."""
    default = plans is None
    if default:
        plans = _default_plans()
    variants = sorted({variant(p) for p in plans})
    prelude = "#define EGONET_VARIANTS " + " ".join(
        f"EGONET_VARIANT({', '.join(map(str, v))})" for v in variants) + "\n"
    name = _LIB_NAME if default else (
        f"{_LIB_NAME}_{zlib.crc32(prelude.encode()):08x}")
    return name, _LIB_NAME, prelude


def variant(plan: TilePlan):
    """The kernel variant a plan runs: (MT, NT, KS, TMA)."""
    return plan.mt, plan.nt, plan.ks, int(plan.cluster > 1)


def grid_for(plan: TilePlan, n: int, h: int, w: int):
    """The launch grid (x: tiles, y: image groups) of ``plan`` over an
    [n, h, w, C] input, as ``launch`` in ``csrc/fused_basic_block.cu`` makes
    it: with a cluster, the image groups rounded up to a multiple of it
    (the blocks past the batch load zeros and store nothing)."""
    groups = _cdiv(n, plan.nb)
    return (_cdiv(h, plan.th) * _cdiv(w, plan.tw),
            _cdiv(groups, plan.cluster) * plan.cluster)


def tile_for(c: int):
    """The (TH, TW, NB, KS) tile the kernel uses at channel width ``c``."""
    return _TILES.get(c, (8, 8, 1, 48))


class _TiledWrapper(_build.CountedWrapper):
    """The tiled kernel's wrapper: ``launches`` as every kernel's, and
    ``multicast_launches``, the launches made as clusters sharing each
    weight slab (counted besides ``launches``)."""

    @property
    def multicast_launches(self) -> int:
        return _build.launches(_build.TILED_MULTICAST)

    @multicast_launches.setter
    def multicast_launches(self, n: int) -> None:
        _build.set_launches(_build.TILED_MULTICAST, n)


@functools.partial(_TiledWrapper, op=_build.TILED)
def fused_basic_block(x, w1, b1, w2, b2) -> torch.Tensor:
    """y = relu(conv(relu(conv(x, w1) + b1), w2) + b2 + x), NHWC bf16.

    x [N, H, W, C] bf16 contiguous; w1, w2 [C, 3, 3, C] bf16 (folded,
    tap-major); b1, b2 [C] fp32.  Calls the operator
    ``egonet::fused_basic_block``: a CPU tensor goes through the plain
    version; a CUDA tensor launches the kernel with the width's default
    plan (:func:`plan_for`) on the current stream of x's device or
    raises.  Under
    ``torch.export`` the op is one graph node."""
    _build.load_ops(x.device.type)
    return torch.ops.egonet.fused_basic_block.default(x, w1, b1, w2, b2)
