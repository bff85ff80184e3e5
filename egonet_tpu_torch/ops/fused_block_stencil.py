"""Row-streaming (stencil) fused inference BasicBlock: the Hopper CUDA
kernel, its launch plan, its plain PyTorch version, the
``EGONET_PALLAS_STENCIL`` flag and its probe.

Replaces the Pallas TPU kernel ``egonet_tpu/ops/pallas_block_stencil.py:
fused_basic_block_stencil`` (body ``_stencil_kernel``).  It computes the
same function as :mod:`egonet_tpu_torch.ops.fused_block` (the stride-1,
identity-residual HRNet BasicBlock with batch norm folded, bf16 operands,
fp32 accumulation, mid rounded to bf16) on the same NHWC operands, but one
thread-block cluster sweeps all rows of a column tile: conv1 is recomputed
only over a 2-column halo, and each x row is read once per block.  A sweep
is a serial chain of row steps, so the kernel keeps the weights out of it:
each block holds its share of both weight matrices in shared memory for
the whole sweep, and where one block cannot hold them the output channels
are split over a cluster of K blocks that exchange each mid row through
distributed shared memory; where no cluster holds them (C=384) each block
streams only its 1/K share per step (``csrc/fused_basic_block_stencil.cu``
has the design and its bound).  The TPU kernel's three rotation-permuted
conv2 matrices (``w2p``) existed only because Mosaic could not index the
ring buffer dynamically; the CUDA kernel computes the ring slot from the
row index and takes the same folded weights as the tiled kernel.

The launch plan — column tile, images per cluster, cluster size, resident
or streamed weights, warp grid and the shared-memory layout — is reckoned
here (:func:`plan_for`) and passed to the kernel, which checks it.  The
kernel library instantiates exactly the (MT1, MT2, NT, KC, STREAM)
variants of the plans it serves (:func:`library`).

The plain version is ``fused_block.fused_basic_block_reference``, which
computes the identical function; it is re-exported here as
:func:`fused_basic_block_reference`.  The kernel is the operator
``egonet::fused_basic_block_stencil``, registered in C++ beside the tiled
kernel's (``csrc/egonet_ops.cpp``: schema, CPU kernel = the plain version,
Meta kernel, both ignoring a plan; ``csrc/egonet_ops_cuda.cpp``: the CUDA
kernel, which launches the plan it is given, as its ``_PLAN_FIELDS``, or
the width's default, after asking the card once per device and plan
whether it holds a cluster).  The operator is the one way to the card: the
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  A ``tile=`` override is passed
to the operator as its plan.  ``fused_basic_block_stencil.launches`` counts
the op's kernel launches (and nothing else).
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np
import torch

from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops.fused_block import (_SMEM_LIMIT, _align128, _cdiv,
                                              fused_basic_block_reference,
                                              pack_block_weights)

_LIB_NAME = "fused_basic_block_stencil"
# (TW columns, RH rows per step, NB images, K blocks per cluster, WM1, WM2
# warps along M of conv1 and of conv2, WN warps along N) per channel width,
# measured per shape: the W48 widths at 64/32/16/8 and the W32 pedestrian
# widths at 48/24/12/6 (chip_smoke.py times the other plans of its
# STENCIL_SWEEP / PED_STENCIL_SWEEP beside it); an 8th entry KS asks for
# weights streamed in slabs of KS channels
_TILES = {48: (16, 4, 1, 1, 2, 2, 1), 96: (16, 3, 1, 2, 4, 3, 1),
          192: (16, 1, 1, 8, 2, 1, 1), 384: (8, 3, 1, 8, 1, 1, 3, 96),
          32: (16, 4, 1, 1, 2, 2, 1), 64: (8, 3, 1, 2, 1, 1, 1),
          128: (12, 1, 2, 4, 1, 1, 1), 256: (6, 1, 2, 8, 1, 1, 1, 64)}
_MAX_C = 384          # the widest channel count the default library serves
_MAX_WARPS = 8
_MAX_CLUSTER = 8      # portable cluster size
_MAX_ACC = 24         # accumulator tiles (MT1 or MT2) x NT a warp may hold
_SLAB_DEPTHS = (96, 64, 48, 32, 16)   # streamed K slabs tried, widest first
_PLANS: dict = {}


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
# the launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """One launch plan of the kernel at width ``c``: fields ``tw`` ..
    ``smem`` are the kernel's ``StencilPlan`` (same names, same order)."""
    c: int
    tw: int           # output columns per tile
    rh: int           # rows per step (mid rows and output rows)
    nb: int           # images per cluster
    k: int            # blocks per cluster (output-channel slices)
    cpc: int          # output channels per block (C / K)
    resident: int     # 1: weights resident for the sweep; 0: streamed
    ks: int           # streamed: K slab depth in channels (0 resident)
    stages: int       # streamed: slab buffers (0 resident)
    kc: int           # 16-channel chunks per tap: a warp's (resident, C /
                      # 16) or a slab's (streamed, KS / 16)
    mt1: int          # M tiles (16 GEMM rows) of a conv1 warp
    mt2: int          # M tiles of a conv2 warp
    nt: int           # n8 tiles (8 output channels) per warp
    wm1: int          # warps along M running conv1
    wm2: int          # warps along M running conv2
    wn: int           # warps along N
    cp: int           # activation row pitch in channels (C + 8)
    wp: int           # weight row pitch (9C + 8 resident, KS + 8 streamed)
    xp: int           # positions per image of an x ring slot (TW + 4)
    mp: int           # positions per image of a mid ring slot (TW + 2)
    ahead: int        # steps before its first reader an x row is fetched
    x_slots: int      # x ring slots ((ahead + 1) RH + 2, from offset 0)
    mid_slots: int    # mid ring slots (2 RH + 2)
    x_slot: int       # bytes of one x ring slot
    mid_slot: int     # bytes of one mid ring slot
    mid_off: int      # byte offset of the mid ring
    w_off: int        # byte offset of the weights
    w_bytes: int      # one matrix's share, or one slab buffer of both
    smem: int         # dynamic shared memory of one block, bytes

    @property
    def warps(self) -> int:
        return (self.wm1 + self.wm2) * self.wn

    @property
    def tile(self):
        """The tile tuple :func:`plan_for` takes back for this plan."""
        t = (self.tw, self.rh, self.nb, self.k, self.wm1, self.wm2, self.wn)
        return t if self.resident else t + (self.ks,)


_PLAN_FIELDS = [f.name for f in dataclasses.fields(StencilPlan)][1:]


def _default_tile(c: int):
    """8 columns of one image per cluster, one warp along M per conv, at
    most 8 n8 tiles per warp, and the smallest cluster whose blocks hold
    their weight shares (else the largest cluster, streaming)."""
    def tile(k):
        n8 = c // k // 8
        wn = next(d for d in range(1, n8 + 1) if n8 % d == 0 and n8 // d <= 8)
        return (8, 1, 1, k, 1, 1, wn)

    ks = [k for k in range(1, _MAX_CLUSTER + 1) if c % (8 * k) == 0]
    for k in ks:
        if tile_fits(c, tile(k)) and plan_for(c, tile(k)).resident:
            return tile(k)
    return tile(ks[-1] if ks else 1)


def tile_for(c: int):
    """The (TW, RH, NB, K, WM1, WM2, WN[, KS]) tile the kernel uses at
    width c."""
    return _TILES.get(c) or _default_tile(c)


def _complete(c: int, tile):
    """A full tile from ``tile``: (TW, NB) takes one row per step, the
    default's cluster, warps along N and slab depth, and as few warps along
    M per conv as keep a warp within ``_MAX_ACC`` accumulator tiles."""
    tile = tuple(tile)
    if len(tile) != 2:
        return tile
    tw, nb = tile
    k, _, _, wn = tile_for(c)[3:7]
    nt = c // k // 8 // wn

    def warps_for(m):                  # fewest warps for m M tiles
        return _cdiv(m, _MAX_ACC // nt)

    wm1 = warps_for(_cdiv(nb * (tw + 2), 16))
    wm2 = warps_for(_cdiv(nb * tw, 16))
    return (tw, 1, nb, k, wm1, wm2, wn) + tuple(tile_for(c)[7:])


def plan_for(c: int, tile=None) -> StencilPlan:
    """The launch plan at channel width ``c`` for ``tile`` = (TW, RH, NB,
    K, WM1, WM2, WN) (default :func:`tile_for`): the weights resident
    where both shares fit in one block's shared memory beside the rings (x
    rows fetched two steps ahead, else one), else streamed in K slabs (the
    first depth of ``_SLAB_DEPTHS`` dividing C that fits, 3 slab buffers,
    else 2); an 8th entry KS asks for streamed slabs of KS channels.  (TW,
    NB) alone is completed by :func:`_complete`.  Raises if the tile is
    invalid or nothing fits."""
    tile = _complete(c, tile or tile_for(c))
    key = (c,) + tile
    if key in _PLANS:
        return _PLANS[key]
    bad = ValueError(f"no stencil plan for C={c}, tile {tile}")
    if len(tile) not in (7, 8) or c % 16 or c < 16:
        raise bad
    tw, rh, nb, k, wm1, wm2, wn = tile[:7]
    if (min(tile) < 1 or k > _MAX_CLUSTER or c % (8 * k)
            or (c // k // 8) % wn or (wm1 + wm2) * wn > _MAX_WARPS):
        raise bad
    cpc = c // k
    nt = cpc // 8 // wn
    mt1 = _cdiv(_cdiv(rh * nb * (tw + 2), 16), wm1)
    mt2 = _cdiv(_cdiv(rh * nb * tw, 16), wm2)
    if max(mt1, mt2) * nt > _MAX_ACC:
        raise bad
    cp, xp, mp = c + 8, tw + 4, tw + 2
    x_slot = _align128(nb * xp * cp * 2)
    mid_slot = _align128(nb * mp * cp * 2)
    mid_slots = 2 * rh + 2
    # (resident, ks, stages, kc, wp, w_bytes, weight bytes, ahead) in order
    # of choice: x rows fetched two steps ahead where the ring has room
    # (resident; a streamed step waits for its copies inside the walk)
    options = []
    if len(tile) == 7:
        wp = 9 * c + 8
        w_bytes = _align128(cpc * wp * 2)
        for ahead in (2, 1):
            options.append((1, 0, 0, c // 16, wp, w_bytes, 2 * w_bytes,
                            ahead))
    depths = tile[7:] or [d for d in _SLAB_DEPTHS if c % d == 0]
    for ks in depths:
        if ks % 16 or c % ks:
            raise bad
        w_bytes = _align128(2 * cpc * (ks + 8) * 2)
        for stages in (3, 2):
            options.append((0, ks, stages, ks // 16, ks + 8, w_bytes,
                            stages * w_bytes, 1))
    for resident, ks, stages, kc, wp, w_bytes, w_total, ahead in options:
        x_slots = (ahead + 1) * rh + 2
        mid_off = x_slots * x_slot
        w_off = mid_off + mid_slots * mid_slot
        if w_off + w_total <= _SMEM_LIMIT:
            plan = StencilPlan(c, tw, rh, nb, k, cpc, resident, ks, stages,
                               kc, mt1, mt2, nt, wm1, wm2, wn, cp, wp, xp, mp,
                               ahead, x_slots, mid_slots, x_slot, mid_slot,
                               mid_off, w_off, w_bytes, w_off + w_total)
            _PLANS[key] = plan
            return plan
    raise ValueError(f"the stencil tile {tile} at C={c} exceeds shared "
                     "memory")


def tile_fits(c: int, tile) -> bool:
    """Whether a stencil tile at width c has a plan (no library needed)."""
    try:
        plan_for(c, tile)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# the kernel library and its wrapper
# ---------------------------------------------------------------------------

def _variant(plan: StencilPlan):
    """The kernel's template arguments for ``plan``."""
    return plan.mt1, plan.mt2, plan.nt, plan.kc, 1 - plan.resident


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
    ``csrc/fused_basic_block_stencil.cu`` instantiating the (MT1, MT2, NT,
    KC, STREAM) variants of ``plans`` and no others.  By default, those of
    the default plans (what :func:`fused_basic_block_stencil` launches); a
    library of other plans (a sweep) is named by its variant list."""
    default = plans is None
    if default:
        plans = _default_plans()
    variants = sorted({_variant(p) for p in plans})
    prelude = "#define EGONET_VARIANTS " + " ".join(
        f"EGONET_VARIANT({', '.join(map(str, v))})" for v in variants) + "\n"
    name = _LIB_NAME if default else (
        f"{_LIB_NAME}_{zlib.crc32(prelude.encode()):08x}")
    return name, _LIB_NAME, prelude


def _plan_fields(c: int, tile) -> list:
    """The fields of ``tile``'s plan at width ``c``, as the operator takes
    them.  Raises ValueError if the default library holds no kernel variant
    for the plan (a launch would fail)."""
    plan = plan_for(c, tile)
    if _variant(plan) not in {_variant(p) for p in _default_plans()}:
        raise ValueError(
            f"the stencil library holds no kernel for tile {plan.tile} at "
            f"C={c}: its (MT1, MT2, NT, KC, STREAM) = {_variant(plan)} is no "
            "default plan's")
    return [getattr(plan, f) for f in _PLAN_FIELDS]


@_build.counted(_build.STENCIL)
def fused_basic_block_stencil(x, w1, b1, w2, b2, tile=None) -> torch.Tensor:
    """y = relu(conv(relu(conv(x, w1) + b1), w2) + b2 + x), NHWC bf16, by
    row streaming.

    x [N, H, W, C] bf16 contiguous, C <= 384; w1, w2 [C, 3, 3, C] bf16
    (folded, tap-major); b1, b2 [C] fp32.  Calls the operator
    ``egonet::fused_basic_block_stencil``: a CPU tensor goes through the
    plain version; a CUDA tensor launches the kernel on the current stream
    of x's device or raises.  ``tile`` overrides :func:`tile_for` (a full
    tile, or (TW, NB) with the rest of the default) with a plan whose
    kernel variant the default library holds, passed to the operator;
    another raises ValueError before the operator is called."""
    plan = None if tile is None else _plan_fields(x.shape[3], tile)
    _build.load_ops(x.device.type)
    return torch.ops.egonet.fused_basic_block_stencil.default(
        x, w1, b1, w2, b2, plan)


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
    2e-2).  The tile's plan runs a kernel variant of the default library
    (at the default 32 columns, the C=48 default plan's), so the probe
    builds nothing the model does not.  A build or launch error, or a tile
    whose variant the default library lacks, propagates.  Without CUDA there is no
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
