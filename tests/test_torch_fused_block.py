"""The port's fused BasicBlock (egonet_tpu_torch/ops/fused_block.py) against
the JAX package's Pallas kernel and its XLA oracle (interpret mode on CPU),
and the launch plans the wrapper reckons for the CUDA kernel (shared-memory
layout, warp grid, the kernel variants its library is built with).

The M and N walks below (``_gemm_rows``, ``_row_position``,
``_warp_n_tiles``) restate ``conv_gemm`` of csrc/fused_basic_block.cu to
check that a plan covers every real position once; they check the plan,
not the CUDA code.  The kernel's real row map runs only on the card: the
``test_kernel_matches_plain_version_*`` cases are marked ``cuda`` and skip
without one, and ``python3 chip_smoke.py`` holds the kernel against the
plain version at the W48 shapes, at ragged ones and at every tile of its
sweep on every chip run."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from egonet_tpu.ops import pallas_block as pb
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops import fused_block as fb

torch.set_num_threads(1)


def _random_block(rng, C):
    w1 = rng.randn(3, 3, C, C).astype(np.float32) * 0.1
    w2 = rng.randn(3, 3, C, C).astype(np.float32) * 0.1

    def bn():
        return {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                "bias": rng.randn(C).astype(np.float32) * 0.1,
                "mean": rng.randn(C).astype(np.float32) * 0.1,
                "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    return w1, bn(), w2, bn()


def _packed_tensors(params, dtype):
    c = params["w1"].shape[0]
    return (torch.from_numpy(params["w1"]).reshape(c, 3, 3, c).to(dtype),
            torch.from_numpy(params["b1"]).reshape(-1),
            torch.from_numpy(params["w2"]).reshape(c, 3, 3, c).to(dtype),
            torch.from_numpy(params["b2"]).reshape(-1))


def test_pack_block_weights_bit_equal_to_jax(rng):
    w1, bn1, w2, bn2 = _random_block(rng, 16)
    ours = fb.pack_block_weights(w1, bn1, w2, bn2)
    theirs = pb.pack_block_weights(w1, bn1, w2, bn2)
    for k in ("w1", "b1", "w2", "b2"):
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))


def test_torch_fold_matches_numpy_fold(rng):
    """The model's on-device fold (fold_conv_bn, OIHW + BatchNorm2d) gives
    the numpy pack's weights (rounded to bf16) and biases."""
    C = 16
    w1, bn1, _, _ = _random_block(rng, C)
    conv_w = torch.from_numpy(np.transpose(w1, (3, 2, 0, 1)).copy())
    bn = torch.nn.BatchNorm2d(C).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(bn1["scale"]))
        bn.bias.copy_(torch.from_numpy(bn1["bias"]))
        bn.running_mean.copy_(torch.from_numpy(bn1["mean"]))
        bn.running_var.copy_(torch.from_numpy(bn1["var"]))
    w, b = fb.fold_conv_bn(conv_w, bn)
    ref = fb.pack_block_weights(w1, bn1, w1, bn1)
    np.testing.assert_array_equal(
        w.float().numpy().reshape(C, -1),
        torch.from_numpy(ref["w1"]).bfloat16().float().numpy())
    np.testing.assert_allclose(b.numpy(), ref["b1"].reshape(-1), rtol=1e-6,
                               atol=1e-7)


def test_plain_version_fp32_matches_xla_reference(rng):
    C = 8
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    ref = np.asarray(pb.reference_basic_block(jnp.asarray(x), w1, bn1,
                                              w2, bn2))
    got = fb.fused_basic_block_reference(
        torch.from_numpy(x),
        *_packed_tensors(fb.pack_block_weights(w1, bn1, w2, bn2),
                         torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("H,W,C,B,TH,TW", [
    (8, 8, 8, 16, 4, 4),
    (16, 8, 16, 8, 4, 8),
    (8, 16, 8, 8, 8, 4),
    # a map that the CUDA kernel's tile at this width (8x8) divides in
    # neither direction
    (10, 12, 16, 3, 5, 4),
])
def test_plain_version_bf16_matches_pallas_kernel(rng, H, W, C, B, TH, TW):
    """bf16 operands on both sides: the JAX test's own bar (atol 0.15,
    rtol 0.05).  The observed maximum is printed."""
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    params = pb.pack_block_weights(w1, bn1, w2, bn2)
    xT = jnp.asarray(np.transpose(x, (1, 2, 3, 0))).astype(jnp.bfloat16)
    yT = pb.fused_basic_block(xT, params, tile_rows=TH, tile_cols=TW,
                              interpret=True)
    pallas = np.transpose(np.asarray(yT, dtype=np.float32), (3, 0, 1, 2))

    got = fb.fused_basic_block_reference(
        torch.from_numpy(x).bfloat16(),
        *_packed_tensors(fb.pack_block_weights(w1, bn1, w2, bn2),
                         torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    print(f"max |plain - pallas| = {np.abs(got - pallas).max():.4g}")
    np.testing.assert_allclose(got, pallas, atol=0.15, rtol=0.05)


def test_wrapper_takes_plain_version_for_cpu_tensor(rng):
    """On a CPU tensor the wrapper runs the operator's CPU kernel, the
    plain version in ATen (csrc/egonet_ops.cpp): equal to
    fused_basic_block_reference bit for bit, and no launch counted."""
    before = fb.fused_basic_block.launches
    c = 16
    x = torch.from_numpy(rng.randn(1, 4, 4, c).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(c, 3, 3, c).astype(np.float32)
                         * 0.05).bfloat16()
    b = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
    # the operator's CPU kernel is the plain version
    assert torch.equal(fb.fused_basic_block(x, w, b, w, b),
                       fb.fused_basic_block_reference(x, w, b, w, b))
    # the launch count counts kernel launches only
    assert fb.fused_basic_block.launches == before


W48_WIDTHS = (48, 96, 192, 384)
# plans off the W48 table: more than one pass, idle warps (C / 16 = 5), two
# images per block, two N tiles per warp, the sweep's other slab depths
ODD_PLANS = [(256, None), (80, None), (384, (2, 4, 2, 48)),
             (192, (4, 8, 2, 96)), (32, None), (48, (8, 16, 1, 48)),
             (96, (8, 32, 1, 144))]
SMEM_LIMIT = 232448          # bytes of shared memory one block may use


def _cdiv(a, b):
    return -(-a // b)


def _m_real(plan, conv):
    """Real GEMM rows of conv 1 (mid positions) or conv 2 (outputs)."""
    if conv == 1:
        return plan.nb * (plan.th + 2) * (plan.tw + 2)
    return plan.nb * plan.th * plan.tw


def _slots(plan, conv):
    """M tiles per warp row of conv 1 or 2."""
    return _cdiv(_cdiv(_m_real(plan, conv), 16), plan.wm)


def _passes(plan, conv):
    """Passes over the K axis (each streams the weights once)."""
    return _cdiv(_slots(plan, conv), plan.mt)


def _gemm_rows(plan, conv):
    """The M walk of ``conv_gemm`` for conv 1 or 2: yields (pass, warp row,
    GEMM row r) for every real row it computes, in its order."""
    m_real = _m_real(plan, conv)
    m_tiles = _cdiv(m_real, 16)
    slots = _slots(plan, conv)
    for p in range(_passes(plan, conv)):
        for wm_i in range(plan.wm):
            for i in range(plan.mt):
                s = p * plan.mt + i
                t = s * plan.wm + wm_i
                if s < slots and t < m_tiles:
                    for r in range(t * 16, min(t * 16 + 16, m_real)):
                        yield p, wm_i, r


def _row_position(plan, conv, r):
    """(image, row, column) of GEMM row r in the tile it writes: the mid
    tile ((TH+2) x (TW+2)) for conv 1, the output tile for conv 2."""
    w = plan.tw + 2 if conv == 1 else plan.tw
    h = plan.th + 2 if conv == 1 else plan.th
    return r // (w * h), (r // w) % h, r % w


def _warp_n_tiles(plan):
    """Yields (warp column, N tile) for every N tile a warp owns."""
    for wn_i in range(plan.wn):
        for q in range(plan.nt):
            if wn_i * plan.nt + q < plan.c // 16:
                yield wn_i, wn_i * plan.nt + q


def _check_plan(plan):
    """The plan's shared-memory layout holds what the kernel addresses:
    padded slabs, or with a cluster swizzled [C][64] slabs at a 1024-byte
    boundary, each cluster block's share of the rows one TMA box, and the
    barriers after the slabs."""
    c, cp = plan.c, plan.cp
    assert cp == c + 8 and (cp * 2) % 32 == 16       # conflict-free rows
    assert plan.smem <= SMEM_LIMIT
    assert 2 <= plan.stages <= (3 if plan.cluster == 1 else fb._TMA_STAGES)
    assert plan.mid_off % 128 == 0 and plan.slab_off % 128 == 0
    assert plan.slab_bytes % 128 == 0
    assert (9 * c) % plan.ks == 0 and plan.ks % 16 == 0
    mt_max, depths = fb._PLAN_LIMITS[plan.nt]
    assert 1 <= plan.mt <= mt_max
    if plan.cluster > 1:
        assert plan.cluster in fb._CLUSTERS and plan.ks == 64
        assert plan.slab_bytes == c * 64 * 2 and plan.slab_off % 1024 == 0
        assert (c // plan.cluster) % 8 == 0 and c // plan.cluster <= 256
        assert plan.smem == (plan.slab_off + plan.stages * plan.slab_bytes
                             + fb._BAR_BYTES)
    else:
        assert plan.cluster == 1 and plan.ks in depths
        assert plan.smem == plan.slab_off + plan.stages * plan.slab_bytes
        assert plan.slab_bytes >= c * (plan.ks + 8) * 2
        assert ((plan.ks + 8) * 2) % 32 == 16
    assert plan.wm * plan.wn <= 8
    # the furthest byte an A fragment reads (row, tap (2, 2), last 16
    # channels) lies inside its tile: conv1 in the x tile, conv2 in mid
    for conv, base, end, pitch in (
            (1, 0, plan.mid_off, plan.tw + 4),
            (2, plan.mid_off, plan.slab_off, plan.tw + 2)):
        last = max(_tile_index(plan, conv, r)
                   for r in range(_m_real(plan, conv)))
        assert base + (last + 2 * pitch + 2 + 1) * cp * 2 <= end, conv


def _table_tile(plan):
    """The (TH, TW, NB, KS) a plan was made from: a cluster plan slabs 64
    columns whatever its tile's KS, so that one is the table's."""
    ks = fb.tile_for(plan.c)[3] if plan.cluster > 1 else plan.ks
    return plan.th, plan.tw, plan.nb, ks


def _tile_index(plan, conv, r):
    """Position index of GEMM row r in the activation tile its conv reads
    (the x tile, (TH+4) x (TW+4) per image, for conv 1; mid for conv 2)."""
    nb, y, x = _row_position(plan, conv, r)
    h, w = (plan.th + 4, plan.tw + 4) if conv == 1 else (plan.th + 2,
                                                          plan.tw + 2)
    return (nb * h + y) * w + x


def _check_rows(plan, conv):
    """Every real GEMM row is computed once, and the rows are the tile's
    positions, each once; every N tile has one owner."""
    rows = [r for _, _, r in _gemm_rows(plan, conv)]
    m_real = _m_real(plan, conv)
    assert sorted(rows) == list(range(m_real))
    h, w = (plan.th + 2, plan.tw + 2) if conv == 1 else (plan.th, plan.tw)
    positions = sorted(_row_position(plan, conv, r) for r in rows)
    assert positions == [(n, y, x) for n in range(plan.nb)
                         for y in range(h) for x in range(w)]
    owners = sorted(nt for _, nt in _warp_n_tiles(plan))
    assert owners == list(range(plan.c // 16))


@pytest.mark.parametrize("c", W48_WIDTHS)
def test_plan_for_w48_width_fits_shared_memory(c):
    plan = fb.plan_for(c)
    assert _table_tile(plan) == tuple(fb.tile_for(c))
    _check_plan(plan)


@pytest.mark.parametrize("conv", (1, 2))
@pytest.mark.parametrize("c", W48_WIDTHS)
def test_gemm_rows_cover_each_position_once(c, conv):
    _check_rows(fb.plan_for(c), conv)


@pytest.mark.parametrize("c,tile", ODD_PLANS)
def test_odd_plans_fit_and_cover_each_position_once(c, tile):
    plan = fb.plan_for(c, tile)
    _check_plan(plan)
    for conv in (1, 2):
        _check_rows(plan, conv)


def test_plan_passes_and_warp_grid():
    """C=256 at 8x8: 4 M tiles per warp row, 2 per pass -> 2 passes of
    conv1, 1 of conv2; C=80 (5 N tiles) leaves 3 warps idle."""
    plan = fb.plan_for(256, (8, 8, 1, 48))
    assert (plan.nt, plan.wn, plan.wm, plan.mt) == (4, 4, 2, 2)
    assert (_passes(plan, 1), _passes(plan, 2)) == (2, 1)
    plan = fb.plan_for(80)
    assert (plan.nt, plan.wn, plan.wm) == (1, 5, 1)
    assert {p for p, _, _ in _gemm_rows(plan, 1)} == set(range(
        _passes(plan, 1)))


def test_plan_rejects_tile_past_shared_memory():
    assert not fb.tile_fits(384, (8, 8, 1, 48))
    with pytest.raises(ValueError):
        fb.plan_for(384, (8, 8, 1, 48))
    with pytest.raises(ValueError):
        fb.plan_for(40)                      # no multiple of 16


def _variants(prelude):
    """The (MT, NT, KS, TMA) list of a library prelude's EGONET_VARIANTS."""
    assert prelude.startswith("#define EGONET_VARIANTS ")
    body = prelude[len("#define EGONET_VARIANTS "):].strip()
    return [tuple(int(v) for v in item.split(","))
            for item in body.replace("EGONET_VARIANT(", "").split(")")[:-1]]


def test_library_holds_the_variant_of_every_default_plan():
    """The default library instantiates each variant a default plan needs,
    once, and no other; the kernel's dispatch is that list."""
    name, source, prelude = fb.library()
    assert (name, source) == ("fused_basic_block", "fused_basic_block")
    needed = {(p.mt, p.nt, p.ks, int(p.cluster > 1)) for p in (
        fb.plan_for(c) for c in range(16, 513, 16) if fb.tile_fits(c, None))}
    got = _variants(prelude)
    assert got == sorted(needed)
    for c in W48_WIDTHS:
        p = fb.plan_for(c)
        assert fb.variant(p) in got
    with open(os.path.join(_build.CSRC, "fused_basic_block.cu")) as f:
        src = f.read()
    # no variant is written in the source: it takes the prelude's list
    assert "EGONET_VARIANTS" in src and "EGONET_VARIANT(1" not in src


def test_sweep_library_is_named_by_its_variants():
    plans = [fb.plan_for(48, (8, 16, 1, 48)), fb.plan_for(96, (8, 32, 1, 96))]
    name, source, prelude = fb.library(plans)
    assert source == "fused_basic_block" and name != "fused_basic_block"
    assert _variants(prelude) == [(2, 3, 48, 0), (6, 3, 96, 0)]
    assert fb.library(plans[::-1]) == (name, source, prelude)
    assert fb.library(plans[:1])[0] != name


def test_build_rebuilds_a_library_when_its_prelude_changes(tmp_path,
                                                           monkeypatch):
    """A library built with one prelude is stale once the prelude's text
    changes, and not before (no nvcc needed: the library is a stand-in)."""
    monkeypatch.setattr(_build, "CSRC", str(tmp_path / "csrc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(_build.CSRC)
    os.makedirs(_build.BUILD_DIR)
    src, lib = _build._paths("k_abc", "k")
    assert src.endswith(os.path.join("csrc", "k.cu"))
    open(src, "w").close()
    _build._write_prelude("k_abc", "#define A 1\n")
    open(lib, "w").close()
    t = os.path.getmtime(_build._prelude_path("k_abc")) + 10
    os.utime(lib, (t, t))
    assert not _build._stale("k_abc", "k", "#define A 1\n")
    _build._write_prelude("k_abc", "#define A 1\n")      # same text: kept
    assert not _build._stale("k_abc", "k", "#define A 1\n")
    _build._write_prelude("k_abc", "#define A 2\n")
    os.utime(_build._prelude_path("k_abc"), (t + 10, t + 10))
    assert _build._stale("k_abc", "k", "#define A 2\n")
    assert _build._spec("k") == ("k", "k", None)


def _kernel_case(C, H, W, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(C)
    dev = "cuda"
    std = (1.0 / (9 * C)) ** 0.5
    x = (torch.randn(B, H, W, C, device=dev, generator=g) * 0.5).bfloat16()
    w1 = (torch.randn(C, 3, 3, C, device=dev, generator=g) * std).bfloat16()
    w2 = (torch.randn(C, 3, 3, C, device=dev, generator=g) * std).bfloat16()
    b1 = torch.randn(C, device=dev, generator=g) * 0.1
    b2 = torch.randn(C, device=dev, generator=g) * 0.1
    before = fb.fused_basic_block.launches
    multicast = fb.fused_basic_block.multicast_launches
    y = fb.fused_basic_block(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fb.fused_basic_block.launches == before + 1
    # a launch as clusters counts there too, and only then
    assert fb.fused_basic_block.multicast_launches == multicast + (
        fb.plan_for(C).cluster > 1)
    ref = fb.fused_basic_block_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(y.float(), ref.float(), atol=5e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H", [(48, 64), (96, 32), (192, 16), (384, 8)])
def test_kernel_matches_plain_version_w48_shapes(C, H):
    _kernel_case(C, H, H, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,W,B", [(96, 20, 36, 3), (384, 8, 8, 1)])
def test_kernel_matches_plain_version_odd_shapes(C, H, W, B):
    """A map no tile divides in either direction, and one image at
    C=384."""
    _kernel_case(C, H, W, B)


# ------------------------------------------------- clusters sharing weights

# (C, map size, blocks a cluster by the rule) at the W48 and W32 widths
HRNET_CLUSTERS = [(384, 8, 2), (192, 16, 2), (96, 32, 1), (48, 64, 1),
                  (256, 6, 2), (128, 12, 2), (64, 24, 2), (32, 48, 1)]
CLUSTERED = [(c, h) for c, h, k in HRNET_CLUSTERS if k > 1]


@pytest.mark.parametrize("c,h,k", HRNET_CLUSTERS)
def test_cluster_rule_at_the_hrnet_widths(c, h, k):
    """k from (M1 + M2) / 2, the operations per weight byte a block
    streams: the rule's cluster below the threshold, 1 at or above it."""
    plan = fb.plan_for(c)
    th, tw, nb = fb.tile_for(c)[:3]
    f = fb.flop_per_weight_byte(th, tw, nb)
    assert f == (nb * (th + 2) * (tw + 2) + nb * th * tw) / 2
    assert plan.cluster == fb.cluster_for(c, th, tw, nb) == k
    assert (f < fb._MULTICAST_BELOW) == (k > 1)
    assert k in (1, fb._CLUSTER)
    _check_plan(plan)


def test_cluster_needs_whole_slab_rows_and_shared_memory():
    """A width whose 9C columns take no 64-column slab, or a forced
    cluster no TMA box serves, has no cluster plan; where a cluster plan
    does not fit, the rule falls back to the unclustered one."""
    assert fb.cluster_for(48, 4, 4, 1) == 1          # 26 ops/byte, C % 64
    with pytest.raises(ValueError):
        fb.plan_for(48, None, 2)
    with pytest.raises(ValueError):
        fb.plan_for(384, None, 3)
    assert fb.plan_for(192, None, 1).cluster == 1
    assert fb.plan_for(192, None, 1).ks == fb.tile_for(192)[3]
    # C=320 at the fallback tile: 82 ops/byte, but two swizzled slabs do
    # not fit beside its x and mid tiles
    assert fb.cluster_for(320, 8, 8, 1) == fb._CLUSTER
    assert not fb.tile_fits(320, None, fb._CLUSTER)
    assert fb.plan_for(320).cluster == 1


def _kernel_struct_fields(name):
    """The field names of ``struct <name>`` in csrc/fused_basic_block.cu."""
    import re
    with open(os.path.join(_build.CSRC, "fused_basic_block.cu")) as f:
        src = f.read()
    body = src[src.index(f"struct {name} {{"):]
    body = body[:body.index("};")]
    return [n for decl in re.findall(r"^\s*int ([^;]+);", body, re.M)
            for n in (v.strip() for v in decl.split(","))]


def test_plan_fields_match_the_kernel_struct():
    """The plan's fields, in the order the CUDA operator's TiledPlan takes
    them (its prelude's X-macro), are the kernel's Plan struct's."""
    fields = _kernel_struct_fields("Plan")
    assert fields == fb._PLAN_FIELDS
    assert fields[-1] == "cluster"
    prelude = _build._plans_prelude()
    line = next(ln for ln in prelude.splitlines()
                if ln.startswith("#define EGONET_TILED_FIELDS(X) "))
    assert line.split(") ", 1)[1].split() == [f"X({f})" for f in fields]


def test_library_holds_each_cluster_variant():
    """Each clustered width's variant is in the default library with its
    TMA flag set, and each unclustered width's without it."""
    got = _variants(fb.library()[2])
    for c, _, k in HRNET_CLUSTERS:
        mt, nt, ks, tma = fb.variant(fb.plan_for(c))
        assert (mt, nt, ks, tma) in got
        assert tma == int(k > 1) and (ks == 64) == (k > 1)


@pytest.mark.parametrize("n", [1, 3, 5, 16, 32, 512])
def test_padded_grid_is_a_multiple_of_the_cluster(n):
    """The grid's image groups round up to a multiple of the cluster, by
    fewer than one cluster; without one they are the batch's."""
    for c, h, k in HRNET_CLUSTERS:
        plan = fb.plan_for(c)
        gx, gy = fb.grid_for(plan, n, h, h)
        assert gx == -(-h // plan.th) * -(-h // plan.tw)
        assert gy % k == 0 and gy * plan.nb >= n
        assert gy - k < -(-n // plan.nb)
        if k == 1:
            assert gy == -(-n // plan.nb)


def test_swizzled_b_fragments_read_their_elements():
    """The B fragments of a cluster plan, at conv_gemm's swizzled offsets
    (b_lane + b_k[kk]), read exactly the weight elements they stand for in
    a slab TMA wrote with the 128-byte swizzle (element (n, k) of a [C][64]
    slab at byte 128 n + 16 ((k / 8) ^ (n % 8)) + 2 (k % 8)), and the 8
    rows of every ldmatrix phase fall on distinct 16-byte bank groups."""
    def swizzled(n, k):
        return 128 * n + 16 * ((k // 8) ^ (n % 8)) + 2 * (k % 8)

    for c in (384, 192, 256, 128, 64):
        plan = fb.plan_for(c)
        assert plan.cluster > 1 and plan.ks == 64
        n_tiles = c // 16
        for wn_i in range(plan.wn):
            for q in range(plan.nt):
                nt = min(wn_i * plan.nt + q, n_tiles - 1)
                for kk in range(plan.ks // 16):
                    groups = {}
                    for lane in range(32):
                        b_lane = ((lane % 8 + 8 * (lane // 16)) * 128
                                  + (((lane // 8) % 2) ^ (lane % 2)) * 16)
                        b_k = (kk ^ ((lane % 8) // 2)) * 32
                        addr = b_lane + b_k + nt * 16 * 128
                        # matrix lane / 8: output channels 8 (lane / 16)
                        # + 0..7, K half (lane / 8) % 2 of step kk
                        n = nt * 16 + lane % 8 + 8 * (lane // 16)
                        k0 = 16 * kk + 8 * ((lane // 8) % 2)
                        assert addr == swizzled(n, k0)
                        assert addr + 14 == swizzled(n, k0 + 7)
                        groups.setdefault(lane // 8, []).append(
                            (addr // 16) % 8)
                    for banks in groups.values():
                        assert sorted(banks) == list(range(8))


def test_cluster_plans_fill_the_shared_memory_they_may_use():
    """A cluster plan takes as many slabs as fit, up to 8: in half the
    SM's shared memory where the variant runs two blocks an SM (few
    accumulators) and two slabs fit so, else in the block's limit."""
    for c, _ in CLUSTERED:
        plan = fb.plan_for(c)
        two = plan.mt * plan.nt <= 6 and (
            plan.slab_off + 2 * plan.slab_bytes + fb._BAR_BYTES
            <= fb._SM_SMEM // 2 - fb._BLOCK_RESERVED)
        limit = fb._SM_SMEM // 2 - fb._BLOCK_RESERVED if two else SMEM_LIMIT
        assert plan.smem <= limit
        assert (plan.stages == fb._TMA_STAGES
                or plan.smem + plan.slab_bytes > limit)
    assert [fb.plan_for(c).stages for c in (384, 192, 256, 128, 64)] == [
        3, 5, 2, 4, 8]


def test_cluster_shares_are_whole_swizzle_atoms():
    """Block r of a cluster loads rows [r C / k, (r + 1) C / k) of each
    slab: every share starts on a 1024-byte boundary (the swizzle's atom
    of 8 rows), and the shares tile the slab."""
    for c, _ in CLUSTERED:
        plan = fb.plan_for(c)
        rows = c // plan.cluster
        starts = [plan.slab_off + r * rows * 128
                  for r in range(plan.cluster)]
        assert all(a % 1024 == 0 for a in starts)
        assert rows * 128 * plan.cluster == plan.slab_bytes
        assert 8 <= rows <= 256


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 5, 16, 32])
@pytest.mark.parametrize("C,H", CLUSTERED)
def test_cluster_kernel_matches_plain_version(C, H, B):
    """Every clustered width against the plain version, at batches that
    are and are not multiples of the cluster."""
    _kernel_case(C, H, H, B)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H", [(384, 8), (256, 6)])
def test_cluster_kernel_matches_plain_version_at_the_main_bucket(C, H):
    """The main path's bucket, 512 crops, at the two widths with the most
    clusters a launch."""
    _kernel_case(C, H, H, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H", [(48, 64), (96, 32), (32, 48)])
def test_unclustered_widths_leave_the_multicast_count(C, H):
    """The widths the rule keeps unclustered launch without a cluster:
    ``multicast_launches`` stays where it was."""
    _kernel_case(C, H, H, 4)
