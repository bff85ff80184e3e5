"""The port's row-streaming fused BasicBlock
(egonet_tpu_torch/ops/fused_block_stencil.py) against the JAX package's
Pallas stencil kernel (interpret mode on CPU) and its XLA oracle; the
EGONET_PALLAS_STENCIL flag and probe; the HRNet wiring; the kernel's
launch plans (layout, row map, channel slices) and its row schedule,
restated here (:func:`step_schedule`: the rings replayed, and a torch walk
of the schedule against the plain version).

These check the plans and this file's restatement of the kernel's sweep,
not the kernel's own row loop.  The CUDA kernel runs only on the card: the
``cuda`` cases skip without one, and only ``python3 chip_smoke.py``, which
holds the kernel against its plain version at the W48 shapes, at odd ones
and at every plan of its sweep on every chip run, tests the kernel's own
schedule."""

import inspect
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from egonet_tpu.ops import pallas_block as pb
from egonet_tpu.ops import pallas_block_stencil as pbs
from egonet_tpu_torch.ops import _build
from egonet_tpu_torch.ops import fused_block as fb
from egonet_tpu_torch.ops import fused_block_stencil as st

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


def _folded(params, dtype):
    c = params["w1"].shape[0]
    return (torch.from_numpy(params["w1"]).reshape(c, 3, 3, c).to(dtype),
            torch.from_numpy(params["b1"]).reshape(-1),
            torch.from_numpy(params["w2"]).reshape(c, 3, 3, c).to(dtype),
            torch.from_numpy(params["b2"]).reshape(-1))


def test_plain_version_is_the_tiled_kernels():
    assert st.fused_basic_block_reference is fb.fused_basic_block_reference


@pytest.mark.parametrize("H,W,C,B,TW", [
    (8, 8, 8, 16, 8),
    (16, 16, 8, 8, 8),
])
def test_plain_version_bf16_matches_pallas_stencil(rng, H, W, C, B, TW):
    """bf16 operands on both sides, the JAX test's bar (atol 0.15, rtol
    0.05); the observed maximum is printed."""
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    params = pbs.pack_stencil_weights(w1, bn1, w2, bn2)
    xT = jnp.asarray(np.transpose(x, (1, 2, 3, 0))).astype(jnp.bfloat16)
    yT = pbs.fused_basic_block_stencil(xT, params, tile_cols=TW,
                                       interpret=True)
    pallas = np.transpose(np.asarray(yT, dtype=np.float32), (3, 0, 1, 2))
    got = st.fused_basic_block_stencil(
        torch.from_numpy(x).bfloat16(),
        *_folded(fb.pack_block_weights(w1, bn1, w2, bn2), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    print(f"max |plain - pallas stencil| = {np.abs(got - pallas).max():.4g}")
    np.testing.assert_allclose(got, pallas, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("H,W,C,B", [(8, 8, 8, 16), (16, 16, 8, 8),
                                     (6, 11, 16, 3)])
def test_plain_version_fp32_matches_xla_reference(rng, H, W, C, B):
    w1, bn1, w2, bn2 = _random_block(rng, C)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    ref = np.asarray(pb.reference_basic_block(jnp.asarray(x), w1, bn1,
                                              w2, bn2))
    got = st.fused_basic_block_stencil(
        torch.from_numpy(x),
        *_folded(fb.pack_block_weights(w1, bn1, w2, bn2), torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_pack_stencil_weights_equals_jax(rng):
    """w2p[r] is the ring-rotation permutation of the port's folded w2."""
    w1, bn1, w2, bn2 = _random_block(rng, 16)
    ours = st.pack_stencil_weights(w1, bn1, w2, bn2)
    theirs = pbs.pack_stencil_weights(w1, bn1, w2, bn2)
    for k in ("w1", "b1", "b2", "w2p"):
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
    w2 = fb.pack_block_weights(w1, bn1, w2, bn2)["w2"].reshape(16, 3, 3, 16)
    for r in range(3):
        for j in range(3):
            np.testing.assert_array_equal(
                ours["w2p"][r].reshape(16, 3, 3, 16)[:, j],
                w2[:, (j - r) % 3])


def test_probe_args_match_jax_probe():
    """The probe's input is the JAX probe's, in the port's NHWC layout."""
    x, (w1, b1, w2, b2) = st.probe_args(tile_cols=8, channels=8, width=16,
                                        batch=4, height=4)
    jx, jp = pbs.probe_args(tile_cols=8, channels=8, width=16, batch=4,
                            height=4)
    assert x.shape == (4, 4, 16, 8) and x.dtype == torch.bfloat16
    np.testing.assert_allclose(
        x.float().numpy(),
        np.transpose(np.asarray(jx, np.float32), (3, 0, 1, 2)),
        rtol=2 ** -7)
    np.testing.assert_array_equal(
        w1.float().numpy().reshape(8, -1),
        torch.from_numpy(np.array(jp["w1"])).bfloat16().float().numpy())
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jp["b2"])[0])
    y = st.fused_basic_block_stencil(x, w1, b1, w2, b2)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()


def test_stencil_flag_gating(monkeypatch):
    """EGONET_PALLAS_STENCIL: '0' off, '1' on, 'auto' consults the cached
    probe (the cache key comes from the probe's own defaults)."""
    assert st.stencil_enabled("0") is False
    assert st.stencil_enabled("1") is True
    monkeypatch.setenv("EGONET_PALLAS_STENCIL", "0")
    assert st.stencil_enabled() is False
    monkeypatch.setenv("EGONET_PALLAS_STENCIL", "1")
    assert st.stencil_enabled() is True
    key = tuple(p.default for p in
                inspect.signature(st.probe_wide_tile).parameters.values())
    assert key == tuple(p.default for p in
                        inspect.signature(pbs.probe_wide_tile)
                        .parameters.values())
    monkeypatch.setattr(st, "_PROBE_CACHE", {key: False})
    assert st.stencil_enabled("auto") is False
    st._PROBE_CACHE[key] = True
    assert st.stencil_enabled("auto") is True


def test_auto_is_off_without_cuda(monkeypatch):
    monkeypatch.setattr(st, "_PROBE_CACHE", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert st.probe_wide_tile() is False
    assert st.stencil_enabled("auto") is False


def test_wrapper_takes_plain_version_for_cpu_tensor():
    """On a CPU tensor the wrapper runs the operator's CPU kernel, the
    plain version in ATen (csrc/egonet_ops.cpp), and counts no launch."""
    rng = np.random.RandomState(0)
    before = st.fused_basic_block_stencil.launches
    c = 16
    x = torch.from_numpy(rng.randn(1, 4, 4, c).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(c, 3, 3, c).astype(np.float32)
                         * 0.05).bfloat16()
    b = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
    # the operator's CPU kernel is the plain version
    assert torch.equal(st.fused_basic_block_stencil(x, w, b, w, b),
                       st.fused_basic_block_reference(x, w, b, w, b))
    assert st.fused_basic_block_stencil.launches == before


def test_hrnet_stencil_flag_selects_wrapper_and_matches_tiled(monkeypatch):
    """Shrunk HRNet, bf16 eval on the CPU: stencil='1' sends the fusable
    blocks to the stencil wrapper, '0' to the tiled one, with identical
    outputs (both run the same plain version here); an explicit choice
    survives a rebuild."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.init import numpy_init
    from tests import fixtures
    monkeypatch.delenv("EGONET_PALLAS_STENCIL", raising=False)
    cfg = fixtures.shrink_hrnet(demo_config(), num_blocks=2)
    net = numpy_init(build_heatmap_model(cfg, dtype=torch.bfloat16), 3).eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 64, 64).astype(np.float32))
    calls = {"tiled": 0, "stencil": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fb, "fused_basic_block",
                        counting("tiled", fb.fused_basic_block))
    monkeypatch.setattr(st, "fused_basic_block_stencil",
                        counting("stencil", st.fused_basic_block_stencil))
    with torch.no_grad():
        net.prepare_inference(stencil="0")
        maps0, coords0 = net(x)
        n_blocks = calls["tiled"]
        assert n_blocks > 0 and calls["stencil"] == 0
        net.prepare_inference(stencil="1")
        net.load_state_dict(net.state_dict())      # rebuilds the cache
        maps1, coords1 = net(x)
    assert net.stencil == "1"
    assert calls == {"tiled": n_blocks, "stencil": n_blocks}
    torch.testing.assert_close(maps1, maps0, atol=0, rtol=0)
    torch.testing.assert_close(coords1, coords0, atol=0, rtol=0)


def test_build_treats_a_newer_header_as_stale(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    (csrc / "k.cu").write_text("")
    assert _build._stale("k")
    (build / "libk.so").write_text("")
    os.utime(csrc / "k.cu", (1, 1))
    assert not _build._stale("k")
    (csrc / "common.cuh").write_text("")
    os.utime(csrc / "common.cuh", (2 ** 31, 2 ** 31))
    assert _build._stale("k")


# ---------------------------------------------------------------------------
# the launch plan (no library needed) and its schedule
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448
W48_WIDTHS = (48, 96, 192, 384)
# the odd widths chip_smoke.py checks the kernel at (STENCIL_EXTRA)
EXTRA_WIDTHS = (32, 64, 48)
# (C, tile) plans beside the defaults, tiles (TW, RH, NB, K, WM1, WM2,
# WN[, KS]): two images, two rows per step and a ragged tile over a cluster
# of 2; streamed slabs; more conv1 warps along M than conv1 has M tiles; a
# cluster of 4 with two warps along N and three rows per step; the probe's
# (TW, NB) override; C=384 streamed with one image
ODD_PLANS = [(32, (4, 2, 2, 2, 1, 1, 1)), (32, (4, 1, 2, 2, 1, 1, 2, 16)),
             (32, (6, 1, 2, 1, 2, 1, 2)), (64, (3, 3, 1, 4, 1, 1, 2)),
             (48, (32, 1)), (384, (8, 1, 1, 8, 1, 1, 3, 48))]


def _check_plan(plan):
    """The plan's shared-memory layout holds what the kernel addresses
    (the kernel's plan_ok, restated)."""
    c = plan.c
    assert plan.cp == c + 8 and (plan.cp * 2) % 32 == 16   # conflict-free
    assert (plan.wp * 2) % 32 == 16
    assert plan.k * plan.cpc == c and plan.cpc % 8 == 0 and plan.k <= 8
    assert plan.wn * plan.nt * 8 == plan.cpc and plan.warps <= 8
    assert max(plan.mt1, plan.mt2) * plan.nt <= st._MAX_ACC
    for conv, mt, wm in ((1, plan.mt1, plan.wm1), (2, plan.mt2, plan.wm2)):
        assert mt == -(-(-(-_m_real(plan, conv) // 16)) // wm)
    assert (plan.xp, plan.mp) == (plan.tw + 4, plan.tw + 2)
    assert plan.ahead in ((1, 2) if plan.resident else (1,))
    assert (plan.x_slots, plan.mid_slots) == ((plan.ahead + 1) * plan.rh + 2,
                                              2 * plan.rh + 2)
    for off in (plan.x_slot, plan.mid_slot, plan.mid_off, plan.w_off,
                plan.w_bytes):
        assert off % 128 == 0
    assert plan.x_slot >= plan.nb * plan.xp * plan.cp * 2
    assert plan.mid_slot >= plan.nb * plan.mp * plan.cp * 2
    assert plan.mid_off >= plan.x_slots * plan.x_slot
    assert plan.w_off >= plan.mid_off + plan.mid_slots * plan.mid_slot
    if plan.resident:
        assert (plan.ks, plan.stages, plan.wp) == (0, 0, 9 * c + 8)
        assert plan.kc * 16 == c
        assert plan.w_bytes >= plan.cpc * plan.wp * 2
        w_end = plan.w_off + 2 * plan.w_bytes
    else:
        assert plan.kc * 16 == plan.ks and c % plan.ks == 0
        assert plan.stages in (2, 3) and plan.wp == plan.ks + 8
        assert plan.w_bytes >= 2 * plan.cpc * plan.wp * 2
        w_end = plan.w_off + plan.stages * plan.w_bytes
    assert plan.smem == w_end <= SMEM_LIMIT
    # the furthest byte an A fragment reads (last real row, tap dx = 2,
    # last 16 channels) lies in its ring slot
    for conv, slot, pitch in ((1, plan.x_slot, plan.xp),
                              (2, plan.mid_slot, plan.mp)):
        _, nb, col = _row_position(plan, conv, _m_real(plan, conv) - 1)
        assert ((nb * pitch + col + 2) * plan.cp + c) * 2 <= slot


def _cols(plan, conv, w=None):
    """(GEMM columns per image row, column of GEMM column 0): conv 2's TW
    output columns; conv 1's TW + 2 mid columns, or, where one tile spans
    an image of width w, its w inner ones (the halo is zero padding)."""
    if conv == 2:
        return plan.tw, 0
    return (w, 1) if w is not None and w <= plan.tw else (plan.tw + 2, 0)


def _m_real(plan, conv, w=None):
    return plan.rh * plan.nb * _cols(plan, conv, w)[0]


def _row_position(plan, conv, r, w=None):
    """(row of the step, image, column) of GEMM row r: a mid column (conv
    1) or an output column (conv 2) of the tile."""
    cols, c0 = _cols(plan, conv, w)
    return r // (plan.nb * cols), r % (plan.nb * cols) // cols, r % cols + c0


def _warps(plan):
    """Yields (conv, M index within it, N index) of every warp, as the
    kernel numbers them."""
    wm = plan.wm1 + plan.wm2
    for warp in range(plan.warps):
        wm_i, wn_i = warp % wm, warp // wm
        if wm_i < plan.wm1:
            yield 1, wm_i, wn_i
        else:
            yield 2, wm_i - plan.wm1, wn_i


def _warp_rows(plan, conv, mi, w=None):
    """The real GEMM rows the warps of index mi along conv's M compute
    (tiles past the real ones are clamped reads, dropped)."""
    mt, wm = (plan.mt1, plan.wm1) if conv == 1 else (plan.mt2, plan.wm2)
    m_real = _m_real(plan, conv, w)
    for i in range(mt):
        t = mi + i * wm
        yield from (r for r in range(t * 16, t * 16 + 16) if r < m_real)


def _warp_channels(plan, rank, wn_i):
    co0 = rank * plan.cpc + wn_i * plan.nt * 8
    return range(co0, co0 + plan.nt * 8)


@pytest.mark.parametrize("c", W48_WIDTHS)
def test_w48_plan_fits_shared_memory(c):
    """The W48 plans: weights resident at C = 48, 96, 192 (a cluster where
    one block cannot hold them), streamed 1/K shares at C=384."""
    plan = st.plan_for(c)
    assert plan.tile == tuple(st.tile_for(c))
    _check_plan(plan)
    assert plan.resident == (c != 384)
    if c == 384:
        assert plan.k == 8 and plan.cpc == 48
    if c == 192:
        assert plan.k == 8 and plan.nt * plan.wn == 3   # 3 n8 tiles a block


@pytest.mark.parametrize("c", EXTRA_WIDTHS)
def test_extra_width_plan_fits_shared_memory(c):
    _check_plan(st.plan_for(c))


@pytest.mark.parametrize("c,tile", ODD_PLANS)
def test_odd_plan_fits_shared_memory(c, tile):
    _check_plan(st.plan_for(c, tile))


@pytest.mark.parametrize("c,tile", [(c, None) for c in W48_WIDTHS]
                         + ODD_PLANS)
def test_channel_slices_and_k_chunks_cover_once(c, tile):
    """The K blocks' channel slices, and the warps' n8 tiles in them, cover
    [0, C) exactly once per warp row; each warp's K walk covers each tap's
    C channels once (KC chunks of 16 resident, C / KS slabs of KC chunks
    streamed)."""
    plan = st.plan_for(c, tile)
    warps = list(_warps(plan))
    assert len(warps) == len(set(warps)) == plan.warps
    for conv, mi in {(w[0], w[1]) for w in warps}:
        chans = [ch for rank in range(plan.k)
                 for cv, m, n in warps if (cv, m) == (conv, mi)
                 for ch in _warp_channels(plan, rank, n)]
        assert sorted(chans) == list(range(c))
    per_tap = c // plan.ks if not plan.resident else 1
    assert per_tap * plan.kc * 16 == c
    assert {w[0] for w in warps} == {1, 2}


@pytest.mark.parametrize("conv", (1, 2))
@pytest.mark.parametrize("c,tile", [(c, None) for c in W48_WIDTHS]
                         + ODD_PLANS)
def test_gemm_rows_cover_each_position_once(c, tile, conv):
    """conv1's rows are the RH x NB x (TW+2) mid positions of a step and
    conv2's the RH x NB x TW output positions, each once over the warp
    rows, with no padding row."""
    plan = st.plan_for(c, tile)
    rows = [r for mi in range(plan.wm1 if conv == 1 else plan.wm2)
            for r in _warp_rows(plan, conv, mi)]
    assert sorted(rows) == list(range(_m_real(plan, conv)))
    w = plan.tw + 2 if conv == 1 else plan.tw
    assert sorted(_row_position(plan, conv, r) for r in rows) == [
        (rr, nb, col) for rr in range(plan.rh) for nb in range(plan.nb)
        for col in range(w)]


def test_gemm_rows_of_a_tile_spanning_the_image_skip_the_halo():
    """Where one tile spans the image (C=192: 16 columns, TW=16), conv1's
    GEMM rows are the 16 inner mid columns only (one M tile, not two), each
    once; the zero halo columns are never computed."""
    plan = st.plan_for(192)
    assert plan.tw == 16 and plan.wm1 == 2
    rows = [r for mi in range(plan.wm1)
            for r in _warp_rows(plan, 1, mi, w=16)]
    assert sorted(rows) == list(range(16))
    assert sorted(_row_position(plan, 1, r, w=16) for r in rows) == [
        (0, 0, col) for col in range(1, 17)]
    assert list(_warp_rows(plan, 1, 1, w=16)) == []


def step_schedule(h, rh=1, ahead=2):
    """The steps of one sweep over an image of ``h`` rows, ``rh`` rows per
    step, as the kernel's ``sweep`` runs them: for s = 1 .. ceil((h+1)/rh)
    + 1, the x rows fetched (``ahead`` steps before the step that reads
    them; they land by the end of step s + ahead - 1), the mid rows written
    (conv1; those from h on are written as zeros), the output rows
    computed (conv2, whose residual is read from device memory), and the
    rows each of them reads from the rings.  Before step 1 the kernel
    fetches x rows -1 .. ahead rh and zeroes mid row -1; one barrier ends
    each step.  Row r sits in x slot r mod ((ahead + 1) rh + 2) and mid
    slot r mod (2 rh + 2)."""
    steps = []
    for s in range(1, -(-(h + 1) // rh) + 2):
        mids = list(range(rh * (s - 1), rh * s))
        outs = [y for y in range(rh * (s - 2) - 1, rh * (s - 1) - 1)
                if 0 <= y < h]
        steps.append({
            "s": s,
            "fetch_x": list(range(rh * (s + ahead - 1) + 1,
                                  min(rh * (s + ahead), h) + 1)),
            "mid_writes": mids,
            "conv1": [m for m in mids if m < h],
            "conv2": outs,
            "x_reads": sorted({r for m in mids if m < h
                               for r in (m - 1, m, m + 1)}),
            "mid_reads": sorted({r for y in outs for r in (y - 1, y, y + 1)}),
        })
    return steps


@pytest.mark.parametrize("ahead", [1, 2])
@pytest.mark.parametrize("rh", [1, 2, 3])
@pytest.mark.parametrize("h", [1, 2, 3, 4, 5, 8, 16, 64])
def test_rings_hold_each_row_while_it_is_read(h, rh, ahead):
    """Replaying :func:`step_schedule` with an ((AHEAD + 1) RH + 2)-slot x ring
    and a (2 RH + 2)-slot mid ring: every row a step reads sits in its
    slot, put there before step 1 or in an earlier step (an x row fetched
    AHEAD steps ahead lands by the end of the step before its reader), and
    not overwritten since, even where the step's own writes land first; so
    no step writes a slot its conv2 reads, and one barrier per step is
    enough."""
    xs, ms = (ahead + 1) * rh + 2, 2 * rh + 2
    # slot: (row, step that wrote it); the prologue waits for its copies
    x_slots = {r % xs: (r, -1) for r in range(-1, min(ahead * rh, h) + 1)}
    mid_slots = {-1 % ms: (-1, -1)}
    conv1_rows, conv2_rows = [], []
    for step in step_schedule(h, rh, ahead):
        s, written = step["s"], set()
        for r in step["fetch_x"]:
            x_slots[r % xs] = (r, s)
            written.add(("x", r % xs))
        for r in step["mid_writes"]:
            mid_slots[r % ms] = (r, s)
            written.add(("mid", r % ms))
        for r in step["x_reads"]:
            if r == h:
                continue       # the zero row past the image: never fetched
            row, when = x_slots[r % xs]
            assert row == r and when <= s - ahead
            assert ("x", r % xs) not in written
        for r in step["mid_reads"]:
            row, when = mid_slots[r % ms]
            assert row == r and when < s and ("mid", r % ms) not in written
        assert all(-1 <= r <= h for r in step["x_reads"])
        conv1_rows += step["conv1"]
        conv2_rows += step["conv2"]
    assert conv1_rows == list(range(h)) and conv2_rows == list(range(h))
    assert len(step_schedule(h, rh, ahead)) == -(-(h + 1) // rh) + 1


def test_bad_plans_are_rejected():
    for c, tile in [(40, None),                            # no multiple of 16
                    (32, (8, 1, 1, 3, 1, 1, 1)),           # 32 channels over 3
                    (48, (8, 1, 1, 1, 1, 1, 4)),           # 6 n8 tiles over 4
                    (96, (8, 1, 1, 1, 4, 5, 1)),           # 9 warps along M
                    (96, (8, 1, 1, 4, 2, 1, 3)),           # 9 warps, 3 along N
                    (96, (8, 1, 1, 16, 1, 1, 1)),          # cluster past 8
                    (48, (64, 1, 1, 1, 1, 1, 1)),          # 5 x 6 > 24
                    (192, (8, 1, 1, 8, 0, 1, 1)),          # no conv1 warp
                    (384, (8, 1, 1, 8, 1, 1, 3, 40)),      # slab depth
                    (384, (8, 1, 4, 8, 1, 1, 1)),          # rings past 227 KB
                    (48, (8, 0, 1, 1, 1, 1, 3)),           # no rows per step
                    (48, (8, 1, 1, 1, 1, 3)),              # short tile
                    (48, (8, 1, 1, 1, 1, 1, 1, 48, 1))]:   # long tile
        assert not st.tile_fits(c, tile), (c, tile)
        with pytest.raises(ValueError):
            st.plan_for(c, tile)


def test_plan_is_resident_where_it_fits_and_streams_otherwise():
    """A 7-entry tile keeps the weights resident where they fit and
    streams them (the widest slab that fits) where not; C=96 in one block
    does not fit (2 x 96 x 872 x 2 bytes), a cluster of 2 does."""
    assert not st.plan_for(96, (8, 1, 1, 1, 1, 1, 3)).resident
    assert st.plan_for(96, (8, 1, 1, 1, 1, 1, 3)).ks == 96
    assert st.plan_for(96, (8, 1, 1, 2, 1, 1, 3)).resident
    assert st.plan_for(384, (8, 1, 1, 8, 1, 1, 3)).ks == 96
    # (TW, NB) takes one row per step and the rest of the default, with
    # warps added along M where a warp would hold too many accumulators
    plan = st.plan_for(48, (32, 1))
    assert (plan.tw, plan.rh, plan.nb, plan.k) == (32, 1, 1, 1)
    assert (plan.wm1, plan.wm2) == (1, 1)
    plan = st.plan_for(32, (64, 2))
    assert (plan.tw, plan.nb, plan.wm1, plan.wm2) == (64, 2, 2, 2)
    assert plan.warps <= 8 and max(plan.mt1, plan.mt2) * plan.nt <= 24


def _library_variants(prelude):
    body = prelude[len("#define EGONET_VARIANTS "):].strip()
    return [tuple(int(v) for v in item.split(","))
            for item in body.replace("EGONET_VARIANT(", "").split(")")[:-1]]


def test_library_holds_the_variant_of_every_default_plan():
    name, source, prelude = st.library()
    assert (name, source) == ("fused_basic_block_stencil",
                              "fused_basic_block_stencil")
    needed = {(p.mt1, p.mt2, p.nt, p.kc, 1 - p.resident) for p in (
        st.plan_for(c) for c in range(16, 385, 16) if st.tile_fits(c, None))}
    assert _library_variants(prelude) == sorted(needed)
    plans = [st.plan_for(c, t) for c, t in ODD_PLANS]
    other = st.library(plans)
    assert other[0] != name and other[1] == source
    assert other == st.library(plans[::-1])
    with open(os.path.join(_build.CSRC, "fused_basic_block_stencil.cu")) as f:
        src = f.read()
    assert "EGONET_VARIANTS" in src and "EGONET_VARIANT(1" not in src


def test_probe_tile_runs_a_default_library_variant():
    """probe_wide_tile's 32-column tile at C=48 runs the C=48 default
    plan's kernel variant, so 'auto' checks a kernel the model launches and
    builds no library of its own."""
    probe = st.plan_for(48, (32, 1))
    assert probe != st.plan_for(48)
    assert st._variant(probe) == st._variant(st.plan_for(48))
    assert st._variant(probe) in _library_variants(st.library()[2])


def test_tile_override_outside_the_default_library_is_refused(monkeypatch):
    """A tile whose kernel variant the default library lacks raises in the
    wrapper, before the operator is called (nothing is built or loaded
    for it)."""
    tile = (4, 2, 2, 2, 1, 1, 1)
    plan = st.plan_for(32, tile)
    assert st._variant(plan) not in _library_variants(st.library()[2])
    monkeypatch.setattr(_build, "load_ops",
                        lambda *a: pytest.fail("the operator was reached"))
    x = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 3, 3, 32, dtype=torch.bfloat16)
    b = torch.zeros(32)
    with pytest.raises(ValueError, match="holds no kernel"):
        st.fused_basic_block_stencil(x, w, b, w, b, tile=tile)


def _walk(plan, x, w1, b1, w2, b2):
    """The plan's schedule replayed in torch on the CPU, as the kernel runs
    it: per cluster, every block keeps its own x ring and mid ring (the
    plan's slots); per step, each block fetches its x rows, then
    (after every block's fetch, so a slot clash would show) each block
    computes its channel slice of conv1 over the warp grid's rows and K
    chunks and stores it into every block's mid ring (zero outside the
    image), then each block computes its slice of conv2 from its own ring
    (the residual from x).
    Returns y (fp32; mid rounded to bf16)."""
    n, h, w, c = x.shape
    xf, nan = x.float(), float("nan")
    wm1 = w1.float().reshape(c, 9, c)
    wm2 = w2.float().reshape(c, 9, c)
    y = torch.full((n, h, w, c), nan)
    tiles_x = -(-w // plan.tw)
    xs, ms = plan.x_slots, plan.mid_slots
    for cl in range(tiles_x * -(-n // plan.nb)):
        tx0, n0 = (cl % tiles_x) * plan.tw, (cl // tiles_x) * plan.nb
        xr = [[torch.full((plan.nb, plan.xp, c), nan) for _ in range(xs)]
              for _ in range(plan.k)]
        # the kernel zeroes the mid ring before the sweep (row -1 and the
        # halo columns a tile spanning the image never writes)
        mr = [[torch.zeros(plan.nb, plan.mp, c) for _ in range(ms)]
              for _ in range(plan.k)]

        def fetch(rank, r):
            slot = torch.zeros(plan.nb, plan.xp, c)
            for nb in range(plan.nb):
                for xc in range(plan.xp):
                    gx = tx0 - 2 + xc
                    if n0 + nb < n and 0 <= r < h and 0 <= gx < w:
                        slot[nb, xc] = xf[n0 + nb, r, gx]
            xr[rank][r % xs] = slot

        def gemm(rank, conv, row0, ring, w=w):
            """{(GEMM row, channel): sum} of the block's channel slice over
            the warp grid; step row rr reads tap row dy from the ring slot
            of row row0 - 1 + rr + dy."""
            wmat, slots = (wm1, xs) if conv == 1 else (wm2, ms)
            out = {}
            for cv, mi, wn_i in _warps(plan):
                if cv != conv:
                    continue
                cos = _warp_channels(plan, rank, wn_i)
                wsl = wmat[cos.start:cos.stop]               # [co, tap, ch]
                for r in _warp_rows(plan, conv, mi, w):
                    rr, nb, col = _row_position(plan, conv, r, w)
                    a = torch.stack([ring[(row0 - 1 + rr + tap // 3) % slots][
                        nb, col + tap % 3] for tap in range(9)])
                    sums = (wsl * a).sum(dim=(1, 2))
                    for co, v in zip(cos, sums):
                        out[r, co] = v
            return out

        for rank in range(plan.k):
            for r in range(-1, min(plan.ahead * plan.rh, h) + 1):
                fetch(rank, r)
        for step in step_schedule(h, plan.rh, plan.ahead):
            for rank in range(plan.k):
                for r in step["fetch_x"]:
                    fetch(rank, r)
            m0 = step["mid_writes"][0]
            for rank in range(plan.k):
                for (r, co), v in gemm(rank, 1, m0, xr[rank]).items():
                    rr, nb, mc = _row_position(plan, 1, r, w)
                    inside = m0 + rr < h and 0 <= tx0 - 1 + mc < w
                    v = torch.relu(v + b1[co]) if inside else torch.zeros(())
                    v = v.to(torch.bfloat16).float()
                    for peer in range(plan.k):
                        mr[peer][(m0 + rr) % ms][nb, mc, co] = v
            y0 = plan.rh * (step["s"] - 2) - 1
            for rank in range(plan.k):
                for (r, co), v in gemm(rank, 2, y0, mr[rank]).items():
                    rr, nb, ox = _row_position(plan, 2, r)
                    yr = y0 + rr
                    if 0 <= yr < h and n0 + nb < n and tx0 + ox < w:
                        y[n0 + nb, yr, tx0 + ox, co] = torch.relu(
                            v + b2[co] + xf[n0 + nb, yr, tx0 + ox, co])
    return y


@pytest.mark.parametrize("c,tile", [(32, (4, 2, 2, 2, 1, 1, 1)),
                                    (32, (6, 1, 2, 1, 2, 2, 2)),
                                    (32, (4, 2, 1, 2, 1, 1, 2, 16)),
                                    (32, (3, 3, 1, 4, 1, 1, 1)),
                                    (32, (8, 2, 2, 2, 1, 1, 1)),
                                    (16, None)])
def test_schedule_walk_equals_plain_version(c, tile):
    """The test-side walk of the plan's schedule (per block, per step, per
    channel slice) equals fused_basic_block_reference at a ragged shape:
    a width no column tile divides (or one tile spanning it, TW >= 7), a
    height no row group divides, and a last image group of one."""
    plan = st.plan_for(c, tile)
    rng = np.random.RandomState(c + plan.tw)
    n, h, w = 3, 5, 7
    std = (1.0 / (9 * c)) ** 0.5
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32) * 0.5)
    x = x.bfloat16()
    w1 = torch.from_numpy(rng.randn(c, 3, 3, c).astype(np.float32) * std)
    w2 = torch.from_numpy(rng.randn(c, 3, 3, c).astype(np.float32) * std)
    w1, w2 = w1.bfloat16(), w2.bfloat16()
    b1 = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
    b2 = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)
    got = _walk(plan, x, w1, b1, w2, b2)
    assert torch.isfinite(got).all()
    ref = st.fused_basic_block_reference(x, w1, b1, w2, b2).float()
    torch.testing.assert_close(got, ref, atol=5e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C,H,W,B", [(48, 64, 64, 4), (96, 32, 32, 4),
                                     (192, 16, 16, 4), (384, 8, 8, 4),
                                     (32, 10, 37, 3), (64, 10, 10, 3),
                                     (48, 12, 37, 5)])
def test_kernel_matches_plain_version(C, H, W, B):
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
    before = st.fused_basic_block_stencil.launches
    y = st.fused_basic_block_stencil(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert st.fused_basic_block_stencil.launches == before + 1
    ref = st.fused_basic_block_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(y.float(), ref.float(), atol=5e-2, rtol=2e-2)


@pytest.mark.cuda
def test_tile_override_and_probe_run_through_the_operator():
    """On the card, ``probe_wide_tile()`` and a ``tile=(32, 1)`` launch go
    through ``egonet::fused_basic_block_stencil`` with the tile's plan:
    each equals the plain version and adds one to the op's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    st._PROBE_CACHE.clear()
    before = st.fused_basic_block_stencil.launches
    assert st.probe_wide_tile() is True
    assert st.fused_basic_block_stencil.launches == before + 1
    x, folded = st.probe_args(device="cuda")
    y = st.fused_basic_block_stencil(x, *folded, tile=(32, 1))
    torch.cuda.synchronize()
    assert st.fused_basic_block_stencil.launches == before + 2
    ref = st.fused_basic_block_reference(x, *folded)
    torch.testing.assert_close(y.float(), ref.float(), atol=5e-2, rtol=2e-2)
