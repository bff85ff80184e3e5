#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (egonet_tpu_torch) runs on an
NVIDIA GPU:  python3 chip_smoke.py   (one card; builds the kernels first).

1. Prints the card (name, power limit), torch and CUDA versions, and builds
   every CUDA kernel of the port from csrc/ with nvcc (one nvcc per source,
   all started together); prints each kernel variant's registers and
   spills, and SASS opcode counts of both libraries with an excerpt of the
   tiled kernel's K loop (cuobjdump -sass).
2. Kernel phase, tiled fused BasicBlock: at each W48 shape (C, H) in
   {(48, 64), (96, 32), (192, 16), (384, 8)}, batch 32, random folded
   weights and BN stats (and, checked only, at four odd shapes), the
   kernel is held against its plain PyTorch version on the card (bf16,
   atol 5e-2 / rtol 2e-2: the two differ only in summation order over
   9C terms) and timed with CUDA events beside the
   plain version, two cuDNN convs doing the same block (``library_ms``,
   timed only, never called by the port), the card's bound and every
   other tile of ALT_TILES (each also checked; their kernel variants are
   built into a library of their own, which the port does not load).
3. Kernel phase, row-streaming (stencil) fused BasicBlock: the same checks
   at the same four shapes and at three odd ones (two from step 2 and one
   whose width no column tile divides), with its launch plan printed
   (cluster size K, tile TW x NB, weights resident or streamed, warps,
   shared memory, clusters the card holds at once), timed beside its plain
   version, the cuDNN convs, its bound and the tiled kernel, and every
   other plan of STENCIL_SWEEP checked and timed beside the chosen one
   (their variants built into a library of their own); the SASS of the
   stencil library is searched for weight copies inside each variant's
   row loop; then ``probe_wide_tile()``, whose result is printed.
4. Slice phase: ``EgoNet(demo_config(), device="cuda")`` — full W48, bf16,
   seeded random weights, LS stats anchored at a placed cuboid — runs 4
   synthetic 375x1242 frames with 6 boxes each through dispatch_annot_dict
   -> finalize -> post_process, writing KITTI txts to a temp dir.  The
   kernel launch counts are reset just before and read just after: the
   tiled kernel's must grow by exactly 104 per HRNet forward.  Outputs
   must be finite, every instance must get a txt line, and the kernel
   path must agree with the same model's unfused eval path (median |d ry|
   < 0.5 deg).
5. Stencil slice phase: the same model with ``prepare_inference(stencil=
   "1")``: exactly 104 stencil launches and 0 tiled ones per forward,
   median |d ry| < 0.5 deg against both the tiled and the unfused paths,
   steady-state crops/s beside the tiled path's.
6. CLI phase, stencil on (EGONET_PALLAS_STENCIL=1): writes a small KITTI
   root (4 frames of 375x1242 as PNGs from the zlib writer below, whose
   rows cycle through all five PNG filters; labels, calibrations, detector
   txts, LS.npy), checks the port's PNG reader against the written pixels,
   and runs ``egonet_tpu_torch.tools.inference.main(cfgs=...)`` on the
   GT-box and submission paths: every instance gets a 17-field line whose
   fields other than alpha and rot_y equal the input line's bytes, with
   finite angles.
7. Prints one JSON line per kernel shape and phase, both kernels' earlier
   times per forward (past figures from PERF.md, labelled so), the
   {"kernels": [...]} line (every number in it measured or, for
   ``bound_ms``, reckoned in this run), the card line, and last
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without CUDA or outside a checkout.
Any failure raises (non-zero exit).
"""

import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

W48_SHAPES = ((48, 64), (96, 32), (192, 16), (384, 8))
# checked only (not timed): a W32 width, whose C is no multiple of 48 (the
# kernel's two- and four-N-tile variants), and a map no tile divides
EXTRA_SHAPES = ((32, 64, 4), (64, 10, 3))
# the tiled kernel's other odd shapes (C, H, W, B): a map that no tile
# divides in either direction, and one image at C=384
TILED_EXTRA = ((96, 20, 36, 3), (384, 8, 8, 1))
# other (TH, TW, NB, KS) tiles of the tiled kernel, checked and timed at
# each W48 shape beside the chosen one (fb.tile_for)
ALT_TILES = {48: ((8, 16, 1, 48), (8, 16, 1, 144), (16, 16, 1, 144),
                  (32, 16, 1, 144), (16, 32, 1, 48)),
             96: ((8, 16, 1, 48), (8, 16, 1, 96), (16, 16, 1, 48),
                  (16, 16, 1, 144), (8, 32, 1, 96)),
             192: ((8, 8, 1, 48), (8, 8, 1, 144), (4, 16, 1, 96),
                   (8, 16, 1, 48), (4, 8, 2, 96)),
             384: ((2, 8, 1, 48), (4, 8, 1, 48), (8, 4, 1, 48),
                   (2, 4, 1, 48), (2, 4, 2, 48))}
# both kernels' times per W48 forward at 32 crops before their redesigns
# (the tiled one loading WMMA fragments from L2; the stencil streaming both
# weight matrices through shared memory every row step): past figures,
# printed apart from the kernels line
EARLIER = {"fused_basic_block_ms_per_forward": 24.07,
           "fused_basic_block_stencil_ms_per_forward": 97.40,
           "source": "PERF.md, section 6: the earlier designs on an H100 "
                     "80GB HBM3 at 700.00 W"}
# the stencil's odd shapes (C, H, W, B): those above and a width that no
# column tile divides
STENCIL_EXTRA = ((32, 64, 64, 4), (64, 10, 10, 3), (48, 12, 37, 5))
# other stencil plans (TW, RH, NB, K, WM1, WM2, WN[, KS]: column tile, rows
# per step, images and blocks per cluster, warps along M of conv1 and of
# conv2, warps along N[, streamed slab depth]), checked and timed at each
# W48 shape beside the chosen one (st.tile_for): weights streamed without a
# cluster, other clusters, tiles, rows per step and warp grids
STENCIL_SWEEP = {
    48: ((8, 1, 1, 1, 1, 1, 3, 48), (8, 1, 1, 1, 1, 1, 3),
         (8, 4, 1, 1, 1, 1, 3), (8, 4, 1, 1, 2, 2, 1), (16, 4, 1, 1, 1, 1, 3)),
    96: ((8, 1, 1, 1, 1, 1, 3, 48), (8, 1, 1, 4, 1, 1, 3),
         (8, 1, 1, 2, 1, 1, 3), (16, 3, 1, 2, 1, 1, 3),
         (16, 3, 1, 2, 2, 2, 1)),
    192: ((8, 1, 1, 8, 1, 1, 3, 96), (8, 1, 1, 8, 1, 1, 1),
          (16, 1, 1, 8, 1, 1, 3), (16, 1, 1, 8, 1, 1, 1),
          (8, 2, 1, 8, 2, 1, 1)),
    384: ((8, 1, 1, 8, 1, 1, 3, 96), (8, 2, 1, 8, 1, 1, 3, 96),
          (8, 4, 1, 8, 1, 1, 3, 96), (8, 3, 1, 8, 2, 2, 1, 96))}
# fused blocks per HRNet-W48 forward at each width (104 in all)
PER_FORWARD = {48: 32, 96: 32, 192: 28, 384: 12}
BATCH = 32
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
N_FRAMES, N_BOXES = 4, 6


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _ptxas_summary(log):
    """One "<template args>: N registers, S bytes spilled" item per kernel
    variant in nvcc's -Xptxas -v output."""
    items, name, spill = [], "?", "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = "<" + ",".join(re.findall(r"Li(\d+)E", m.group(1))) + ">"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            items.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                         "spilled")
    return items


def _time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _block_inputs(torch, fb, g, c, h, batch, w=None):
    """x (post-ReLU-like, NHWC bf16, h x w, w defaulting to h) and folded
    weights of a random block with random BN statistics."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale
    folded = []
    for _ in range(2):
        conv = rnd(c, c, 3, 3, scale=(1.0 / (9 * c)) ** 0.5)
        bn = torch.nn.BatchNorm2d(c).cuda().eval()
        with torch.no_grad():
            bn.weight.copy_(rnd(c).abs() * 0.5 + 0.5)
            bn.bias.copy_(rnd(c, scale=0.1))
            bn.running_mean.copy_(rnd(c, scale=0.1))
            bn.running_var.copy_(rnd(c).abs() * 0.5 + 0.75)
        folded += fb.fold_conv_bn(conv, bn)
    x = torch.relu(rnd(batch, h, w or h, c)).to(torch.bfloat16)
    return x, folded


def _library_block(torch, x, w1, b1, w2, b2):
    """Two cuDNN bf16 convs doing the folded block (timed only)."""
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)                      # channels_last NCHW
    wl1, wl2 = w1.permute(0, 3, 1, 2), w2.permute(0, 3, 1, 2)
    bl1, bl2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

    def library():
        m = torch.relu(F.conv2d(xc, wl1, bl1, padding=1))
        return torch.relu(F.conv2d(m, wl2, bl2, padding=1) + xc)
    return library


def _bound(c, h, w):
    """(operations ms, bytes ms) of one block launch at batch BATCH."""
    ops = 4.0 * BATCH * h * w * 9 * c * c
    nbytes = 4.0 * BATCH * h * w * c + 36.0 * c * c
    return ops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3


def _tile_name(tile):
    return "x".join(map(str, tile))


def sweep_plans(fb):
    """{C: [(tile, plan)]} of the ALT_TILES that fit."""
    return {c: [(t, fb.plan_for(c, t)) for t in ALT_TILES[c]
                if fb.tile_fits(c, t)] for c, _ in W48_SHAPES}


def kernel_phase(torch, fb, sweep, sweep_lib):
    """Check the tiled fused block at the odd shapes; check and time it at
    every W48 shape, with every plan of ``sweep`` (launched from
    ``sweep_lib``) checked and timed beside the chosen one."""
    import dataclasses
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    odd = [(c, h, h, b) for c, h, b in EXTRA_SHAPES] + list(TILED_EXTRA)
    for c, h, w, batch in odd:
        x, folded = _block_inputs(torch, fb, g, c, h, batch, w)
        y = fb.fused_basic_block(x, *folded)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            y.float(), fb.fused_basic_block_reference(x, *folded).float(),
            atol=5e-2, rtol=2e-2)
    for c, h in W48_SHAPES:
        x, (w1, b1, w2, b2) = _block_inputs(torch, fb, g, c, h, BATCH)

        def kernel(launcher=None):
            if launcher is None:
                return fb.fused_basic_block(x, w1, b1, w2, b2)
            return fb._launch(x, w1, b1, w2, b2, *launcher)

        def plain():
            return fb.fused_basic_block_reference(x, w1, b1, w2, b2)

        library = _library_block(torch, x, w1, b1, w2, b2)
        y = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = (y.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(y.float(), ref.float(), atol=5e-2,
                                   rtol=2e-2)
        assert torch.isfinite(y.float()).all()
        lib_y = library().permute(0, 2, 3, 1)
        torch.testing.assert_close(lib_y.float(), ref.float(), atol=0.25,
                                   rtol=5e-2)
        alt = [(t, fb._launcher(plan, sweep_lib)) for t, plan in sweep[c]]
        for _, launcher in alt:
            y = kernel(launcher)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), ref.float(), atol=5e-2,
                                       rtol=2e-2)
        ops_ms, bytes_ms = _bound(c, h, h)
        row = {"shape": {"C": c, "H": h, "W": h, "B": BATCH},
               "tile": list(fb.tile_for(c)),
               "plan": dataclasses.asdict(fb.plan_for(c)),
               "max_abs_err": err,
               "ms": _time_ms(torch, kernel),
               "plain_ms": _time_ms(torch, plain, iters=5),
               "library_ms": _time_ms(torch, library),
               "alt_tiles_ms": {_tile_name(t): _time_ms(
                   torch, lambda a=a: kernel(a), iters=10) for t, a in alt},
               "ops_ms": ops_ms, "bytes_ms": bytes_ms}
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        print(json.dumps({"fused_basic_block": row}), flush=True)
        rows.append(row)
    return rows


def _sass_functions(cuobjdump, path):
    """{kernel variant: [(address, instruction)]} of a built library
    (cuobjdump -sass)."""
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = funcs.setdefault(ln.split("Function :")[1].strip(), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", ln)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _opcode(text):
    tokens = text.split()
    if tokens and tokens[0].startswith("@"):
        tokens = tokens[1:]
    return tokens[0] if tokens else ""


def _row_loop(insts):
    """What one stencil variant's row loops hold (the outermost backward
    branches around HMMAs: one per warp role, conv1's and conv2's): weight
    copies (LDGSTS with no zero-fill predicate operand: cp_async16_all),
    activation copies (LDGSTS ending in the predicate that zero-fills
    positions outside the image: cp_async16), LDG (the residual), HMMA."""
    hmma = [a for a, t in insts if _opcode(t).startswith("HMMA")]
    loops = []
    for a, t in insts:
        if _opcode(t).startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", t.split("BRA", 1)[1])
            if m and int(m.group(1), 16) < a and any(
                    int(m.group(1), 16) <= h <= a for h in hmma):
                loops.append((int(m.group(1), 16), a))
    outer = sorted({(lo, hi) for lo, hi in loops
                    if not any(l2 <= lo and hi <= h2 and (l2, h2) != (lo, hi)
                               for l2, h2 in loops)})
    if not outer:
        return None
    inside = [t for a, t in insts if any(lo <= a <= hi for lo, hi in outer)]
    copies = [t for t in inside if _opcode(t).startswith("LDGSTS")]
    zfill = [t for t in copies if re.search(r",\s*!?P\d+$", t)]
    return {"spans": [[hex(lo), hex(hi)] for lo, hi in outer],
            "weight_copies": len(copies) - len(zfill),
            "x_copies": len(zfill),
            "LDG": sum(_opcode(t).split(".")[0] == "LDG" for t in inside),
            "HMMA": sum(_opcode(t).startswith("HMMA") for t in inside),
            "HMMA_outside": len(hmma) - sum(
                _opcode(t).startswith("HMMA") for t in inside)}


def sass_report(_build, fb, st):
    """Per library, counts of the SASS opcodes that show how the fused
    kernels feed their tensor cores (cuobjdump -sass of the built library):
    LDSM (ldmatrix), HMMA (mma), LDS (other shared loads), LD / LDG
    (generic and global loads), LDGSTS (cp.async), BAR; 20 instructions of
    the tiled kernel's K loop, from its first HMMA, in the variant of the
    C=96 plan; and, per stencil variant, what its row loop holds.  Fails if
    the row loop of a resident-weight variant copies weights."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    plan = fb.plan_for(96)
    variant = f"ILi{plan.mt}ELi{plan.nt}ELi{plan.ks}E"
    out, excerpt, loops = {}, [], {}
    for name in ("fused_basic_block", "fused_basic_block_stencil"):
        count = {}
        for fn, insts in _sass_functions(cuobjdump,
                                         _build._paths(name)[1]).items():
            for _, text in insts:
                base = _opcode(text).split(".")[0]
                if base in ("LDSM", "HMMA", "LDS", "LD", "LDG", "LDGSTS",
                            "BAR"):
                    count[base] = count.get(base, 0) + 1
                if (name == "fused_basic_block" and variant in fn
                        and (excerpt or base == "HMMA")
                        and len(excerpt) < 20):
                    excerpt.append(text)
            if name == "fused_basic_block_stencil" and "stencil" in fn:
                args = tuple(int(v) for v in re.findall(r"Li(\d+)E", fn))
                loops[args] = _row_loop(insts)
        out[name] = count
    report = {"counts": out, "tiled_k_loop_excerpt": {
        "variant": f"<{plan.mt},{plan.nt},{plan.ks}>", "sass": excerpt},
        "stencil_row_loops": {f"<{','.join(map(str, k))}>": v
                              for k, v in sorted(loops.items())}}
    for c, _ in W48_SHAPES:
        p = st.plan_for(c)
        loop = loops.get(st._variant(p))
        assert loop is not None, (c, sorted(loops))
        assert loop["HMMA_outside"] == 0, (c, loop)
        if p.resident:
            assert loop["weight_copies"] == 0 and loop["x_copies"] > 0, \
                (c, loop)
    return report


def stencil_sweep(st):
    """{C: [plan]} of the STENCIL_SWEEP plans that fit, other than the
    chosen one."""
    return {c: [st.plan_for(c, t) for t in STENCIL_SWEEP[c]
                if st.tile_fits(c, t) and st.plan_for(c, t) != st.plan_for(c)]
            for c, _ in W48_SHAPES}


def _plan_name(plan):
    return "x".join(map(str, plan.tile))


def _plan_summary(st, plan, lib):
    return {"tile": list(plan.tile), "K": plan.k, "TW": plan.tw,
            "NB": plan.nb, "weights": "resident" if plan.resident
            else f"streamed, slabs of {plan.ks} x {plan.stages}",
            "warps": plan.warps, "smem": plan.smem,
            "max_active_clusters": st.max_clusters(plan, lib)}


def stencil_kernel_phase(torch, fb, st, sweep, sweep_lib):
    """Check the stencil at the odd shapes; check and time it at every W48
    shape beside the tiled kernel, the plain version and cuDNN, with every
    plan of ``sweep`` (launched from ``sweep_lib``) checked and timed
    beside the chosen one; run the probe."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(1)
    for c, h, w, batch in STENCIL_EXTRA:
        x, folded = _block_inputs(torch, fb, g, c, h, batch, w)
        y = st.fused_basic_block_stencil(x, *folded)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            y.float(), st.fused_basic_block_reference(x, *folded).float(),
            atol=5e-2, rtol=2e-2)
    for c, h in W48_SHAPES:
        x, (w1, b1, w2, b2) = _block_inputs(torch, fb, g, c, h, BATCH)

        def kernel(launcher=None):
            if launcher is None:
                return st.fused_basic_block_stencil(x, w1, b1, w2, b2)
            return st._launch(x, w1, b1, w2, b2, *launcher)

        def plain():
            return st.fused_basic_block_reference(x, w1, b1, w2, b2)

        def tiled():
            return fb.fused_basic_block(x, w1, b1, w2, b2)

        library = _library_block(torch, x, w1, b1, w2, b2)
        ref = plain()
        alt = [(p, st._launcher(p, sweep_lib)) for p in sweep[c]]
        for launcher in [None] + [a for _, a in alt]:
            y = kernel(launcher)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), ref.float(), atol=5e-2,
                                       rtol=2e-2)
        y = kernel()
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        assert torch.isfinite(y.float()).all()
        ops_ms, bytes_ms = _bound(c, h, h)
        row = {"shape": {"C": c, "H": h, "W": h, "B": BATCH},
               "plan": _plan_summary(st, st.plan_for(c), st.library()),
               "max_abs_err": err,
               "ms": _time_ms(torch, kernel),
               "plain_ms": _time_ms(torch, plain, iters=5),
               "library_ms": _time_ms(torch, library),
               "tiled_ms": _time_ms(torch, tiled),
               "alt_plans_ms": {_plan_name(p): _time_ms(
                   torch, lambda a=a: kernel(a), iters=10) for p, a in alt},
               "alt_plans": {_plan_name(p): _plan_summary(st, p, sweep_lib)
                             for p, _ in alt},
               "ops_ms": ops_ms, "bytes_ms": bytes_ms}
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        print(json.dumps({"fused_basic_block_stencil": row}), flush=True)
        rows.append(row)
    probe = st.probe_wide_tile()
    print(json.dumps({"probe_wide_tile": probe}), flush=True)
    return rows


def _frames(np):
    """Synthetic KITTI-sized frames, boxes, intrinsics and detector lines."""
    rng = np.random.RandomState(0)
    K = np.array([[721.5, 0.0, 609.6], [0.0, 721.5, 172.9], [0.0, 0.0, 1.0]])
    annot = {"path": [], "boxes": [], "images": [], "K": [],
             "raw_txt_format": []}
    for i in range(N_FRAMES):
        x = rng.uniform(0, 1000, N_BOXES)
        y = rng.uniform(120, 220, N_BOXES)
        boxes = np.stack([x, y, x + rng.uniform(40, 240, N_BOXES),
                          y + rng.uniform(30, 140, N_BOXES)], axis=1)
        annot["path"].append(f"frames/{i:06d}.png")
        annot["boxes"].append(boxes)
        annot["images"].append(rng.randint(0, 256, (375, 1242, 3),
                                           dtype=np.uint8))
        annot["K"].append(K)
        annot["raw_txt_format"].append([
            {"class": "Car", "truncation": 0.0, "occlusion": 0.0,
             "alpha": 0.0, "bbox": list(b), "dimensions": [3.9, 1.5, 1.6],
             "locations": [float(rng.uniform(-8, 8)), 1.6,
                           float(rng.uniform(8, 40))],
             "rot_y": 0.0, "score": 0.9} for b in boxes])
    return annot


def _anchored_ls_stats(np, cb):
    """LS stats that decode the random network's outputs into a cuboid
    near a placed one (what a trained LS.npy does); a random cuboid makes
    the rigid fit ill-conditioned."""
    box = cb.construct_box_3d(3.9, 1.5, 1.7)
    rel = box[:, 1:] - box[:, :1]
    return {"mean_in": np.tile([600.0, 180.0], 33)[None].astype(np.float32),
            "std_in": np.full((1, 66), 150.0, np.float32),
            "mean_out": (cb.rot_y_matrix(0.9) @ rel).T.reshape(1, -1)
            .astype(np.float32),
            "std_out": np.full((1, 96), 0.05, np.float32)}


def _drive(torch, model, annot, fb, st, out_dir):
    """One batch through dispatch -> finalize -> post_process, with both
    kernels' launch counts set to 0 just before and read just after.
    Checks that every instance got a 17-field txt line.  Returns (records,
    {"tiled": n, "stencil": n}, seconds)."""
    fb.fused_basic_block.launches = 0
    st.fused_basic_block_stencil.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = model.finalize(model.dispatch_annot_dict(annot))
    model.post_process(records, save_dict={"flag": True, "save_dir": out_dir})
    seconds = time.perf_counter() - t0
    launches = {"tiled": fb.fused_basic_block.launches,
                "stencil": st.fused_basic_block_stencil.launches}
    n_lines = 0
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            lines = f.read().split("\n")
        assert all(len(ln.split(" ")) == 17 for ln in lines), lines
        n_lines += len(lines)
    assert n_lines == sum(len(b) for b in annot["boxes"]), n_lines
    return records, launches, seconds


def _ry(np, records):
    return np.concatenate([records[p]["euler_angles"][:, 1] for p in records])


def _d_deg(np, a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.degrees(np.minimum(d, 2 * np.pi - d))


def _steady_s(torch, model, annot, iters=10):
    """Mean seconds per batch of the whole slice after one warm batch."""
    model.forward_annot_dict(annot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.forward_annot_dict(annot)
    return (time.perf_counter() - t0) / iters


def slice_phase(torch, np, fb, st):
    """The W48 slice through the tiled kernel.  Returns (result, model,
    annot, ry of the tiled path, ry of the unfused path)."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.data import cuboid as cb
    from egonet_tpu_torch.models.egonet import EgoNet

    t0 = time.perf_counter()
    model = EgoNet(demo_config(), device="cuda")
    assert model.dtype == torch.bfloat16
    model.load_state(ls_stats=_anchored_ls_stats(np, cb))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    annot = _frames(np)
    n_inst = N_FRAMES * N_BOXES

    with tempfile.TemporaryDirectory() as out_dir:
        records, launches, first_s = _drive(torch, model, annot, fb, st,
                                            out_dir)
    assert launches == {"tiled": 104, "stencil": 0}, launches

    ry = _ry(np, records)
    for p, rec in records.items():
        for key in ("kpts_2d_pred", "kpts_3d_pred", "euler_angles",
                    "translation", "alphas"):
            assert np.isfinite(np.asarray(rec[key], np.float64)).all(), key
        assert np.asarray(rec["kpts_3d_pred"]).shape[1:] == (32, 3)

    # the kernel path against the same model's unfused eval path
    model.hrnet.fuse_blocks = False
    before = fb.fused_basic_block.launches
    ry_u = _ry(np, model.forward_annot_dict(annot))
    assert fb.fused_basic_block.launches == before
    model.hrnet.fuse_blocks = True
    d_ry = _d_deg(np, ry, ry_u)
    assert np.median(d_ry) < 0.5, d_ry

    steady_s = _steady_s(torch, model, annot)
    result = {"instances": n_inst, "bucket": 32,
              "launches": launches["tiled"],
              "launches_per_forward": launches["tiled"], "setup_s": setup_s,
              "first_batch_s": first_s, "batch_s": steady_s,
              "crops_per_s": n_inst / steady_s,
              "median_d_ry_fused_vs_unfused_deg": float(np.median(d_ry)),
              "max_d_ry_fused_vs_unfused_deg": float(d_ry.max()),
              "transport": dict(model.transport_stats)}
    return result, model, annot, ry, ry_u


def stencil_slice_phase(torch, np, fb, st, model, annot, ry_tiled,
                        ry_unfused):
    """The same model and batch with the stencil kernel selected."""
    model.hrnet.prepare_inference(stencil="1")
    n_inst = N_FRAMES * N_BOXES
    with tempfile.TemporaryDirectory() as out_dir:
        records, launches, first_s = _drive(torch, model, annot, fb, st,
                                            out_dir)
    assert launches == {"tiled": 0, "stencil": 104}, launches
    ry = _ry(np, records)
    assert np.isfinite(ry).all()
    d_tiled, d_unfused = _d_deg(np, ry, ry_tiled), _d_deg(np, ry, ry_unfused)
    assert np.median(d_tiled) < 0.5, d_tiled
    assert np.median(d_unfused) < 0.5, d_unfused
    steady_s = _steady_s(torch, model, annot)
    model.hrnet.prepare_inference(stencil="0")
    return {"instances": n_inst, "bucket": 32,
            "launches": launches["stencil"],
            "launches_per_forward": launches["stencil"],
            "tiled_launches": launches["tiled"],
            "first_batch_s": first_s, "batch_s": steady_s,
            "crops_per_s": n_inst / steady_s,
            "median_d_ry_vs_tiled_deg": float(np.median(d_tiled)),
            "max_d_ry_vs_tiled_deg": float(d_tiled.max()),
            "median_d_ry_vs_unfused_deg": float(np.median(d_unfused)),
            "max_d_ry_vs_unfused_deg": float(d_unfused.max())}


# ---------------------------------------------------------------------------
# the CLI phase: a small KITTI directory written here
# ---------------------------------------------------------------------------

def _png_bytes(np, img):
    """A PNG of an RGB uint8 image whose rows cycle through the five row
    filters (None, Sub, Up, Average, Paeth)."""
    h, w, _ = img.shape
    rows = img.reshape(h, -1).astype(np.int32)
    data, prev = bytearray(), np.zeros_like(rows[0])
    for y in range(h):
        kind, r = y % 5, rows[y]
        a = np.concatenate([np.zeros(3, np.int32), r[:-3]])
        c = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) >> 1, paeth)[kind]
        data.append(kind)
        data += ((r - pred) & 255).astype(np.uint8).tobytes()
        prev = r

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(data), 6))
            + chunk(b"IEND", b""))


def _label_line(car, score=None):
    """A KITTI label line in the writer's own number formats."""
    (x1, y1, x2, y2), (l, h, w), (x, y, z), ry, alpha = car
    line = (f"Car 0.0 0.0 {alpha:.6f} {x1:.6f} {y1:.6f} {x2:.6f} {y2:.6f} "
            f"{h:.6f} {w:.6f} {l:.6f} {x:.6f} {y:.6f} {z:.6f} {ry:.6f}")
    return line if score is None else line + f" {score:.8f}"


def _write_kitti(np, cb, root, pred_dir):
    """4 frames of 375x1242 with N_BOXES cars each: PNGs, labels, calibs,
    the valid split list and detector txts.  Returns {name: pixels}."""
    rng = np.random.RandomState(3)
    K = np.array([[721.5, 0.0, 609.6], [0.0, 721.5, 172.9], [0.0, 0.0, 1.0]])
    shift = np.array([0.06, 0.0, 0.0])
    P = np.hstack([K, (K @ shift)[:, None]])
    train = os.path.join(root, "training")
    for sub in ("image_2", "label_2", "calib", "ImageSets"):
        os.makedirs(os.path.join(train, sub))
    os.makedirs(pred_dir)
    frames = {}
    for i in range(N_FRAMES):
        name = f"{i:06d}"
        cars = []
        for _ in range(N_BOXES):
            dims = (rng.uniform(3.5, 4.5), rng.uniform(1.4, 1.7),
                    rng.uniform(1.5, 1.8))
            loc = (rng.uniform(-8, 8), 1.65, rng.uniform(10, 40))
            ry = rng.uniform(-np.pi, np.pi)
            corners = cb.place_cuboid(
                cb.construct_box_3d(*dims, interpolate=False),
                [*loc, 0.0, ry, 0.0], shift)
            uv = cb.project_3d_to_2d(corners, K)[:2]
            box = (max(uv[0].min(), 0.0), max(uv[1].min(), 0.0),
                   min(uv[0].max(), 1241.0), min(uv[1].max(), 374.0))
            cars.append((box, dims, loc, ry, rng.uniform(-np.pi, np.pi)))
        img = rng.randint(0, 256, (375, 1242, 3), dtype=np.uint8)
        frames[name] = img
        with open(os.path.join(train, "image_2", name + ".png"), "wb") as f:
            f.write(_png_bytes(np, img))
        with open(os.path.join(train, "label_2", name + ".txt"), "w") as f:
            f.write("\n".join(_label_line(c) for c in cars) + "\n")
        with open(os.path.join(train, "calib", name + ".txt"), "w") as f:
            f.write("P2: " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                    + "\n")
        with open(os.path.join(pred_dir, name + ".txt"), "w") as f:
            f.write("\n".join(_label_line(c, 0.95 - 0.1 * j)
                              for j, c in enumerate(cars)) + "\n")
    with open(os.path.join(train, "ImageSets", "val.txt"), "w") as f:
        f.write("\n".join(frames) + "\n")
    return frames


def _check_txts(np, out_dir, in_dir, names, has_score):
    """Every input line has an output line whose fields other than alpha
    (3) and rot_y (14) are the input's bytes; angles are finite."""
    n = 0
    for name in names:
        with open(os.path.join(in_dir, name + ".txt")) as f:
            want = [ln.split(" ") for ln in f.read().split("\n") if ln]
        with open(os.path.join(out_dir, name + ".txt")) as f:
            got = [ln.split(" ") for ln in f.read().split("\n")]
        assert len(got) == len(want), (name, len(got), len(want))
        for g, w in zip(got, want):
            assert len(g) == 17 and g[16] == "", g
            assert np.isfinite([float(g[3]), float(g[14])]).all(), g
            keep = [i for i in range(len(w)) if i not in (3, 14)]
            assert [g[i] for i in keep] == [w[i] for i in keep], (g, w)
            if not has_score:
                assert g[15] == "1.00000000", g
            n += 1
    return n


def cli_phase(np, fb, st):
    """The port's inference CLI over a KITTI directory, stencil on."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.data import cuboid as cb
    from egonet_tpu_torch.data import png
    from egonet_tpu_torch.tools import inference

    with tempfile.TemporaryDirectory() as tmp:
        root, pred_dir = os.path.join(tmp, "KITTI"), os.path.join(tmp, "pred")
        frames = _write_kitti(np, cb, root, pred_dir)
        decode_s = []
        for name, img in frames.items():
            t0 = time.perf_counter()
            got = png.decode(os.path.join(root, "training", "image_2",
                                          name + ".png"))
            decode_s.append(time.perf_counter() - t0)
            assert np.array_equal(got, img), name
        ckpt, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "out")
        os.makedirs(ckpt)
        np.save(os.path.join(ckpt, "LS.npy"), _anchored_ls_stats(np, cb))
        cfgs = demo_config()
        cfgs["dataset"]["root"] = root
        cfgs["dirs"] = {"output": out, "ckpt": ckpt,
                        "load_prediction_file": pred_dir}
        cfgs["pre_trained"] = True            # loads LS.npy (no HC / L)

        old = os.environ.get("EGONET_PALLAS_STENCIL")
        os.environ["EGONET_PALLAS_STENCIL"] = "1"
        try:
            fb.fused_basic_block.launches = 0
            st.fused_basic_block_stencil.launches = 0
            t0 = time.perf_counter()
            summary = inference.main(cfgs=cfgs)
            cli_s = time.perf_counter() - t0
            launches = {"tiled": fb.fused_basic_block.launches,
                        "stencil": st.fused_basic_block_stencil.launches}
        finally:
            if old is None:
                del os.environ["EGONET_PALLAS_STENCIL"]
            else:
                os.environ["EGONET_PALLAS_STENCIL"] = old
        # one forward per frame and path (testing_settings.batch_size 1)
        assert launches == {"tiled": 0, "stencil": 104 * 2 * N_FRAMES}, \
            launches
        n_gt = _check_txts(np, os.path.join(out, "gt_box_test", "data"),
                           os.path.join(root, "training", "label_2"), frames,
                           has_score=False)
        n_sub = _check_txts(np, os.path.join(out, "submission", "data"),
                            pred_dir, frames, has_score=True)
        assert n_gt == n_sub == N_FRAMES * N_BOXES, (n_gt, n_sub)
    stats = summary["image_store"]
    evaluation = summary["evaluation"]
    return {"frames": N_FRAMES, "instances_per_path": n_gt,
            "launches": launches["stencil"],
            "tiled_launches": launches["tiled"], "cli_s": cli_s,
            "inference_s": summary["inference_s"],
            "crops_per_s": (n_gt + n_sub) / summary["inference_s"],
            "decoder": stats["decoder"],
            "cli_decode_ms_per_frame": 1e3 * stats["decode_s"]
            / max(stats["decodes"], 1),
            "png_decode_ms_per_frame": 1e3 * float(np.mean(decode_s)),
            "evaluated": evaluation is not None,
            "orientation": [ln for ln in (evaluation or "").splitlines()
                            if "orientation AP" in ln]}


def _kernel_entry(rows, launches, **fields):
    """One entry of the {"kernels": [...]} line: per-shape rows summed over
    one HRNet-W48 forward at 32 crops."""
    def total(key):
        return sum(PER_FORWARD[r["shape"]["C"]] * r[key] for r in rows)

    ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
    return {**fields, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": total("library_ms"),
            "per": "one HRNet-W48 forward at 32 crops (104 launches)"}


def main() -> int:
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's entry points need one",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(here, "egonet_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import numpy as np
    from egonet_tpu_torch.device import full_precision_fp32
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.ops import fused_block as fb
    from egonet_tpu_torch.ops import fused_block_stencil as st

    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}",
          flush=True)
    full_precision_fp32()
    sweep = sweep_plans(fb)
    sweep_lib = fb.library([p for plans in sweep.values() for _, p in plans])
    ssweep = stencil_sweep(st)
    ssweep_lib = st.library([p for plans in ssweep.values() for p in plans])
    t0 = time.perf_counter()
    _build.build([fb.library(), sweep_lib, st.library(), ssweep_lib])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in _build.BUILD_INFO.items():
        print(f"[{name}] built in {info['seconds']:.1f} s; "
              + "; ".join(_ptxas_summary(info["log"])), flush=True)

    print(json.dumps({"sass": sass_report(_build, fb, st)}), flush=True)
    rows = kernel_phase(torch, fb, sweep, sweep_lib)
    srows = stencil_kernel_phase(torch, fb, st, ssweep, ssweep_lib)
    result, model, annot, ry, ry_u = slice_phase(torch, np, fb, st)
    print(json.dumps({"slice": result}), flush=True)
    sresult = stencil_slice_phase(torch, np, fb, st, model, annot, ry, ry_u)
    sresult["tiled_crops_per_s"] = result["crops_per_s"]
    print(json.dumps({"stencil_slice": sresult}), flush=True)
    del model
    torch.cuda.empty_cache()
    cli = cli_phase(np, fb, st)
    print(json.dumps({"cli": cli}), flush=True)

    assert sum(PER_FORWARD.values()) == result["launches_per_forward"]
    print(json.dumps({"earlier": EARLIER}), flush=True)
    print(json.dumps({"kernels": [
        _kernel_entry(rows, result["launches"], name="fused_basic_block",
                      route="cuda",
                      source="egonet_tpu_torch/csrc/fused_basic_block.cu",
                      replaces="egonet_tpu/ops/pallas_block.py:189"),
        _kernel_entry(srows, sresult["launches"],
                      name="fused_basic_block_stencil", route="cuda",
                      source="egonet_tpu_torch/csrc/"
                             "fused_basic_block_stencil.cu",
                      replaces="egonet_tpu/ops/pallas_block_stencil.py:160"),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
