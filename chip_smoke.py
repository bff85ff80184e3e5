#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (egonet_tpu_torch) runs on an
NVIDIA GPU:  python3 chip_smoke.py   (one card; builds the kernels first).

1. Prints the card (name, power limit), torch and CUDA versions, and builds
   every CUDA kernel of the port from csrc/ with nvcc and both operator
   libraries (csrc/egonet_ops.cpp, csrc/egonet_ops_cuda.cpp: the fused
   blocks as C++ torch operators) with the host's c++, one compiler per
   source, all started together (``build`` line: each library's seconds);
   prints each kernel variant's registers and spills, and SASS opcode
   counts of both kernel libraries with an excerpt of the tiled kernel's K
   loop (cuobjdump -sass).
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
3b. Kernel phase at the W32 pedestrian widths (``kernel_ped``): both
   kernels at (C, H) in PED_SHAPES (32/48, 64/24, 128/12, 256/6), batch
   32, each held against its plain version (one bf16 step) and timed
   beside it, the cuDNN convs, the bound and the other tiles / plans of
   PED_ALT_TILES / PED_STENCIL_SWEEP (each also checked), then checked at
   batches 1, 3 and 5.
3b'. Cluster phase (``cluster_sweep`` lines): the tiled kernel at the
   widths whose plan shares each weight slab across a cluster (CLUSTER_
   SHAPES: W48 C=384 / 192, W32 C=256 / 128 / 64) with clusters of 1, 2
   and 4 blocks, each held against its plain version and timed at batch 32
   and at the main path's bucket 512 (C=384 also at the served bucket 16),
   with the bound and the weight bytes a launch reads from L2 (36 C^2 a
   block, once per cluster); the operator's launch beside them, its
   ``multicast_launches`` rising by one where its plan has a cluster.
   ``python3 chip_smoke.py --clusters`` runs this phase alone.
3c. Rigid phase (``rigid`` line): the rigid stage's kernel
   (``egonet::rigid_solve``) against its CPU kernel at N in RIGID_SIZES
   with 32 and 33 points (angles within 1e-5 rad, translations equal, one
   launch a call), then timed at N = 512 beside the torch-op solve it
   replaced (device ms and host ms a call), with ptxas's registers.
4. Slice phase: ``EgoNet(demo_config(), device="cuda")`` — full W48, bf16,
   seeded random weights, the precision harness's LS stats
   (``precision._plausible_ls_stats``: cuboids near a placed one) — runs 4
   synthetic 375x1242 frames with 6 boxes each through dispatch_annot_dict
   -> finalize -> post_process, writing KITTI txts to a temp dir.  The
   kernel launch counts are reset just before and read just after: the
   tiled kernel's must grow by exactly 104 per HRNet forward and the
   rigid solve's (``egonet::rigid_solve``) by one per dispatch.  Outputs
   must be finite, every instance must get a txt line, and the kernel
   path must agree with the same model's unfused eval path (median |d ry|
   < 0.5 deg).
5. Stencil slice phase: the same model with ``prepare_inference(stencil=
   "1")``: exactly 104 stencil launches and 0 tiled ones per forward,
   median |d ry| < 0.5 deg against both the tiled and the unfused paths,
   steady-state crops/s beside the tiled path's.
6. Profile phase: ``torch.profiler`` over 3 steady batches of the slice
   through the tiled kernel and 1 through the stencil
   (``utils/profiling.trace`` / ``summarize_trace``): device ms per facade
   span (``profiling.SPANS``) and per kernel category, the top 10 kernels,
   the device's idle share and longest gaps, the untraced time of the same
   batches (CUDA events); fails unless the trace counts 104 fused launches
   per forward, as the wrapper's counter does, and the spans' device ms
   sum to within 15% of the device's busy time.
7. Fixture phase: the full-width W48 harness (``precision.harness_*``) at
   seeds 0 and 1 against the JAX package's fp32 outputs in
   ``tests/data/torch_w48_fixture.npz`` (kpts, angles, and the trunk's
   well-conditioned outputs: the head's logits and the heatmaps' RMS):
   fp32 with TF32 off, bf16 through the tiled kernel, bf16 through the
   stencil (bars below and in the phase's line).
7b. Native phase: PoseNetTPU at its defaults (the root bench's native
   family, ``config.native_demo_config()``), full width, bf16, on the
   slice's 24 crops: no fused-block launch, 62 bn_act launches a forward
   (one a batch norm), median |d ry| against the
   same model in fp32 under 0.5 deg, crops/s, device ms per span from one
   trace, and the fp32 / bf16 harness against the JAX package's outputs
   in ``tests/data/torch_native_fixture.npz`` (kpts 0.1 px, angles 2e-3
   rad in fp32; median |d ry| 0.5 deg in bf16).
8. CLI phase, stencil on (EGONET_PALLAS_STENCIL=1): writes a small KITTI
   root (4 frames of 375x1242 as PNGs from the port's writer,
   ``data/png.encode``, whose rows cycle through all five PNG filters;
   labels, calibrations, detector txts, LS.npy), checks the port's PNG
   reader against the written pixels, and runs
   ``egonet_tpu_torch.tools.inference.main(cfgs=...)`` on the GT-box and
   submission paths: every instance gets a 17-field line whose fields
   other than alpha and rot_y equal the input line's bytes, with finite
   angles.  Then the evaluator phase: the port's Python evaluator and the
   C++ binary score that submission, and their R40 lines must be equal.
8b. On the same directory, the other families (``train_native``,
   ``train_ped``, ``options`` lines): IGRTrainer steps of the shipped
   native config and of the W32 pedestrian config (192x192 crops, stem to
   stage2 frozen) on one fixed batch in fp32 and bf16 (ms, peak GB, a
   loss that falls); the W32 model's bf16 eval forward in the facade
   through the tiled kernel, the stencil and unfused (104 launches per
   forward of the chosen kernel, |d ry| between the three); the W48 slice
   with ``act_quant: int8`` and with ``fuse_merge: true`` against the
   plain W48 (|d ry|, crops/s); the W48 'heatmap' (``pixel_shuffle``) and
   'angleregression' head forwards; AngleTrainer steps at full W48 width
   in bf16 (a loss that falls); one PoseResNet-50 forward (finite maps,
   56 bn_act launches: one a batch norm).
9. Bench phase (``tools/bench.py``): the device program at batch 32, 128
   and 384 (median of 5 windows, with min and max), FLOPs per crop, MFU,
   for the W48 and the native family (``tpu_native_*``,
   ``headline_family``), the e2e loop, H2D rate.  Drift phase (``tools/precision_drift.py``):
   bf16 against fp32 through the default kernel.
9b. Serve phase (``serve`` line; ``tools/bench_serve.py``'s workload
   in-process): the W48 demo config at full width (bf16, seeded random
   weights, the harness's LS stats) behind ``serving.PoseServer`` on the
   card, 128 requests of 6 boxes from 16 client threads over 16 PNG frames
   of 375x1242, settle passes, one timed pass and 12 single-stream
   requests: req/s, p50 / p90 / max ms, micro-batches, idle dispatches,
   decoder and cache hits; the tiled kernel's launches over the whole run
   (counts set to 0 just before, read just after) must be 104 per served
   micro-batch; every timed response is held against the offline facade
   (``EgoNet.__call__``) on the same frame and boxes (median |d ry| and
   |d alpha| under 0.05 deg, max under 0.5 deg).  Then 32 requests with
   the stencil selected (104 stencil launches per micro-batch, the same
   bar) and one pass of the native family through the same server.
9c. Export phase (``export`` line; ``io/export.py``): buckets 16 and 128
   of the W48 ``_core`` exported on the card (weight-agnostic .pt2, 16
   canvases of 384x1280, the operator and kernel libraries copied beside
   them), loaded, the live weights laid in: 104 fused-op nodes per graph,
   104 launches per call, outputs within one bf16 step of the live
   program's on kpts and 1e-3 rad on the angles; the artifact directory
   run in a fresh interpreter that imports torch and io/export.py only
   (``fresh_interpreter``: each bucket bit-equal to live, 104 launches
   per call read from the directory's C++ counts, no ops or models module
   loaded); a second seeded weight set through the same artifact against
   a live model built with it; artifact bytes, export and load seconds,
   ms per call of both programs (CUDA events, 10 calls after 3), and a
   kernel call's host microseconds through the wrapper, through the C++
   operator alone and by a direct launch (``op_host_us``).
9d. Resume phase (``resume`` line, on the training directory): the IGR
   CLI on the native config in bf16 with ``exact_resume`` (batches of 4
   frames, 6 steps an epoch), 2 epochs and then the same command to 3
   (resumed from the full-state checkpoint), against 3 epochs straight,
   each run as a user runs it: ``exact_resume`` puts the CLI under
   ``torch.use_deterministic_algorithms`` with ``CUBLAS_WORKSPACE_CONFIG``
   set (``device.deterministic``) for that run only: the two final full
   states (parameters, BN buffers, Adam moments, step) must be bit-equal
   (the largest gap printed if not); each asynchronous save's host copy,
   write and how much of it the next epoch hid; and one W48 full-state
   checkpoint (fp32, Adam): bytes, save and restore seconds.
9e. Mesh phase (``mesh`` line): the W48 slice (bf16) through
   ``EgoNet(mesh=DataMesh([cuda:0, cuda:0]))``: two shards of 16 at bucket
   32 on the one card, 104 tiled launches and one rigid_solve launch per
   shard by the counters, then 104 stencil launches per shard with the
   stencil selected, each held
   against the single-device facade on the same batch (median |d ry| and
   |d alpha| at most 0.05 deg, max 0.5), and one dispatch of each facade
   (single, two shards) run under ``torch.cuda.set_sync_debug_mode
   ("error")``: the dispatch path makes no host synchronisation; then 32
   requests served through a PoseServer over the mesh (104 tiled launches
   per shard of every micro-batch), held against the single-device facade.
9f. DP phase (``dp`` line): ``tools/dryrun_multigpu`` with 2 ranks on
   cuda:0 over gloo (nccl refuses two ranks on one card), every leg (the
   W48 legs at full width), then one rank over nccl (the legs that hold
   a group against one process skipped as such).
9g. Gate phase (``gate`` line; ``tests/torch_gate.py``, the pipeline of
   tests/test_torch_closed_loop_gate.py): both kernels held against their
   plain version at the gate model's block shapes (GATE_SHAPES, batch 32
   and 5; timed at 32); the JAX gate's world of 40 keypoint-drawn frames;
   each committed donor probed on the card against its sidecar; the car,
   W32-family pedestrian and native models fine-tuned from their donors
   on the card (fp32) and both 'R3d+T' lifters trained there; then each
   family's inference CLI on both paths, on the CPU in fp32 (the CPU leg
   of these weights) and on the card in bf16, the HRNet families through
   the tiled kernel and through the stencil: each kernel's launches per
   HRNet forward equal the blocks the model routes to it (6: the width-8
   blocks run unfused), every leg's AOS / AP_R11 ratio reaches the JAX
   gate's floor with its detection AP at the protocol ceiling, printed
   with the gap to the CPU leg and |d ry| against it.
9h. Scratch phase (``scratch`` line): the port trains from scratch on the
   card with its two tools at reduced lengths, their own asserts intact:
   ``tools/make_gate_artifacts`` for both gate donor families
   (SCRATCH_DONOR_ARGS: 10 epochs on a world of 108 frames), each donor
   probed on the gate's world (its sidecar's val px), then
   ``tools/record_native_fullwidth`` (SCRATCH_NATIVE_ARGS: the shipped
   full-width PoseNetTPU for 20 epochs on 48 frames, its lifter, the
   inference CLI in fp32 and the evaluator: AP / AOS R11 easy).  No fused
   kernel runs there (the donors train in fp32; PoseNetTPU has no
   BasicBlock).
9i. Trained-loop phase (``trained_loop`` line): the from-scratch trained
   closed loop of both shrunk families (``tools/trained_closed_loop``, the
   port of tests/test_trained_closed_loop.py) cut to TRAINED_LOOP_ARGS
   (TRAINED_LOOP_CUTS): the HRNet and PoseNetTPU trained from scratch on
   the card, the shared lifter, then the inference CLI on the
   detector-box path in fp32 and in bf16, the HRNet through the tiled
   kernel and through the stencil (counts set to 0 before each leg and
   read after it: each kernel's launches equal the blocks the model routes
   to it, 6 a forward, times its forwards, and are more than 0); every
   leg's AP_R11 easy above 99 and AOS_R11 easy at its family's
   TRAINED_LOOP_AOS_MIN or above, the C++ evaluator's AOS equal to the
   Python one.
10. Prints one JSON line per kernel shape and phase, both kernels' earlier
   times per forward (past figures from PERF.md, labelled so), the
   {"kernels": [...]} line (every number in it measured or, for
   ``bound_ms``, reckoned in this run; per W48 forward, with every shape's
   row under ``shapes`` and the W32 forward's sums under
   ``w32_forward``, the serve phase's launches and micro-batches under
   ``serve_launches`` / ``served_batches``, the exported programs'
   launches per call, the mesh phase's launches under ``mesh_launches``,
   the gate phase's under ``gate_launches`` and its shapes under
   ``gate_shapes``, the trained-loop phase's under
   ``trained_loop_launches``),
   each phase's seconds (``phase_s``), the run's seconds, the card line,
   and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without CUDA or outside a checkout.
Any failure raises (non-zero exit).

``python3 chip_smoke.py --gate-donors DIR`` runs only the gate phase (9g),
on the donors ``python -m egonet_tpu_torch.tools.make_gate_artifacts --out
DIR`` trained, and ends with the same card and ``{"ok": true, ...}`` lines.
``python3 chip_smoke.py --trained-loop`` runs only
``tools/trained_closed_loop`` at its full recipe (both kernels built
first), and ends the same way.
``python3 chip_smoke.py --cards N`` runs only the multicard phase over
the first N cards (an error when fewer are visible; nothing falls back to
gloo, to cuda:0 or to a plain version), one ``multicard`` line per leg
with its seconds, each card's name and nvidia-smi's name and power limit
of each: ``build_race`` (N nccl ranks reach the operators' first use at
once; the build lock lets one build, the others wait and load, each
rank's seconds), ``kernels`` (both kernels on every card at the W48
shapes against their plain version), ``mesh`` (the W48 slice through
``EgoNet(mesh=make_mesh(N))`` against the single-card facade, tiled then
stencil, 104 x N launches of the kernel in use, both dispatches under the
sync debug mode; the overlap rows: each shard's device window on its card
and the batch's wall time, at buckets 32 and 384), ``scaling`` (W48
device-program crops/s at batch 32 / 128 / 384 and e2e crops/s over 1, 2
and N cards in turns 1, N, 2, 2, N, 1, each the median of 5 windows),
``serve`` (bench_serve's workload through ``tools/serve --devices`` 1 and
N, every response against the offline facade), ``dryrun`` (the dry run
over N nccl ranks, all 7 legs; from 3 cards also over 3 ranks, where the
wrap padding runs) and ``train`` (the IGR and lifter trainers' fp64 first
step at N ranks against one process at tests/test_torch_dp.py's bars, the
W48 gradients' all-reduce seconds, both training CLIs on the synthetic
world at N, 2 and 1 ranks: crops trained per second).  Then the card and
``{"ok": true, ...}`` lines.
"""

import copy
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

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
# the W32 pedestrian model's branch widths and maps (192x192 crops), its
# fused blocks per forward at each width (104 in all), the odd batches
# checked there, and the other tiles / stencil plans checked and timed
# beside the chosen ones (fb.tile_for, st.tile_for)
PED_SHAPES = ((32, 48), (64, 24), (128, 12), (256, 6))
PED_PER_FORWARD = {32: 32, 64: 32, 128: 28, 256: 12}
PED_ODD_BATCHES = (1, 3, 5)
PED_ALT_TILES = {
    32: ((8, 8, 1, 48), (8, 16, 1, 48), (16, 16, 1, 48), (12, 16, 1, 48),
         (16, 24, 1, 48), (24, 24, 1, 48), (8, 48, 1, 48)),
    64: ((8, 8, 1, 48), (8, 12, 1, 48), (12, 12, 1, 48), (12, 24, 1, 48),
         (24, 24, 1, 48), (4, 8, 2, 48), (6, 12, 1, 48)),
    128: ((8, 8, 1, 48), (12, 12, 1, 48), (6, 6, 1, 48), (6, 12, 1, 48),
          (4, 12, 1, 48), (6, 6, 2, 48)),
    256: ((6, 6, 1, 48), (8, 8, 1, 48), (3, 6, 1, 48), (6, 6, 2, 48),
          (2, 6, 1, 48), (3, 3, 1, 48))}
PED_STENCIL_SWEEP = {
    32: ((8, 1, 1, 1, 1, 1, 1), (16, 4, 1, 1, 2, 2, 1),
         (16, 2, 1, 1, 1, 1, 1), (8, 4, 1, 1, 1, 1, 1),
         (24, 2, 1, 1, 2, 2, 1), (48, 1, 1, 1, 2, 2, 1)),
    64: ((8, 1, 1, 1, 1, 1, 1), (8, 3, 1, 1, 1, 1, 1),
         (12, 2, 1, 1, 1, 1, 1), (24, 1, 1, 1, 2, 2, 1),
         (8, 3, 1, 2, 1, 1, 1), (12, 2, 1, 2, 1, 1, 1)),
    128: ((8, 1, 1, 4, 1, 1, 1), (12, 1, 1, 4, 1, 1, 1),
          (6, 1, 1, 4, 1, 1, 1), (12, 2, 1, 4, 1, 1, 1),
          (12, 1, 2, 4, 1, 1, 1), (12, 1, 1, 8, 1, 1, 1)),
    256: ((8, 1, 1, 8, 1, 1, 1), (6, 1, 1, 8, 1, 1, 1),
          (6, 2, 1, 8, 1, 1, 1), (6, 1, 2, 8, 1, 1, 1),
          (6, 3, 1, 8, 1, 1, 1), (6, 2, 2, 8, 1, 1, 1))}
# IGR steps of the native and pedestrian phases after the warm one
N_FAMILY_STEPS = 4
BATCH = 32
# the fixture phase's fp32 bars: the random-weight W48 saturates most of
# the head's sigmoids and the rest come from logits that cancel large
# terms, so fp32 rounding alone moves a few points by hundredths of a px
# (tests/test_torch_precision.py: the JAX fp32 fixture lies up to 0.041 px
# from the port's fp64 forward, the port's CPU fp32 0.059 px from it)
FIXTURE_FP32_KPTS_PX = 0.1
FIXTURE_FP32_RY_RAD = 2e-3
# the trunk's well-conditioned outputs (the head's logits, the heatmaps'
# RMS), relative L2 gap per instance: fp32 as on the CPU (port against JAX
# 2.8e-6 there; one wrong channel pair in one block gives 4.6e-3), bf16 a
# bar for gross faults only (bf16 rounding alone gives ~1e-2 on the CPU)
FIXTURE_FP32_REL, FIXTURE_BF16_REL = 2e-5, 5e-2
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
N_FRAMES, N_BOXES = 4, 6
# the training phases' train split: one IGR batch of frames (the shipped
# batch_size), 3 cars each (72 real crops, padded to 140); IGR runs 6 steps
N_TRAIN_FRAMES, N_TRAIN_BOXES, N_TRAIN_STEPS = 24, 3, 6
# the full-width train step against the JAX fixture (relative gaps,
# precision.train_gaps): as on the CPU, twice the fp32 rounding of either
# package against fp64 (tests/test_torch_train_fixture.py)
TRAIN_FIXTURE_BARS = {"loss": 1e-5, "hm": 1e-5, "coor": 2e-5,
                      "grad_norms": 1e-2, "bn_stats": 1e-4}


def _ptxas_summary(log):
    """One "<template args>: N registers, S bytes spilled" item per kernel
    variant in nvcc's -Xptxas -v output."""
    items, name, spill = [], "?", "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) + ">"
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


# ---------------------------------------------------------------------------
# direct launches: a plan straight from a kernel library, for the sweeps
# ---------------------------------------------------------------------------

# kernel library name -> its ctypes handle; kernel module -> plan struct
_KERNEL_LIBS: dict = {}
_PLAN_STRUCTS: dict = {}


def _kernel_lib(lib):
    """The kernel library ``lib`` (as ``library()`` names it), built if
    stale and loaded with ctypes, once."""
    from egonet_tpu_torch.ops import _build
    name = lib[0]
    if name not in _KERNEL_LIBS:
        _build.build([lib])
        _KERNEL_LIBS[name] = ctypes.CDLL(
            os.path.join(_build.BUILD_DIR, f"lib{name}.so"))
    return _KERNEL_LIBS[name]


def _plan_struct(mod, plan):
    """``plan`` as the kernel's C struct: the fields of ``mod._PLAN_FIELDS``
    in their order, each an int."""
    cls = _PLAN_STRUCTS.get(mod.__name__)
    if cls is None:
        cls = _PLAN_STRUCTS[mod.__name__] = type(
            "Plan", (ctypes.Structure,),
            {"_fields_": [(f, ctypes.c_int) for f in mod._PLAN_FIELDS]})
    return cls(*(getattr(plan, f) for f in mod._PLAN_FIELDS))


def max_clusters(mod, plan, lib=None):
    """How many clusters of ``plan`` (the stencil's, or a tiled cluster
    plan) the card holds at once (``cudaOccupancyMaxActiveClusters``,
    through the ``_clusters`` entry of ``lib``, default a library of the
    plan alone)."""
    struct = _plan_struct(mod, plan)
    fn = getattr(_kernel_lib(lib or mod.library([plan])),
                 f"egonet_{mod._LIB_NAME}_clusters")
    fn.argtypes = [ctypes.c_int, type(struct), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(plan.c, struct, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error "
                           f"{err} (plan={plan})")
    return out.value


def _weight_maps(fb, plan, lib, weights):
    """The TMA descriptors of ``weights`` for the tiled cluster ``plan``
    (``egonet_fused_basic_block_weight_map`` of ``lib``): (buffers, their
    64-byte aligned addresses)."""
    struct = _plan_struct(fb, plan)
    fn = _kernel_lib(lib).egonet_fused_basic_block_weight_map
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, type(struct),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bufs, addrs = [], []
    for w in weights:
        buf = (ctypes.c_ubyte * 192)()
        addr = -(-ctypes.addressof(buf) // 64) * 64
        err = fn(w.data_ptr(), plan.c, struct, addr)
        if err != 0:
            raise RuntimeError(f"tensor map encoding failed: CUresult {err} "
                               f"(plan={plan})")
        bufs.append(buf)
        addrs.append(addr)
    return bufs, addrs


def direct(torch, mod, plan, lib=None):
    """``launch(x, w1, b1, w2, b2) -> y``: the kernel of ``mod``
    (``fused_block`` or ``fused_block_stencil``) with ``plan``, launched
    from ``lib`` (default: the module's default library) through its plain
    C entry point, on the current stream of x's device with that device
    current (a tiled cluster plan with its weights' TMA descriptors,
    encoded when the operands change).  The package reaches a kernel only
    through its operator; the sweeps' plans are in no operator's table, so
    their launches are made here, and the op's ``launches`` does not count
    them.  Raises for a plan the card holds no cluster of."""
    lib = lib or mod.library()
    stencil = mod.__name__.endswith("stencil")
    clustered = not stencil and plan.cluster > 1
    if (stencil or clustered) and max_clusters(mod, plan, lib) < 1:
        k = plan.k if stencil else plan.cluster
        raise RuntimeError(f"the card holds no cluster of {k} blocks of "
                           f"{plan.smem} bytes (plan={plan})")
    struct = _plan_struct(mod, plan)
    fn = getattr(_kernel_lib(lib), "egonet_" + mod._LIB_NAME)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [type(struct)] + [ctypes.c_void_p] * (1 if stencil
                                                           else 3))
    fn.restype = ctypes.c_int
    # the operands last checked, held so that `is` cannot match a new
    # tensor: a timing loop pays for the check once, not every launch
    checked = [None] * 5
    maps = [None, (None, None)]      # descriptor buffers, their addresses

    def launch(x, w1, b1, w2, b2):
        c = plan.c
        ops = (x, w1, b1, w2, b2)
        if not all(a is b for a, b in zip(ops, checked)):
            if not (x.is_cuda and x.dtype == torch.bfloat16
                    and x.dim() == 4 and x.shape[3] == c
                    and all(w.dtype == torch.bfloat16
                            and w.numel() == 9 * c * c for w in (w1, w2))
                    and all(b.dtype == torch.float32 and b.numel() == c
                            for b in (b1, b2))
                    and all(t.device == x.device and t.is_contiguous()
                            for t in ops)):
                raise ValueError(f"operands do not fit the plan at C={c}")
            checked[:] = ops
            if clustered:
                maps[:] = _weight_maps(mod, plan, lib, (w1, w2))
        n, h, w, _ = x.shape
        y = torch.empty_like(x)
        extra = () if stencil else tuple(maps[1])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                     w2.data_ptr(), b2.data_ptr(), y.data_ptr(), n, h, w, c,
                     struct, *extra, stream)
        if err != 0:
            raise RuntimeError(f"{mod._LIB_NAME} launch failed: CUDA error "
                               f"{err} (N={n} H={h} W={w} plan={plan})")
        return y
    return launch


def _tile_name(tile):
    return "x".join(map(str, tile))


# the widths the tiled kernel runs as clusters sharing each weight slab (W48
# C=384 / 192, W32 C=256 / 128 / 64), swept at every cluster size at batch
# 32 and at the main path's bucket 512; C=384 also at the served bucket 16
CLUSTER_SHAPES = ((384, 8), (192, 16), (256, 6), (128, 12), (64, 24))
CLUSTER_BATCHES = (32, 512)
SERVED_BUCKET = 16


def cluster_plans(fb):
    """{C: {k: plan}}: each width of CLUSTER_SHAPES at its default tile
    with every cluster size that fits (1 included)."""
    return {c: {k: fb.plan_for(c, None, k) for k in (1,) + fb._CLUSTERS
                if fb.tile_fits(c, None, k)} for c, _ in CLUSTER_SHAPES}


def cluster_phase(torch, fb, plans, lib):
    """The tiled kernel at each width of CLUSTER_SHAPES with each cluster
    size of ``plans`` (launched from ``lib``): held against its plain
    version (one bf16 step) and timed at batch 32 and 512 (C=384 also at
    16), beside the bound and the weight bytes a launch reads from L2
    (36 C^2 per block, once per cluster); and the operator's own launch
    (the width's default plan).  One ``cluster_sweep`` line per shape."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(7)
    for c, h in CLUSTER_SHAPES:
        batches = CLUSTER_BATCHES + ((SERVED_BUCKET,) if c == 384 else ())
        for batch in batches:
            x, (w1, b1, w2, b2) = _block_inputs(torch, fb, g, c, h, batch)
            ref = fb.fused_basic_block_reference(x, w1, b1, w2, b2).float()
            ops = 4.0 * batch * h * h * 9 * c * c
            nbytes = 4.0 * batch * h * h * c + 36.0 * c * c
            row = {"shape": {"C": c, "H": h, "W": h, "B": batch},
                   "default_cluster": fb.plan_for(c).cluster,
                   "bound_ms": max(ops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
                   "by_cluster": {}}
            for k, plan in plans[c].items():
                launch = direct(torch, fb, plan, lib)
                y = launch(x, w1, b1, w2, b2)
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), ref, atol=5e-2,
                                           rtol=2e-2)
                gx, gy = fb.grid_for(plan, batch, h, h)
                row["by_cluster"][str(k)] = {
                    "ms": _time_ms(torch, lambda: launch(x, w1, b1, w2, b2)),
                    "max_abs_err": (y.float() - ref).abs().max().item(),
                    "blocks": gx * gy,
                    "l2_weight_bytes": 36 * c * c * gx * gy // k,
                    "ks": plan.ks, "stages": plan.stages,
                    "smem": plan.smem}
            before = fb.fused_basic_block.multicast_launches
            y = fb.fused_basic_block(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), ref, atol=5e-2, rtol=2e-2)
            assert fb.fused_basic_block.multicast_launches == before + (
                row["default_cluster"] > 1)
            row["op_ms"] = _time_ms(
                torch, lambda: fb.fused_basic_block(x, w1, b1, w2, b2))
            print(json.dumps({"cluster_sweep": row}), flush=True)
            rows.append(row)
            del x, w1, w2, ref, y
    return rows


def clusters_only(torch, _build, fb, card):
    """``--clusters``: the operator libraries and the cluster sweep's
    library built (ptxas's registers and spills printed), then
    :func:`cluster_phase`; ends with the card and ``{"ok": true}``."""
    plans = cluster_plans(fb)
    lib = fb.library([p for by_k in plans.values() for p in by_k.values()])
    t0 = time.perf_counter()
    _build.build(_build.ops_libs("cuda") + [lib])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in _build.BUILD_INFO.items():
        print(f"[{name}] built in {info['seconds']:.1f} s; "
              + "; ".join(_ptxas_summary(info["log"])), flush=True)
    t0 = time.perf_counter()
    cluster_phase(torch, fb, plans, lib)
    print(json.dumps({"phase_s": {"clusters": time.perf_counter() - t0},
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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

        def kernel(launch=None):
            if launch is None:
                return fb.fused_basic_block(x, w1, b1, w2, b2)
            return launch(x, w1, b1, w2, b2)

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
        alt = [(t, direct(torch, fb, plan, sweep_lib))
               for t, plan in sweep[c]]
        for _, launch in alt:
            y = kernel(launch)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), ref.float(), atol=5e-2,
                                       rtol=2e-2)
        ops_ms, bytes_ms = _bound(c, h, h)
        # ms: the default plan's kernel launched directly (device time);
        # op_ms: through the wrapper and the C++ operator, whose host
        # dispatch can outlast a small launch
        default = direct(torch, fb, fb.plan_for(c))
        row = {"shape": {"C": c, "H": h, "W": h, "B": BATCH},
               "tile": list(fb.tile_for(c)),
               "plan": dataclasses.asdict(fb.plan_for(c)),
               "max_abs_err": err,
               "ms": _time_ms(torch, lambda: kernel(default)),
               "op_ms": _time_ms(torch, kernel),
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
            "max_active_clusters": max_clusters(st, plan, lib)}


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

        def kernel(launch=None):
            if launch is None:
                return st.fused_basic_block_stencil(x, w1, b1, w2, b2)
            return launch(x, w1, b1, w2, b2)

        def plain():
            return st.fused_basic_block_reference(x, w1, b1, w2, b2)

        def tiled(launch=direct(torch, fb, fb.plan_for(c))):
            return launch(x, w1, b1, w2, b2)

        library = _library_block(torch, x, w1, b1, w2, b2)
        ref = plain()
        alt = [(p, direct(torch, st, p, sweep_lib)) for p in sweep[c]]
        for launch in [None] + [a for _, a in alt]:
            y = kernel(launch)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), ref.float(), atol=5e-2,
                                       rtol=2e-2)
        y = kernel()
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        assert torch.isfinite(y.float()).all()
        ops_ms, bytes_ms = _bound(c, h, h)
        default = direct(torch, st, st.plan_for(c))
        row = {"shape": {"C": c, "H": h, "W": h, "B": BATCH},
               "plan": _plan_summary(st, st.plan_for(c), st.library()),
               "max_abs_err": err,
               "ms": _time_ms(torch, lambda: kernel(default)),
               "op_ms": _time_ms(torch, kernel),
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


def _frames(np, n_frames=N_FRAMES, n_boxes=N_BOXES):
    """Synthetic KITTI-sized frames, boxes, intrinsics and detector lines
    (by default the slice's: N_FRAMES frames x N_BOXES boxes)."""
    rng = np.random.RandomState(0)
    K = np.array([[721.5, 0.0, 609.6], [0.0, 721.5, 172.9], [0.0, 0.0, 1.0]])
    annot = {"path": [], "boxes": [], "images": [], "K": [],
             "raw_txt_format": []}
    for i in range(n_frames):
        x = rng.uniform(0, 1000, n_boxes)
        y = rng.uniform(120, 220, n_boxes)
        boxes = np.stack([x, y, x + rng.uniform(40, 240, n_boxes),
                          y + rng.uniform(30, 140, n_boxes)], axis=1)
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


RIGID_SIZES = (1, 8, 384, 512, 513)
RIGID_TIMED_N, RIGID_TIMED_CALLS = 512, 200


def _cuboid_batch(np, rng, n, points):
    """``n`` noisy rotated car cuboids, [n, 32, 3] center-relative (with a
    camera-frame root before them when ``points`` is 33), fp32."""
    from egonet_tpu_torch.data import cuboid
    preds = []
    for _ in range(n):
        box = cuboid.construct_box_3d(3.9 + 0.2 * rng.randn(), 1.5, 1.7)
        rot = cuboid.rot_y_matrix(float(rng.uniform(-np.pi, np.pi)))
        preds.append((rot @ (box[:, 1:] - box[:, :1])).T
                     + 0.02 * rng.randn(32, 3))
    preds = np.stack(preds)
    if points == 33:
        root = rng.uniform([-20, -1, 2], [20, 2, 60], (n, 1, 3))
        preds = np.concatenate([root, preds], axis=1)
    return preds.astype(np.float32)


def rigid_phase(torch, np, card):
    """The rigid stage's kernel (``egonet::rigid_solve``, one thread a
    crop): at each N of RIGID_SIZES with 32 and 33 points, the CUDA kernel
    against the CPU kernel (the same routine of csrc/rigid_solve.cuh:
    angles within 1e-5 rad, translations equal), one launch a call; then at
    N = RIGID_TIMED_N, RIGID_TIMED_CALLS back-to-back calls timed with CUDA
    events and the host clock beside the torch-op solve it replaced
    (``geometry/rigid.six_dof_from_cuboids``), whose angles it must match
    within 1e-5 rad; ptxas's registers and spills from the build log."""
    from egonet_tpu_torch.geometry import rigid
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.ops.rigid_solve import rigid_solve
    rng = np.random.RandomState(20)
    rows = []
    for points in (32, 33):
        for n in RIGID_SIZES:
            kpts = torch.from_numpy(_cuboid_batch(np, rng, n, points))
            want = rigid_solve(kpts)
            before = rigid_solve.launches
            got = rigid_solve(kpts.cuda())
            torch.cuda.synchronize()
            assert rigid_solve.launches == before + 1, (n, points)
            got = got.cpu()
            d = (got[:, :3] - want[:, :3]).abs().max().item()
            rows.append({"n": n, "points": points, "max_abs_d_angle": d})
            assert d < 1e-5 and torch.equal(got[:, 3:], want[:, 3:]), rows

    kpts = torch.from_numpy(_cuboid_batch(np, rng, RIGID_TIMED_N, 32)).cuda()

    def timing(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        for _ in range(RIGID_TIMED_CALLS):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3 / RIGID_TIMED_CALLS
        end.record()
        torch.cuda.synchronize()
        return {"ms_per_call": start.elapsed_time(end) / RIGID_TIMED_CALLS,
                "host_ms_per_call": host_ms}

    six = rigid_solve(kpts)
    angles, _ = rigid.six_dof_from_cuboids(kpts)
    d = (six[:, :3] - angles).abs().max().item()
    assert d < 1e-5, d
    log = _build.BUILD_INFO.get("rigid_solve", {}).get("log", "")
    row = {"card": card, "checks": rows,
           "timed_n": RIGID_TIMED_N, "calls": RIGID_TIMED_CALLS,
           "op": timing(lambda: rigid_solve(kpts)),
           "torch_ops": timing(lambda: rigid.six_dof_from_cuboids(kpts)),
           "max_abs_d_angle_vs_torch_ops": d,
           "ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]}
    print(json.dumps({"rigid": row}), flush=True)
    return row


# egonet::bn_act: the CUDA kernel against the CPU kernel at these NHWC
# shapes (layer1, the stem's width, head2's C = 66, W48's stage 4, an odd
# width, then BN_ACT_RESNET), then at layer1's shape of a full bucket (the
# grid strides over it several times) against the CPU kernel and the
# unfused ops, and timed; launches a forward of W48 or W32 in bf16
# inference (the batch norms outside the fused blocks)
# PoseResNet-152's widths no HRNet layer gives the kernel, each also held
# to the unfused ops: layer4's, layer3's and layer2's block outputs (C =
# 2048, 1024, 512: one, two and four pixels a block), the stem at 128x128,
# a transposed conv's output (C = 256 at 32x32)
BN_ACT_RESNET = ((4, 8, 8, 2048), (4, 16, 16, 1024), (4, 32, 32, 512),
                 (2, 128, 128, 64), (3, 32, 32, 256))
BN_ACT_SHAPES = ((8, 64, 64, 256), (3, 64, 64, 64), (5, 8, 8, 66),
                 (7, 8, 8, 384), (2, 3, 5, 35)) + BN_ACT_RESNET
BN_ACT_TIMED, BN_ACT_TIMED_CALLS = (512, 64, 64, 256), 50
# fuse_merge's layer1 group at a full bucket: conv1's 64 channels beside
# the downsample's 256, the downsample's view read in place (and, as a
# residual, the view of the first 256)
BN_ACT_SLICE = (64, 256)
# most of the full bucket's elements that may differ from the unfused ops
# (the CPU tests' widths read at most 0.011%)
BN_ACT_MAX_DIFFER = 0.02
BN_ACT_PER_FORWARD = 96
HBM_TBPS = 3.35


def _bn_act_bound(torch, x, scale, shift, t, residual):
    """How far bn_act may lie from the unfused ops on NHWC operands (the
    CPU tests' bound): one bf16 step of the batch norm's value t, two fp32
    steps of its terms x * scale and shift (where they cancel), and with a
    residual one bf16 step of the sum."""
    def step(v):
        v = v.float().abs()
        e = torch.floor(torch.log2(torch.where(v > 0, v, torch.ones_like(v))))
        return torch.where(v > 0, torch.exp2(e - 7), torch.zeros_like(v))

    bound = step(t) + ((x.float() * scale).abs() + shift.abs()) * 2.0 ** -22
    if residual is not None:
        bound += step(t.float() + residual.float())
    return bound


def bn_act_phase(torch, np, card):
    """The batch-norm epilogue's kernel (``egonet::bn_act``): at each shape
    of BN_ACT_SHAPES, with and without a residual and a relu, the CUDA
    kernel bit for bit the CPU kernel (csrc/bn_act.cuh's routine), one
    launch a call, and once with x misaligned (the 2-byte path).  At each
    shape of BN_ACT_RESNET and at BN_ACT_TIMED, with and without a
    residual: bit for bit the CPU kernel and within :func:`_bn_act_bound`
    of the unfused ops it replaced (cast to fp32, batch norm, cast back,
    add, relu) with at most BN_ACT_MAX_DIFFER of the elements differing;
    at BN_ACT_TIMED also on a BN_ACT_SLICE channel view read in place,
    bit for bit the CPU kernel; then, after as many
    untimed, BN_ACT_TIMED_CALLS back-to-back calls timed with CUDA events,
    its TB/s of bytes read and
    written against HBM_TBPS, beside the unfused ops; ptxas's registers and
    spills from the build log."""
    import torch.nn.functional as F
    from egonet_tpu_torch.io.weights import bn_affine_tensors
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.ops.bn_act import bn_act
    rng = np.random.RandomState(23)

    def operands(shape, device="cpu"):
        c = shape[-1]
        x, r = (torch.from_numpy((rng.randn(*shape) * 2).astype(np.float32))
                .bfloat16().to(device) for _ in range(2))
        scale = torch.from_numpy(rng.uniform(-1.5, 1.5, c).astype(np.float32))
        shift = torch.from_numpy(rng.randn(c).astype(np.float32))
        return x, r, scale.to(device), shift.to(device)

    def same_as_cpu(got, x, scale, shift, r, relu):
        want = bn_act(*(None if t is None else t.cpu()
                        for t in (x, scale, shift, r)), relu)
        return torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))

    checks = 0
    for shape in BN_ACT_SHAPES:
        for residual in (False, True):
            for relu in (False, True):
                x, r, scale, shift = operands(shape)
                r = r if residual else None
                before = bn_act.launches
                got = bn_act(x.cuda(), scale.cuda(), shift.cuda(),
                             None if r is None else r.cuda(), relu)
                torch.cuda.synchronize()
                assert bn_act.launches == before + 1, shape
                assert same_as_cpu(got, x, scale, shift, r, relu), (
                    shape, residual, relu)
                checks += 1
    x, r, scale, shift = operands((4, 16, 16, 256))
    xm = torch.empty(x.numel() + 1, dtype=x.dtype,
                     device="cuda")[1:].view(x.shape)
    xm.copy_(x)
    got = bn_act(xm, scale.cuda(), shift.cuda(), r.cuda(), True)
    assert same_as_cpu(got, x, scale, shift, r, True)
    checks += 1

    def bn_operands(shape):
        """x, residual, a batch norm's (gamma, beta, mean, var) and its
        (scale, shift), on the card."""
        x, r, gamma, beta = operands(shape, "cuda")
        c = shape[-1]
        mean = torch.from_numpy(rng.randn(c).astype(np.float32)).cuda()
        var = torch.from_numpy(
            rng.uniform(0.5, 2, c).astype(np.float32)).cuda()
        stats = (gamma, beta, mean, var)
        return x, r, stats, bn_affine_tensors(*stats, 1e-5)

    def unfused(x, r, stats, residual):
        gamma, beta, mean, var = stats
        t = F.batch_norm(x.permute(0, 3, 1, 2).float(), mean, var, gamma,
                         beta, False, 0.0, 1e-5).to(torch.bfloat16)
        return t, torch.relu(t + r.permute(0, 3, 1, 2) if residual else t)

    def against_unfused(x, r, stats, scale, shift, residual):
        """bn_act with a relu bit for bit the CPU kernel and within
        _bn_act_bound of the unfused ops -> the share of its elements
        differing from theirs."""
        res = r if residual else None
        got = bn_act(x, scale, shift, res, True)
        assert same_as_cpu(got, x, scale, shift, res, True), (
            tuple(x.shape), residual)
        t, want = (v.permute(0, 2, 3, 1)
                   for v in unfused(x, r, stats, residual))
        bound = _bn_act_bound(torch, x, scale, shift, t, res)
        within = bool(((got.float() - want.float()).abs() <= bound).all())
        differ = float((got != want).float().mean())
        assert within and differ <= BN_ACT_MAX_DIFFER, (
            tuple(x.shape), residual, differ)
        return differ

    resnet = {}
    for shape in BN_ACT_RESNET:
        x, r, stats, (scale, shift) = bn_operands(shape)
        resnet["x".join(map(str, shape))] = {
            "residual_relu" if residual else "relu":
                against_unfused(x, r, stats, scale, shift, residual)
            for residual in (False, True)}
        checks += 2

    # the full bucket
    x, r, stats, (scale, shift) = bn_operands(BN_ACT_TIMED)
    n, h, w, c = BN_ACT_TIMED
    full = {}
    for residual in (False, True):
        full["residual_relu" if residual else "relu"] = {
            "share_differing_from_unfused": against_unfused(
                x, r, stats, scale, shift, residual)}
        checks += 1
    torch.cuda.empty_cache()
    before, width = BN_ACT_SLICE
    wide = torch.randn(n, h, w, before + width, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           23)).bfloat16()
    view = wide[..., before:]
    sc, sh = scale[:width], shift[:width]
    for res in (None, wide[..., :width]):
        got = bn_act(view, sc, sh, res, True)
        assert same_as_cpu(got, view, sc, sh, res, True), res is None
        checks += 1
    del wide, view, got
    torch.cuda.empty_cache()

    def timing(fn, tensors):
        # one untimed loop first: the card's clocks settle after the CPU
        # checks above
        for _ in range(BN_ACT_TIMED_CALLS):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BN_ACT_TIMED_CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / BN_ACT_TIMED_CALLS
        tbps = tensors * x.numel() * 2 / (ms * 1e-3) / 1e12
        return {"ms": ms, "tb_per_s": tbps, "of_peak": tbps / HBM_TBPS}

    row = {"card": card, "checks": checks, "timed_nhwc": list(BN_ACT_TIMED),
           "calls": BN_ACT_TIMED_CALLS, "full_bucket": full,
           "relu": timing(lambda: bn_act(x, scale, shift, None, True), 2),
           "residual_relu": timing(lambda: bn_act(x, scale, shift, r, True),
                                   3),
           "unfused_relu_ms": timing(
               lambda: unfused(x, r, stats, False), 2)["ms"],
           "unfused_residual_relu_ms": timing(
               lambda: unfused(x, r, stats, True), 3)["ms"],
           "resnet_share_differing_from_unfused": resnet}
    log = _build.BUILD_INFO.get("bn_act", {}).get("log", "")
    row["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
    print(json.dumps({"bn_act": row}), flush=True)
    return row


def _launch_counts(fb, st):
    """Set both fused kernels', the rigid solve's and bn_act's launch
    counts to 0; returns a function that reads them as {"tiled": n,
    "stencil": n, "rigid": n, "bn_act": n}."""
    from egonet_tpu_torch.ops.bn_act import bn_act
    from egonet_tpu_torch.ops.rigid_solve import rigid_solve
    counted = {"tiled": fb.fused_basic_block,
               "stencil": st.fused_basic_block_stencil, "rigid": rigid_solve,
               "bn_act": bn_act}
    for wrapper in counted.values():
        wrapper.launches = 0
    return lambda: {k: w.launches for k, w in counted.items()}


def _drive(torch, model, annot, fb, st, out_dir):
    """One batch through dispatch -> finalize -> post_process, with the
    kernels' launch counts set to 0 just before and read just after.
    Checks that every instance got a 17-field txt line.  Returns (records,
    {"tiled": n, "stencil": n, "rigid": n, "bn_act": n}, seconds)."""
    read = _launch_counts(fb, st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = model.finalize(model.dispatch_annot_dict(annot))
    model.post_process(records, save_dict={"flag": True, "save_dir": out_dir})
    seconds = time.perf_counter() - t0
    launches = read()
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
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.precision import _plausible_ls_stats

    t0 = time.perf_counter()
    model = EgoNet(demo_config(), device="cuda")
    assert model.dtype == torch.bfloat16
    model.load_state(ls_stats=_plausible_ls_stats())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    annot = _frames(np)
    n_inst = N_FRAMES * N_BOXES

    fb.fused_basic_block.multicast_launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        records, launches, first_s = _drive(torch, model, annot, fb, st,
                                            out_dir)
    assert launches == {"tiled": 104, "stencil": 0, "rigid": 1,
                        "bn_act": BN_ACT_PER_FORWARD}, launches
    # launches as clusters: the widths whose plan has one (C=192 and 384)
    multicast = fb.fused_basic_block.multicast_launches
    assert multicast == sum(n for c, n in PER_FORWARD.items()
                            if fb.plan_for(c).cluster > 1), multicast

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
              "launches_per_forward": launches["tiled"],
              "multicast_launches_per_forward": multicast,
              "setup_s": setup_s,
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
    assert launches == {"tiled": 0, "stencil": 104, "rigid": 1,
                        "bn_act": BN_ACT_PER_FORWARD}, launches
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

def _label_line(car, score=None):
    """A KITTI label line in the writer's own number formats."""
    (x1, y1, x2, y2), (l, h, w), (x, y, z), ry, alpha = car
    line = (f"Car 0.0 0.0 {alpha:.6f} {x1:.6f} {y1:.6f} {x2:.6f} {y2:.6f} "
            f"{h:.6f} {w:.6f} {l:.6f} {x:.6f} {y:.6f} {z:.6f} {ry:.6f}")
    return line if score is None else line + f" {score:.8f}"


def _write_kitti(np, cb, png, root, pred_dir):
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
            f.write(png.encode(img))
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


def cli_phase(np, fb, st, tmp):
    """The port's inference CLI over a KITTI directory it writes under
    ``tmp``, stencil on.  Returns (its JSON row, the KITTI root, the
    detector txts' directory)."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.data import cuboid as cb
    from egonet_tpu_torch.data import png
    from egonet_tpu_torch.precision import _plausible_ls_stats
    from egonet_tpu_torch.tools import inference

    root, pred_dir = os.path.join(tmp, "KITTI"), os.path.join(tmp, "pred")
    frames = _write_kitti(np, cb, png, root, pred_dir)
    decode_s = []
    for name, img in frames.items():
        t0 = time.perf_counter()
        got = png.decode(os.path.join(root, "training", "image_2",
                                      name + ".png"))
        decode_s.append(time.perf_counter() - t0)
        assert np.array_equal(got, img), name
    ckpt, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "out")
    os.makedirs(ckpt)
    np.save(os.path.join(ckpt, "LS.npy"), _plausible_ls_stats())
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
    evaluator_phase(root, out, summary)
    stats = summary["image_store"]
    evaluation = summary["evaluation"]
    row = {"frames": N_FRAMES, "instances_per_path": n_gt,
            "launches": launches["stencil"],
            "tiled_launches": launches["tiled"], "cli_s": cli_s,
            "inference_s": summary["inference_s"],
            "crops_per_s": (n_gt + n_sub) / summary["inference_s"],
            "decoder": stats["decoder"],
            "cli_decode_ms_per_frame": 1e3 * stats["decode_s"]
            / max(stats["decodes"], 1),
            "png_decode_ms_per_frame": 1e3 * float(np.mean(decode_s)),
            "evaluated": evaluation is not None,
            "evaluator": summary["evaluator"],
            "orientation": [ln for ln in (evaluation or "").splitlines()
                            if "orientation AP" in ln]}
    return row, root, pred_dir


def evaluator_phase(root, out, summary):
    """The port's Python evaluator and the C++ binary on the CLI phase's
    submission: their R40 summary lines must be equal.  Also reports which
    evaluator the CLI ran and whether it wrote PR plots."""
    import shutil
    from egonet_tpu_torch.eval import kitti_eval as ke
    from egonet_tpu_torch.eval.native import ensure_evaluator
    label_dir = os.path.join(root, "training", "label_2")
    sub = os.path.join(out, "submission")
    py_dir = os.path.join(out, "submission_python")    # its own stats files
    shutil.copytree(os.path.join(sub, "data"), os.path.join(py_dir, "data"))
    t0 = time.perf_counter()
    py = ke.format_summary(ke.evaluate(label_dir, py_dir), "r40")
    py_s = time.perf_counter() - t0
    binary = ensure_evaluator()
    assert binary is not None, "the C++ evaluator could not be built"
    t0 = time.perf_counter()
    cpp = subprocess.run([binary, label_dir, sub], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    cpp_s = time.perf_counter() - t0
    py_r40 = py.splitlines()
    cpp_r40 = [ln for ln in cpp.splitlines() if " AP: " in ln]
    row = {"python_r40": py_r40, "cpp_r40": cpp_r40,
           "equal": sorted(py_r40) == sorted(cpp_r40),
           "python_s": py_s, "cpp_s": cpp_s,
           "cli_evaluator": summary["evaluator"],
           "plots_written": (None if summary["plots"] is None
                             else len(summary["plots"]))}
    print(json.dumps({"evaluator": row}), flush=True)
    assert py_r40 and row["equal"], (py_r40, cpp_r40)
    return row


def profile_phase(torch, fb, st, model, annot):
    """``torch.profiler`` over steady batches of the W48 slice (24 crops,
    bucket 32): 3 through the tiled kernel, then 1 through the stencil.
    Prints, per kernel, device ms per facade span and per category, the
    top 10 kernels, the idle share and the longest gaps, the same batches'
    untraced time (CUDA events) and the fused kernel's launches in the
    trace beside its wrapper's counter."""
    from egonet_tpu_torch.utils import profiling
    rows = {}
    for name, stencil, n, cat in (
            ("default", "0", 3, "fused_basic_block"),
            ("stencil", "1", 1, "fused_basic_block_stencil")):
        model.hrnet.prepare_inference(stencil=stencil)
        model.forward_annot_dict(annot)                     # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            model.forward_annot_dict(annot)
        end.record()
        end.synchronize()
        untraced = start.elapsed_time(end) / n
        with tempfile.TemporaryDirectory() as log_dir:
            with profiling.trace(log_dir, "cuda"):       # CUPTI set-up
                model.forward_annot_dict(annot)
            fb.fused_basic_block.launches = 0
            st.fused_basic_block_stencil.launches = 0
            with profiling.trace(log_dir, "cuda"):
                t0 = time.perf_counter()
                for _ in range(n):
                    model.forward_annot_dict(annot)
                traced = (time.perf_counter() - t0) * 1e3 / n
            s = profiling.summarize_trace(log_dir, iters=n)
        counter = (fb.fused_basic_block.launches if stencil == "0"
                   else st.fused_basic_block_stencil.launches) / n
        busy = s["idle"]["busy_ms"]
        rows[name] = {
            "batches": n, "instances": N_FRAMES * N_BOXES, "bucket": 32,
            "untraced_batch_ms": untraced, "traced_batch_ms": traced,
            "window_ms": s["window_ms"], "device_busy_ms": busy,
            "device_event_ms": s["total_ms"],
            "idle_share": s["idle"]["share"],
            "longest_gaps_ms": s["idle"]["gaps"],
            "by_span_ms": s["by_span"],
            "host_by_span_ms": s["host_by_span"],
            "span_sum_vs_busy": sum(s["by_span"].values()) / busy,
            "by_category_ms": dict(s["by_category"]),
            "launches_by_category": s["launches_by_category"],
            "top_kernels": [[k[:120], ms, c] for k, ms, c in s["by_kernel"]],
            "fused_ms_per_forward_in_trace": dict(s["by_category"]).get(cat),
            "fused_launches_per_forward_in_trace":
                s["launches_by_category"].get(cat, 0),
            "fused_launches_per_forward_counter": counter}
        print(json.dumps({"profile": {name: rows[name]}}), flush=True)
        print(s["text"], flush=True)
    model.hrnet.prepare_inference(stencil="0")
    for name, row in rows.items():
        assert row["fused_launches_per_forward_in_trace"] == 104 \
            == row["fused_launches_per_forward_counter"], (name, row)
        assert abs(row["span_sum_vs_busy"] - 1.0) <= 0.15, (name, row)
    return rows


def fixture_phase(torch, np, fb, st, here):
    """The port's full-width W48 on the card against the JAX package's fp32
    outputs (tests/data/torch_w48_fixture.npz, seeds 0 and 1, 6 instances
    each): fp32 with TF32 off, bf16 through the tiled kernel, bf16 through
    the stencil."""
    from egonet_tpu_torch import precision
    with np.load(os.path.join(here, "tests", "data",
                              "torch_w48_fixture.npz")) as f:
        fix = {k: f[k] for k in f.files}
    seeds, n = [int(v) for v in fix["seeds"]], int(fix["n_instances"])
    outs = {"fp32": [], "bf16_tiled": [], "bf16_stencil": []}
    launches = {k: [] for k in outs}
    for seed in seeds:
        for dtype, runs in ((torch.float32, (("fp32", "0"),)),
                            (torch.bfloat16, (("bf16_tiled", "0"),
                                              ("bf16_stencil", "1")))):
            model = precision.harness_model(dtype, seed, "cuda")
            for name, stencil in runs:
                model.hrnet.prepare_inference(stencil=stencil)
                fb.fused_basic_block.launches = 0
                st.fused_basic_block_stencil.launches = 0
                outs[name].append(precision.harness_outputs(model, n, seed))
                launches[name].append(
                    (fb.fused_basic_block.launches,
                     st.fused_basic_block_stencil.launches))
            del model
    ref = {k: fix[k].astype(np.float64) for k in
           ("kpts", "lifter", "euler", "alpha", "logits", "maps_rms")}
    row = {"seeds": seeds, "instances_per_seed": n}
    for name, per_seed in outs.items():
        stacked = {k: np.stack([o[k] for o in per_seed]) for k in ref}
        row[name] = precision.fixture_gaps(stacked, ref)
        row[name]["launches_tiled_stencil"] = launches[name]
        for k, v in stacked.items():
            assert np.isfinite(v).all(), (name, k)
    rel = ("max_rel_d_logits", "max_rel_d_maps_rms")
    row["bars"] = {"fp32": {"max_d_kpts_px": FIXTURE_FP32_KPTS_PX,
                            "max_d_ry_rad": FIXTURE_FP32_RY_RAD,
                            **{k: FIXTURE_FP32_REL for k in rel}},
                   "bf16": {"median_d_ry_deg": 0.5,
                            "median_d_alpha_deg": 0.5,
                            **{k: FIXTURE_BF16_REL for k in rel}}}
    print(json.dumps({"fixture": row}), flush=True)
    assert all(x == (0, 0) for x in launches["fp32"]), launches
    assert all(x == (104, 0) for x in launches["bf16_tiled"]), launches
    assert all(x == (0, 104) for x in launches["bf16_stencil"]), launches
    g = row["fp32"]
    assert g["max_d_kpts_px"] <= FIXTURE_FP32_KPTS_PX, g
    assert np.radians(g["max_d_ry_deg"]) <= FIXTURE_FP32_RY_RAD, g
    assert all(g[k] <= FIXTURE_FP32_REL for k in rel), g
    for name in ("bf16_tiled", "bf16_stencil"):
        assert row[name]["median_d_ry_deg"] < 0.5, row[name]
        assert row[name]["median_d_alpha_deg"] < 0.5, row[name]
        assert all(row[name][k] <= FIXTURE_BF16_REL for k in rel), row[name]
    return row


def _quiet_json(fn, *args, **kwargs):
    """Call an entry point that prints one JSON line; return its result
    with that line kept off the output (the caller prints it wrapped)."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def bench_phase():
    """The port's bench: the device program at batch 32, 128 and 384 (the
    median of 5 windows of 20 batches each), the e2e loop at its defaults
    (32 frames, 2 epochs a window, 5 windows)."""
    from egonet_tpu_torch.tools import bench
    os.environ["BENCH_BATCH"] = "32,128,384"
    line = _quiet_json(bench.main, device="cuda")
    print(json.dumps({"bench": line, "cuts": []}), flush=True)
    return line


def drift_phase():
    """``tools/precision_drift``: bf16 against fp32 through the default
    kernel, 6 instances."""
    from egonet_tpu_torch.tools import precision_drift
    line = _quiet_json(precision_drift.main, ["6"], device="cuda")
    print(json.dumps({"drift": line}), flush=True)
    return line


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

# ---------------------------------------------------------------------------
# the training phases, on the CLI phase's KITTI directory
# ---------------------------------------------------------------------------

def _write_train_split(np, root):
    """N_TRAIN_FRAMES more labelled frames of 375x1242 with N_TRAIN_BOXES
    cars each (PNGs, labels, calibrations) and the train split list."""
    from egonet_tpu_torch.data import cuboid as cb
    from egonet_tpu_torch.data import png
    rng = np.random.RandomState(5)
    K = np.array([[721.5, 0.0, 609.6], [0.0, 721.5, 172.9], [0.0, 0.0, 1.0]])
    P = np.hstack([K, (K @ np.array([0.06, 0.0, 0.0]))[:, None]])
    train = os.path.join(root, "training")
    names = [f"{N_FRAMES + i:06d}" for i in range(N_TRAIN_FRAMES)]
    for name in names:
        cars = []
        for _ in range(N_TRAIN_BOXES):
            dims = (rng.uniform(3.5, 4.5), rng.uniform(1.4, 1.7),
                    rng.uniform(1.5, 1.8))
            loc = (rng.uniform(-6, 6), 1.65, rng.uniform(8, 30))
            ry = rng.uniform(-np.pi, np.pi)
            uv = cb.project_3d_to_2d(cb.place_cuboid(
                cb.construct_box_3d(*dims, interpolate=False),
                [*loc, 0.0, ry, 0.0], np.array([0.06, 0.0, 0.0])), K)[:2]
            box = (max(uv[0].min(), 0.0), max(uv[1].min(), 0.0),
                   min(uv[0].max(), 1241.0), min(uv[1].max(), 374.0))
            cars.append((box, dims, loc, ry, rng.uniform(-np.pi, np.pi)))
        img = rng.randint(0, 256, (375, 1242, 3), dtype=np.uint8)
        with open(os.path.join(train, "image_2", name + ".png"), "wb") as f:
            f.write(png.encode(img))
        with open(os.path.join(train, "label_2", name + ".txt"), "w") as f:
            f.write("\n".join(_label_line(c) for c in cars) + "\n")
        with open(os.path.join(train, "calib", name + ".txt"), "w") as f:
            f.write("P2: " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                    + "\n")
    with open(os.path.join(train, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def train_lifter_phase(torch, np, root, out, card):
    """``tools/train_lifting.main`` on the shipped lifting config (full
    width: 66 -> 1024 -> 96, 2 blocks, batch 2048, 100 augmentations a
    pose) for 3 epochs; L.pth and LS.npy must load strictly into the port's
    EgoNet."""
    from egonet_tpu_torch.config import demo_config, train_lifting_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.tools import train_lifting
    t0 = time.perf_counter()
    cfgs = train_lifting_config()
    cfgs["dataset"]["root"] = root
    cfgs["dirs"] = {"output": out}
    cfgs["training_settings"]["total_epochs"] = 3
    summary = _quiet_json(train_lifting.main, cfgs=cfgs)
    hist = summary["history"]
    dcfg = demo_config()
    dcfg["dirs"] = {"ckpt": summary["ckpt_dir"]}
    EgoNet(dcfg, pre_trained=True, device="cuda")      # strict loads
    row = {"card": card, "epochs": len(hist),
           "train_pairs": summary["train_pairs"],
           "valid_pairs": summary["valid_pairs"],
           "ms_per_epoch": [1e3 * h["seconds"] for h in hist],
           "samples_per_s": [summary["train_pairs"] / h["seconds"]
                             for h in hist],
           "loss": [h["loss"] for h in hist],
           "valid_mse": [h["valid_mse"] for h in hist],
           "strict_load": True, "seconds": time.perf_counter() - t0}
    print(json.dumps({"train_lifter": row}), flush=True)
    assert all(np.isfinite(row["loss"] + row["valid_mse"])), row
    return summary["ckpt_dir"]


def _fixed_batch_steps(torch, np, cfgs, dtype, n_steps=6):
    """One warm step, then ``n_steps`` IGR train steps on one fixed batch
    of the train split (24 frames, padded to MAX_INS_CNT crops), each
    timed with CUDA events (the host batch's copy included)."""
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.train.igrs import IGRTrainer
    records = kitti.KITTIDataset(cfgs, "train").records
    batch = next(IGRBatchLoader(records, cfgs, train=True, seed=0).epoch())
    real, padded = batch["meta"]["count"], len(batch["mask"])
    trainer = IGRTrainer(cfgs, dtype=dtype, device="cuda")
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = trainer.train_step(state, batch)
    losses, events = [m["loss"]], []
    for _ in range(n_steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trainer.train_step(state, batch)
        b.record()
        events.append((a, b))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(x) for x in losses]
    row = {"frames": len(batch["images"]), "real_crops": real,
           "padded_crops": padded, "ms": ms,
           "real_crops_per_s": [1e3 * real / t for t in ms],
           "padded_crops_per_s": [1e3 * padded / t for t in ms],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": losses}
    del trainer, state
    torch.cuda.empty_cache()
    assert np.isfinite(losses).all(), row
    assert losses[-1] < losses[0], row
    return row


def _train_fixture_row(torch, np, here):
    """The port's fp32 step (TF32 off) at full width against the JAX
    package's (tests/data/torch_train_fixture.npz)."""
    from egonet_tpu_torch import precision
    from egonet_tpu_torch.config import train_igrs_config
    from egonet_tpu_torch.train.igrs import IGRTrainer
    with np.load(os.path.join(here, "tests", "data",
                              "torch_train_fixture.npz")) as f:
        ref = {k: f[k] for k in f.files if not k.startswith("f64/")}
    for k in ("loss", "hm", "coor"):
        ref[k] = float(ref[k])
    cfgs = train_igrs_config()
    trainer = IGRTrainer(cfgs, device="cuda")
    state = trainer.init_state(0)
    out = precision.train_step_outputs(
        trainer, state, precision.train_fixture_batch(cfgs, 2, 0))
    gaps = precision.train_gaps(out, ref)
    del trainer, state
    torch.cuda.empty_cache()
    return {"gaps": gaps, "bars": TRAIN_FIXTURE_BARS,
            "ok": all(v <= TRAIN_FIXTURE_BARS[k] for k, v in gaps.items())}


def train_igrs_phase(torch, np, here, root, pred_dir, ckpt_dir, out, card):
    """The shipped IGR config at full W48 width (24 frames a batch, padded
    to 140 crops): a fixed batch's steps in fp32 (TF32 off) and bf16, the
    fp32 step against the JAX fixture, ``tools/train_igrs.main`` for 6
    steps in each dtype (the fp32 HC.pth joins the lifter's L.pth / LS.npy
    in ``ckpt_dir``), the inference CLI over the valid split on those
    files, and ``tools/profile_model --train``'s split of one bf16
    step."""
    from egonet_tpu_torch.config import demo_config, train_igrs_config
    from egonet_tpu_torch.ops import fused_block as fb
    from egonet_tpu_torch.tools import inference, profile_model, train_igrs
    from egonet_tpu_torch.utils import profiling
    t0 = time.perf_counter()
    row = {"card": card}
    cfgs = train_igrs_config()
    cfgs["dataset"]["root"] = root
    cfgs["heatmapModel"]["pretrained"] = ""
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        row[f"fixed_batch_{name}"] = _fixed_batch_steps(torch, np, cfgs,
                                                        dtype)
    row["fixture_fp32"] = _train_fixture_row(torch, np, here)
    row["fixed_batch_s"] = time.perf_counter() - t0

    for name, bf16 in (("bf16", True), ("fp32", False)):
        t1 = time.perf_counter()
        run = copy.deepcopy(cfgs)
        run["bf16"] = bf16
        run["dirs"] = {"output": out if not bf16 else out + "_bf16"}
        run["training_settings"]["total_epochs"] = N_TRAIN_STEPS
        summary = train_igrs.main(cfgs=run)
        hist = summary["history"]
        row[f"main_{name}"] = {
            "steps": len(hist), "loss": [h["loss"] for h in hist],
            "ms_per_step": [1e3 * h["seconds"] for h in hist],
            # each step's wall time by what the host did: waiting for the
            # loader's batch, launching and waiting for the step, debug grids
            "ms_split": [{k: 1e3 * v for k, v in h["split"].items()}
                         for h in hist],
            "debug_grids": len(os.listdir(os.path.join(
                summary["ckpt_dir"], "debug"))),
            "seconds": time.perf_counter() - t1}
        assert np.isfinite(row[f"main_{name}"]["loss"]).all(), row
        torch.cuda.empty_cache()
    assert summary["ckpt_dir"] == ckpt_dir, (summary["ckpt_dir"], ckpt_dir)

    t1 = time.perf_counter()
    dcfg = demo_config()
    dcfg["dataset"]["root"] = root
    dcfg["dirs"] = {"output": os.path.join(out, "inference"),
                    "ckpt": ckpt_dir, "load_prediction_file": pred_dir}
    dcfg["pre_trained"] = True                # HC.pth, L.pth, LS.npy
    fb.fused_basic_block.launches = 0
    summary = inference.main(cfgs=dcfg)
    launches = fb.fused_basic_block.launches
    frames = [f"{i:06d}" for i in range(N_FRAMES)]
    n = _check_txts(np, os.path.join(dcfg["dirs"]["output"], "submission",
                                     "data"), pred_dir, frames,
                    has_score=True)
    row["closed_loop"] = {
        "instances": n, "tiled_launches": launches,
        "evaluator": summary["evaluator"],
        "orientation": [ln for ln in summary["evaluation"].splitlines()
                        if "orientation AP" in ln],
        "seconds": time.perf_counter() - t1}
    assert launches == 104 * 2 * N_FRAMES, launches
    assert n == N_FRAMES * N_BOXES, n
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    prof = _quiet_json(profile_model.main,
                       ["--train", "--iters", "2", "--trace-dir",
                        os.path.join(out, "profile")], device="cuda")
    row["profile_train_bf16"] = {
        "device_ms": prof["total_ms"], "window_ms": prof["window_ms"],
        "device_ms_by_span": prof["by_span"],
        "host_ms_by_span": prof["host_by_span"],
        "launches": sum(prof["launches_by_category"].values()),
        "launches_by_category": prof["launches_by_category"],
        "idle_share": prof["idle"]["share"],
        "top_kernels": [(k[:80], ms, n) for k, ms, n in prof["by_kernel"][:5]],
        "seconds": time.perf_counter() - t1}
    spans = sum(prof["by_span"][s] for s in profiling.TRAIN_SPANS)
    row["profile_train_bf16"]["spans_share_of_busy"] = \
        spans / prof["total_ms"]
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_igrs": row}), flush=True)
    assert row["fixture_fp32"]["ok"], row["fixture_fp32"]
    return row


# ---------------------------------------------------------------------------
# the W32 pedestrian widths: both kernels at the shapes they meet there
# ---------------------------------------------------------------------------

def ped_sweeps(fb, st):
    """({C: [(tile, plan)]} of the tiled kernel's PED_ALT_TILES that fit,
    {C: [plan]} of PED_STENCIL_SWEEP's other than the chosen one)."""
    tiled = {c: [(t, fb.plan_for(c, t)) for t in PED_ALT_TILES[c]
                 if fb.tile_fits(c, t)
                 and fb.plan_for(c, t) != fb.plan_for(c)]
             for c, _ in PED_SHAPES}
    stencil = {c: [st.plan_for(c, t) for t in PED_STENCIL_SWEEP[c]
                   if st.tile_fits(c, t) and st.plan_for(c, t)
                   != st.plan_for(c)] for c, _ in PED_SHAPES}
    return tiled, stencil


def kernel_ped_phase(torch, fb, st, tiled_sweep, tiled_lib, stencil_sweep,
                     stencil_lib):
    """Both kernels at the W32 pedestrian shapes (C, H) in PED_SHAPES,
    batch 32: each held against its plain version (one bf16 step, atol
    5e-2 / rtol 2e-2) and timed beside it, the cuDNN convs, the bound and
    every other tile / plan of the sweeps (each also checked); then
    checked at odd batches.  Returns {kernel: [row per shape]}."""
    rows = {"fused_basic_block": [], "fused_basic_block_stencil": []}
    g = torch.Generator(device="cuda").manual_seed(2)
    for c, h in PED_SHAPES:
        x, (w1, b1, w2, b2) = _block_inputs(torch, fb, g, c, h, BATCH)
        ref = fb.fused_basic_block_reference(x, w1, b1, w2, b2)
        library = _library_block(torch, x, w1, b1, w2, b2)
        lib_y = library().permute(0, 2, 3, 1)
        torch.testing.assert_close(lib_y.float(), ref.float(), atol=0.25,
                                   rtol=5e-2)
        ops_ms, bytes_ms = _bound(c, h, h)
        plain_ms = _time_ms(torch, lambda: fb.fused_basic_block_reference(
            x, w1, b1, w2, b2), iters=5)
        library_ms = _time_ms(torch, library)
        for name, mod, wrapper, alts in (
                ("fused_basic_block", fb, fb.fused_basic_block,
                 [(_tile_name(t), direct(torch, fb, p, tiled_lib))
                  for t, p in tiled_sweep[c]]),
                ("fused_basic_block_stencil", st,
                 st.fused_basic_block_stencil,
                 [(_plan_name(p), direct(torch, st, p, stencil_lib))
                  for p in stencil_sweep[c]])):
            def kernel(launch=None, wrapper=wrapper):
                if launch is None:
                    return wrapper(x, w1, b1, w2, b2)
                return launch(x, w1, b1, w2, b2)
            for launch in [None] + [a for _, a in alts]:
                y = kernel(launch)
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), ref.float(),
                                           atol=5e-2, rtol=2e-2)
            y = kernel()
            torch.cuda.synchronize()
            assert torch.isfinite(y.float()).all()
            for b in PED_ODD_BATCHES:
                xo = x[:b].contiguous()
                yo = wrapper(xo, w1, b1, w2, b2)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    yo.float(), fb.fused_basic_block_reference(
                        xo, w1, b1, w2, b2).float(), atol=5e-2, rtol=2e-2)
            plan = mod.plan_for(c)
            default = direct(torch, mod, plan)
            row = {"shape": {"C": c, "H": h, "W": h, "B": BATCH},
                   "tile": list(mod.tile_for(c)),
                   "max_abs_err": (y.float() - ref.float()).abs().max()
                   .item(),
                   "ms": _time_ms(torch, lambda d=default: kernel(d)),
                   "op_ms": _time_ms(torch, kernel), "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "alt_ms": {n: _time_ms(torch, lambda a=a: kernel(a),
                                          iters=10) for n, a in alts},
                   "odd_batches_checked": list(PED_ODD_BATCHES),
                   "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                   "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes"}
            if name == "fused_basic_block_stencil":
                row["plan"] = _plan_summary(st, plan, st.library())
            print(json.dumps({"kernel_ped": {name: row}}), flush=True)
            rows[name].append(row)
    return rows


# ---------------------------------------------------------------------------
# the other model families and options
# ---------------------------------------------------------------------------

def _slice_model(torch, cfgs, dtype=None):
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.precision import _plausible_ls_stats
    model = EgoNet(cfgs, dtype=dtype, device="cuda")
    model.load_state(ls_stats=_plausible_ls_stats())
    return model


def _trace_spans(torch, model, annot, n=1):
    """Device ms per facade span (and the idle share) of ``n`` traced
    batches after a warm one."""
    from egonet_tpu_torch.utils import profiling
    model.forward_annot_dict(annot)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir, "cuda"):
            for _ in range(n):
                model.forward_annot_dict(annot)
        s = profiling.summarize_trace(log_dir, iters=n)
    return {"device_ms_by_span": s["by_span"],
            "device_busy_ms": s["idle"]["busy_ms"],
            "idle_share": s["idle"]["share"],
            "top_kernels": [[k[:80], ms, c] for k, ms, c in
                            s["by_kernel"][:5]]}


# PoseNetTPU's batch norms at its defaults, each one bn_act launch a
# forward in bf16 inference
NATIVE_BN_ACT_PER_FORWARD = 62


def native_phase(torch, np, fb, st, here, annot):
    """PoseNetTPU at its defaults (the root bench's native family: the demo
    config with ``heatmapModel.name: tpu_native`` and ``extra: {}``), full
    width, bf16, on the slice's 24 crops (bucket 32): no fused-block
    launch, NATIVE_BN_ACT_PER_FORWARD bn_act launches, bf16 against the same model in fp32 (median |d ry| < 0.5 deg),
    crops/s, device ms per span from one trace; then the fp32 and bf16
    harness against tests/data/torch_native_fixture.npz."""
    from egonet_tpu_torch import precision
    from egonet_tpu_torch.config import native_demo_config
    t0 = time.perf_counter()
    model = _slice_model(torch, native_demo_config())
    assert model.dtype == torch.bfloat16
    with tempfile.TemporaryDirectory() as out_dir:
        records, launches, first_s = _drive(torch, model, annot, fb, st,
                                            out_dir)
    assert launches == {"tiled": 0, "stencil": 0, "rigid": 1,
                        "bn_act": NATIVE_BN_ACT_PER_FORWARD}, launches
    ry = _ry(np, records)
    assert np.isfinite(ry).all()
    model32 = _slice_model(torch, native_demo_config(), torch.float32)
    ry32 = _ry(np, model32.forward_annot_dict(annot))
    del model32
    d_ry = _d_deg(np, ry, ry32)
    steady_s = _steady_s(torch, model, annot)
    row = {"instances": N_FRAMES * N_BOXES, "bucket": 32,
           "first_batch_s": first_s, "batch_s": steady_s,
           "crops_per_s": N_FRAMES * N_BOXES / steady_s,
           "median_d_ry_bf16_vs_fp32_deg": float(np.median(d_ry)),
           "max_d_ry_bf16_vs_fp32_deg": float(d_ry.max()),
           "profile": _trace_spans(torch, model, annot)}
    del model
    torch.cuda.empty_cache()
    with np.load(os.path.join(here, "tests", "data",
                              "torch_native_fixture.npz")) as f:
        fix = {k: f[k] for k in f.files}
    keys = ("kpts", "lifter", "euler", "alpha", "logits", "maps_rms")
    seeds, n = [int(v) for v in fix["seeds"]], int(fix["n_instances"])
    for name, dtype in (("fixture_fp32", torch.float32),
                        ("fixture_bf16", torch.bfloat16)):
        outs = [precision.harness_outputs(precision.harness_model(
            dtype, s, "cuda", native_demo_config()), n, s) for s in seeds]
        stacked = {k: np.stack([o[k] for o in outs]) for k in keys}
        for k, v in stacked.items():
            assert np.isfinite(v).all(), (name, k)
        row[name] = precision.fixture_gaps(
            stacked, {k: fix[k].astype(np.float64) for k in keys})
    row["fixture_bars"] = {
        "fp32": {"max_d_kpts_px": FIXTURE_FP32_KPTS_PX,
                 "max_d_ry_rad": FIXTURE_FP32_RY_RAD,
                 "max_rel_d_logits": FIXTURE_BF16_REL,
                 "max_rel_d_maps_rms": FIXTURE_BF16_REL},
        "bf16": {"median_d_ry_deg": 0.5}}
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps({"native": row}), flush=True)
    assert np.median(d_ry) < 0.5, row
    g = row["fixture_fp32"]
    assert g["max_d_kpts_px"] <= FIXTURE_FP32_KPTS_PX, g
    assert np.radians(g["max_d_ry_deg"]) <= FIXTURE_FP32_RY_RAD, g
    assert np.radians(g["max_d_alpha_deg"]) <= FIXTURE_FP32_RY_RAD, g
    assert g["max_rel_d_logits"] <= FIXTURE_BF16_REL, g
    assert row["fixture_bf16"]["median_d_ry_deg"] < 0.5, row
    torch.cuda.empty_cache()
    return row


def _train_row(torch, np, cfgs, card, **extra):
    """The fixed-batch steps in fp32 (TF32 off) and bf16."""
    row = {"card": card, **extra}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        row[name] = _fixed_batch_steps(torch, np, cfgs, dtype,
                                       n_steps=N_FAMILY_STEPS)
    return row


def train_native_phase(torch, np, root, card):
    """IGRTrainer steps of the shipped native config (KITTI_tpu_native.yml,
    full width) on one fixed batch of the train split."""
    from egonet_tpu_torch.config import tpu_native_config
    t0 = time.perf_counter()
    cfgs = tpu_native_config()
    cfgs["dataset"]["root"] = root
    row = _train_row(torch, np, cfgs, card)
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_native": row}), flush=True)
    return row


def _ped_demo_config():
    """The demo pipeline with the shipped W32 pedestrian keypoint model
    (KITTI_train_IGRs_Ped.yml's heatmapModel: 192x192 crops, 48x48
    heatmaps, widths 32/64/128/256)."""
    from egonet_tpu_torch.config import demo_config, train_igrs_ped_config
    cfgs = demo_config()
    cfgs["heatmapModel"] = train_igrs_ped_config()["heatmapModel"]
    cfgs["heatmapModel"]["pretrained"] = ""
    return cfgs


def train_ped_phase(torch, np, fb, st, root, annot, card):
    """The W32 pedestrian config: IGRTrainer steps on one fixed batch
    (192x192 crops, stem to stage2 frozen; the synthetic split holds cars,
    so ``detect_classes`` is Car), then its bf16 eval forward in the
    facade on the slice's frames through the tiled kernel, the stencil and
    unfused: 104 launches per forward of the chosen kernel, |d ry|
    between the three."""
    from egonet_tpu_torch.config import train_igrs_ped_config
    t0 = time.perf_counter()
    cfgs = train_igrs_ped_config()
    cfgs["dataset"]["root"] = root
    cfgs["dataset"]["detect_classes"] = ["Car"]
    cfgs["heatmapModel"]["pretrained"] = ""
    row = _train_row(torch, np, cfgs, card, classes=["Car"],
                     frozen=cfgs["heatmapModel"]["extra"]["freeze_layers"])
    model = _slice_model(torch, _ped_demo_config())
    ry, launches = {}, {}
    for name, stencil in (("tiled", "0"), ("stencil", "1")):
        model.hrnet.prepare_inference(stencil=stencil)
        with tempfile.TemporaryDirectory() as out_dir:
            records, launches[name], _ = _drive(torch, model, annot, fb, st,
                                                out_dir)
        ry[name] = _ry(np, records)
        row[f"{name}_crops_per_s"] = N_FRAMES * N_BOXES / _steady_s(
            torch, model, annot, iters=5)
    model.hrnet.prepare_inference(stencil="0")
    model.hrnet.fuse_blocks = False
    fb.fused_basic_block.launches = 0
    ry["unfused"] = _ry(np, model.forward_annot_dict(annot))
    assert fb.fused_basic_block.launches == 0
    row["unfused_crops_per_s"] = N_FRAMES * N_BOXES / _steady_s(
        torch, model, annot, iters=5)
    del model
    torch.cuda.empty_cache()
    row["eval_launches"] = launches
    for a, b in (("tiled", "unfused"), ("stencil", "unfused"),
                 ("stencil", "tiled")):
        d = _d_deg(np, ry[a], ry[b])
        row[f"d_ry_{a}_vs_{b}_deg"] = {"median": float(np.median(d)),
                                       "max": float(d.max())}
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_ped": row}), flush=True)
    bn = BN_ACT_PER_FORWARD
    assert launches == {
        "tiled": {"tiled": 104, "stencil": 0, "rigid": 1, "bn_act": bn},
        "stencil": {"tiled": 0, "stencil": 104, "rigid": 1, "bn_act": bn}
    }, launches
    for k in ("d_ry_tiled_vs_unfused_deg", "d_ry_stencil_vs_unfused_deg",
              "d_ry_stencil_vs_tiled_deg"):
        assert row[k]["median"] < 0.5, row
    return row


def _angle_steps(torch, np, root, n_steps=3):
    """One warm and ``n_steps`` AngleTrainer steps ('baselinealpha') of the
    W48 'angleregression' head at full width, bf16, on one fixed batch of
    the train split."""
    from egonet_tpu_torch.config import train_igrs_config
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.train.angle import AngleBatchLoader, AngleTrainer
    cfgs = train_igrs_config()
    cfgs["dataset"]["root"] = root
    cfgs["exp_type"] = "baselinealpha"
    cfgs["heatmapModel"].update(head_type="angleregression", pretrained="")
    records = kitti.KITTIDataset(cfgs, "train").records
    batch = next(AngleBatchLoader(records, cfgs, train=True, seed=0,
                                  angle_index=0).epoch())
    trainer = AngleTrainer(cfgs, dtype=torch.bfloat16, device="cuda")
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(n_steps + 1):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
    err = trainer.evaluate(state, kitti.KITTIDataset(cfgs, "valid").records)
    row = {"real_crops": batch["meta"]["count"],
           "padded_crops": len(batch["mask"]), "loss": losses,
           "ms_incl_loss_read": ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "valid_angle_error_deg": err}
    del trainer, state
    torch.cuda.empty_cache()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], row
    return row


def options_phase(torch, np, fb, st, annot, ry_w48, root, card):
    """The W48 slice with ``act_quant: int8`` and with ``fuse_merge: true``
    against the plain W48 (|d ry|, crops/s); the 'heatmap' head (with
    ``pixel_shuffle``) and the 'angleregression' head forwards at W48,
    bf16; AngleTrainer steps at full W48 width; one PoseResNet-50 forward
    (:func:`pose_resnet_forward`: shape, finiteness, bn_act launches)."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.init import numpy_init
    t0 = time.perf_counter()
    row = {"card": card}
    for name, key, value in (("act_quant_int8", "act_quant", "int8"),
                             ("fuse_merge", "fuse_merge", True)):
        cfgs = demo_config()
        cfgs["heatmapModel"][key] = value
        model = _slice_model(torch, cfgs)
        with tempfile.TemporaryDirectory() as out_dir:
            records, launches, _ = _drive(torch, model, annot, fb, st,
                                          out_dir)
        d = _d_deg(np, _ry(np, records), ry_w48)
        row[name] = {"launches": launches,
                     "median_d_ry_vs_w48_deg": float(np.median(d)),
                     "max_d_ry_vs_w48_deg": float(d.max()),
                     "crops_per_s": N_FRAMES * N_BOXES / _steady_s(
                         torch, model, annot, iters=5)}
        del model
        torch.cuda.empty_cache()
        assert launches == {"tiled": 104, "stencil": 0, "rigid": 1,
                            "bn_act": BN_ACT_PER_FORWARD}, \
            (name, launches)
    x = torch.randn(N_FRAMES * N_BOXES, 3, 256, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    heads = (("heatmap_pixel_shuffle", {"head_type": "heatmap",
                                        "pixel_shuffle": True},
              (N_FRAMES * N_BOXES, 33, 64, 64)),
             ("angleregression", {"head_type": "angleregression"},
              (N_FRAMES * N_BOXES, 2)))
    for name, update, shape in heads:
        cfgs = demo_config()
        cfgs["heatmapModel"].update(update)
        net = numpy_init(build_heatmap_model(cfgs, torch.bfloat16), 0)
        net = net.to("cuda", memory_format=torch.channels_last).eval()
        fb.fused_basic_block.launches = 0
        with torch.inference_mode():
            out = net(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            net(x)
            torch.cuda.synchronize()
        row[name] = {"shape": list(out.shape),
                     "forward_ms": 1e3 * (time.perf_counter() - t1),
                     "launches_per_forward": fb.fused_basic_block.launches
                     // 2}
        assert tuple(out.shape) == shape and torch.isfinite(out).all(), \
            (name, out.shape)
        assert row[name]["launches_per_forward"] == 104, row[name]
        del net
    row["angle_trainer_w48_bf16"] = _angle_steps(torch, np, root)
    row["pose_resnet50"] = pose_resnet_forward(torch, x)
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps({"options": row}), flush=True)
    return row


# PoseResNet's batch norms a bf16 inference forward, each one bn_act launch
# (the stem, three a bottleneck, the shortcuts, one after each deconv)
POSE_RESNET_BN_ACT = {50: 56, 152: 158}


def pose_resnet_forward(torch, x, num_layers=50):
    """PoseResNet (``num_layers`` deep, the published head) in bf16 on the
    card, eval, on crops ``x`` [N, 3, 256, 256]: [N, 33, 64, 64] finite
    heatmaps, and POSE_RESNET_BN_ACT bn_act launches a forward."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.factory import build_heatmap_model
    from egonet_tpu_torch.models.init import numpy_init
    from egonet_tpu_torch.ops.bn_act import bn_act
    cfgs = demo_config()
    cfgs["heatmapModel"].update(name="resnet", num_layers=num_layers,
                                extra={})
    net = numpy_init(build_heatmap_model(cfgs, torch.bfloat16), 0)
    net = net.to("cuda", memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        net(x)
        bn_act.launches = 0
        out = net(x)
        torch.cuda.synchronize()
    row = {"shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
           "bn_act_launches_per_forward": bn_act.launches}
    del net, out
    torch.cuda.empty_cache()
    assert row["shape"] == [x.shape[0], 33, 64, 64] and row["finite"], row
    assert row["bn_act_launches_per_forward"] == \
        POSE_RESNET_BN_ACT[num_layers], row
    return row


# ---------------------------------------------------------------------------
# the serving and export phases
# ---------------------------------------------------------------------------

# bench_serve's workload; the stencil's short pass takes the first requests
SERVE_REQUESTS, SERVE_BOXES, SERVE_WORKERS, SERVE_FRAMES = 128, 6, 16, 16
SERVE_WAIT_MS, STENCIL_SERVE_REQUESTS = 80.0, 32
# served against offline bf16 (other bucket and transport): the JAX
# package's bf16 budget
SERVE_MEDIAN_DEG, SERVE_MAX_DEG = 0.05, 0.5
EXPORT_BUCKETS = (16, 128)
EXPORT_ANGLE_RAD = 1e-3


def _server(model):
    from egonet_tpu_torch.serving import PoseServer
    return PoseServer(model, port=0, max_images=16,
                      max_wait_ms=SERVE_WAIT_MS).start()


def _serve_pass(torch, fb, st, server, payloads, settle, n_single):
    """A started PoseServer, warmed, driven by bench_serve.run, both
    kernels' launch counts set to 0 just before and read just after, then
    stopped.  Returns (the line, the timed pass's responses, {"tiled": n,
    "stencil": n} over the whole run, batches over the whole run, warmup
    seconds)."""
    from egonet_tpu_torch.tools import bench_serve
    try:
        t0 = time.perf_counter()
        server.warmup()
        warm_s = time.perf_counter() - t0
        b0 = server.batcher.stats["batches"]
        fb.fused_basic_block.launches = 0
        st.fused_basic_block_stencil.launches = 0
        line, bodies = bench_serve.run(server, payloads, SERVE_WORKERS,
                                       settle=settle, n_single=n_single)
        launches = {"tiled": fb.fused_basic_block.launches,
                    "stencil": st.fused_basic_block_stencil.launches}
        batches = server.batcher.stats["batches"] - b0
    finally:
        server.stop()
    return line, bodies, launches, batches, warm_s


def _served_vs_offline(np, model, payloads, bodies):
    """|d ry| and |d alpha| (deg) of every served instance against the
    offline facade (``EgoNet.__call__``) on the same frame and boxes, 16
    requests a call, each under a key of its own."""
    d_ry, d_alpha = [], []
    for start in range(0, len(payloads), 16):
        chunk = range(start, min(start + 16, len(payloads)))
        annot = {"path": [f"{i}" for i in chunk],
                 "images": [model.load_image(payloads[i]["image_path"])
                            for i in chunk],
                 "boxes": [np.asarray(payloads[i]["boxes"]) for i in chunk],
                 "K": [np.asarray(payloads[i]["K"]) for i in chunk]}
        records = model(annot)
        for i in chunk:
            rec, inst = records[f"{i}"], bodies[i]["instances"]
            d_ry.append(_d_deg(np, np.asarray([x["rot_y"] for x in inst]),
                               rec["euler_angles"][:, 1]))
            d_alpha.append(_d_deg(np, np.asarray([x["alpha"] for x in inst]),
                                  rec["alphas"]))
    d_ry, d_alpha = np.concatenate(d_ry), np.concatenate(d_alpha)
    row = {"median_d_ry_deg": float(np.median(d_ry)),
           "max_d_ry_deg": float(d_ry.max()),
           "median_d_alpha_deg": float(np.median(d_alpha)),
           "max_d_alpha_deg": float(d_alpha.max())}
    for key in ("ry", "alpha"):
        assert row[f"median_d_{key}_deg"] < SERVE_MEDIAN_DEG, row
        assert row[f"max_d_{key}_deg"] < SERVE_MAX_DEG, row
    return row


def serve_phase(torch, np, fb, st, card):
    """bench_serve's workload in-process on the W48 demo config at full
    width (bf16, seeded random weights, the precision harness's LS stats)
    on the card: a PoseServer answers the settle passes, the timed pass of
    128 requests and 12 single-stream requests, every tiled launch counted
    (104 per served micro-batch); every timed response is held against
    the offline facade.  Then a 32-request pass with the stencil selected
    (104 stencil launches per batch, the same bar) and one pass of the
    native family through the same server (no fused launch)."""
    from egonet_tpu_torch.config import demo_config, native_demo_config
    from egonet_tpu_torch.tools import bench_serve
    t_phase = time.perf_counter()
    model = _slice_model(torch, demo_config())
    with tempfile.TemporaryDirectory() as tmp:
        paths = bench_serve.make_frames(tmp, SERVE_FRAMES)
        payloads = bench_serve.make_payloads(paths, SERVE_REQUESTS,
                                             SERVE_BOXES)
        line, bodies, launches, batches, warm_s = _serve_pass(
            torch, fb, st, _server(model), payloads, settle=8, n_single=12)
        assert launches == {"tiled": 104 * batches, "stencil": 0}, (
            launches, batches)
        assert line["fused_launches"] == 104 * line["batches"] > 0, line
        row = {**line, "warmup_s": warm_s, "run_launches": launches,
               "run_batches": batches,
               "vs_offline": _served_vs_offline(np, model, payloads,
                                                bodies)}

        model.hrnet.prepare_inference(stencil="1")
        few = payloads[:STENCIL_SERVE_REQUESTS]
        sline, sbodies, slaunches, sbatches, _ = _serve_pass(
            torch, fb, st, _server(model), few, settle=0, n_single=0)
        assert slaunches == {"tiled": 0, "stencil": 104 * sbatches}, (
            slaunches, sbatches)
        row["stencil"] = {
            "requests": len(few), "req_per_s": sline["value"],
            "p50_ms": sline["p50_ms"], "max_ms": sline["max_ms"],
            "batches": sline["batches"], "launches": slaunches,
            "vs_offline": _served_vs_offline(np, model, few, sbodies)}
        model.hrnet.prepare_inference(stencil="0")
        del model
        torch.cuda.empty_cache()

        native = _slice_model(torch, native_demo_config())
        nline, nbodies, nlaunches, _, _ = _serve_pass(
            torch, fb, st, _server(native), payloads, settle=0, n_single=0)
        assert nlaunches == {"tiled": 0, "stencil": 0}, nlaunches
        assert all(np.isfinite([x["rot_y"] for x in b["instances"]]).all()
                   for b in nbodies)
        row["native"] = {"req_per_s": nline["value"],
                         "p50_ms": nline["p50_ms"],
                         "p90_ms": nline["p90_ms"],
                         "max_ms": nline["max_ms"],
                         "batches": nline["batches"]}
        del native
        torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    row["card"] = card
    print(json.dumps({"serve": row}), flush=True)
    return row


def _export_inputs(torch, np, annot, bucket, n_img=16, canvas_hw=(384, 1280)):
    """(images [n_img, 384, 1280, 3] u8, meta [bucket, 18]) on the card:
    the slice's frames on the canvases in turn and its boxes' crops over
    them, every row real."""
    from egonet_tpu_torch.models.egonet import pack_meta
    from egonet_tpu_torch.ops import affine
    images = np.zeros((n_img,) + tuple(canvas_hw) + (3,), np.uint8)
    for i in range(n_img):
        img = annot["images"][i % len(annot["images"])]
        images[i, :img.shape[0], :img.shape[1]] = img
    boxes = np.concatenate(annot["boxes"])
    idx = np.arange(bucket)
    mats = affine.crop_matrices_for_boxes(boxes[idx % len(boxes)], (256, 256),
                                          1.0, 1.1)
    K = annot["K"][0]
    meta = pack_meta(mats["inv"], idx % n_img, np.ones(bucket),
                     np.full(bucket, K[0, 0]), np.full(bucket, K[0, 2]),
                     np.tile([1242.0, 375.0], (bucket, 1)))
    return (torch.from_numpy(images).cuda(), torch.from_numpy(meta).cuda())


def _export_gap(torch, np, got, live):
    """Kpts in units of one bf16 step of the live value, angles (ry,
    alpha) in rad, between the exported and the live program's flat
    outputs."""
    got, live = got.double().cpu(), live.double().cpu()
    step = 2.0 ** (torch.floor(torch.log2(live[:, :66].abs().clamp_min(
        2.0 ** -6))) - 7)
    kpts_steps = float(((got[:, :66] - live[:, :66]).abs() / step).max())
    ang = (got[:, [162 + 1, 162 + 6]] - live[:, [162 + 1, 162 + 6]]).abs()
    ang = torch.minimum(ang % (2 * np.pi), 2 * np.pi - ang % (2 * np.pi))
    return kpts_steps, float(ang.max())


# the export phase's fresh interpreter: torch and io/export.py only, run
# from the artifact directory (argv: repo root, artifact dir, data dir)
FRESH_EXPORT = r"""
import ctypes, json, os, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from egonet_tpu_torch.io import export
out, data = sys.argv[2], sys.argv[3]
torch.backends.cudnn.allow_tf32 = False         # as the parent's run
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
programs, manifest = export.load_exported(out)
load_s = time.perf_counter() - t0
ckpt = torch.load(os.path.join(data, "ckpt.pt"))
counts = ctypes.CDLL(os.path.join(out, "libegonet_ops.so"))
counts.egonet_launches.restype = ctypes.c_int64
counts.egonet_set_launches.argtypes = [ctypes.c_int, ctypes.c_int64]
rows = {}
for b in sorted(programs):
    inp = torch.load(os.path.join(data, f"in_{b}.pt"))
    program = export.bind(programs[b], manifest, ckpt["hrnet"],
                          ckpt["lifter"], ckpt["ls"])
    with torch.inference_mode():
        counts.egonet_set_launches(0, 0)
        got = program(inp["images"], inp["meta"])
        torch.cuda.synchronize()
        launches = counts.egonet_launches(0)
        for _ in range(3):
            program(inp["images"], inp["meta"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            program(inp["images"], inp["meta"])
        end.record()
        torch.cuda.synchronize()
    torch.save(got.cpu(), os.path.join(data, f"out_{b}.pt"))
    rows[str(b)] = {"launches_per_call": launches,
                    "exported_ms": start.elapsed_time(end) / 10}
print(json.dumps({"load_s": load_s, "buckets": rows, "modules": sorted(
    m for m in sys.modules if m.startswith("egonet_tpu_torch"))}))
"""


def _fresh_export_leg(torch, model, out, inputs, live, here):
    """Run the artifact directory ``out`` in a fresh interpreter that
    imports torch and ``io/export.py`` only: each bucket bit-equal to the
    live ``_core`` outputs ``live`` on ``inputs``, 104 fused launches per
    call (the C++ counts of the directory's ``libegonet_ops.so``), and no
    module of ``egonet_tpu_torch.ops`` or ``egonet_tpu_torch.models``
    loaded."""
    with tempfile.TemporaryDirectory() as data:
        torch.save({"hrnet": model.hrnet.state_dict(),
                    "lifter": model.lifter.state_dict(),
                    "ls": {k: v.cpu() for k, v in model.ls_stats.items()}},
                   os.path.join(data, "ckpt.pt"))
        for b, (images, meta) in inputs.items():
            torch.save({"images": images, "meta": meta},
                       os.path.join(data, f"in_{b}.pt"))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", FRESH_EXPORT, here, out,
                              data], capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["process_s"] = time.perf_counter() - t0
        for b, want in live.items():
            got = torch.load(os.path.join(data, f"out_{b}.pt"))
            r = row["buckets"][str(b)]
            r["bit_equal"] = bool(torch.equal(got, want.cpu()))
            assert r["bit_equal"], b
            assert r["launches_per_call"] == 104, r
    bad = [m for m in row["modules"]
           if m.startswith(("egonet_tpu_torch.ops", "egonet_tpu_torch.models"))]
    assert not bad, bad
    return row


def export_phase(torch, np, fb, st, annot, card, here):
    """Export buckets 16 and 128 of the W48 ``_core`` on the card
    (``io/export.py``: weight-agnostic .pt2, 16 canvases of 384x1280, the
    operator libraries copied beside them), load them, lay in the live
    model's weights and hold each against the live ``_core`` on the same
    inputs (kpts within one bf16 step, angles 1e-3 rad): 104 fused-op
    nodes in each graph and 104 launches per call; then the same artifact
    directory in a fresh interpreter that imports torch and
    ``io/export.py`` only, bit-equal to live (:func:`_fresh_export_leg`);
    then a second seeded weight set laid into the same artifact against a
    live model built with it.  Times both programs per call (CUDA events
    over 10 calls after 3), and a kernel call's host cost through the
    wrapper, through the C++ operator alone and by a direct launch."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.io import export
    t_phase = time.perf_counter()
    model = _slice_model(torch, demo_config())
    row = {"buckets": {}, "card": card}
    ls = {k: v.cpu().numpy() for k, v in model.ls_stats.items()}
    inputs, live_out = {}, {}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        manifest = export.export_shape_set(model, out, buckets=EXPORT_BUCKETS)
        row["export_s"] = time.perf_counter() - t0
        row["op_libraries"] = manifest["op_libraries"]
        t0 = time.perf_counter()
        programs, loaded = export.load_exported(out)
        row["load_s"] = time.perf_counter() - t0
        for b in EXPORT_BUCKETS:
            entry = manifest["artifacts"][str(b)]
            assert entry["fused_nodes"] == 104, entry
            program = export.bind(programs[b], loaded,
                                  model.hrnet.state_dict(),
                                  model.lifter.state_dict(), ls)
            images, meta = inputs[b] = _export_inputs(torch, np, annot, b)
            with torch.inference_mode():
                live = live_out[b] = model._core(images, meta,
                                                 alpha_mode="proj")
                fb.fused_basic_block.launches = 0
                got = program(images, meta)
                torch.cuda.synchronize()
                launches = fb.fused_basic_block.launches
                assert launches == 104, launches
                kpts_steps, ang = _export_gap(torch, np, got, live)
                assert torch.isfinite(got).all()
                assert kpts_steps <= 1.0 and ang < EXPORT_ANGLE_RAD, (
                    kpts_steps, ang)
                live_ms = _time_ms(torch, lambda: model._core(
                    images, meta, alpha_mode="proj"), iters=10)
                exported_ms = _time_ms(torch, lambda: program(images, meta),
                                       iters=10)
            row["buckets"][str(b)] = {
                "bytes": entry["bytes"], "fused_nodes": entry["fused_nodes"],
                "launches_per_call": launches,
                "bit_equal": bool(torch.equal(got, live)),
                "kpts_bf16_steps": kpts_steps, "max_d_angle_rad": ang,
                "live_ms": live_ms, "exported_ms": exported_ms}
        row["fresh_interpreter"] = _fresh_export_leg(
            torch, model, out, inputs, live_out, here)
    # a second weight set through the bucket-16 artifact
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.precision import _plausible_ls_stats
    other = EgoNet(demo_config(), device="cuda", rng_seed=7)
    other.load_state(ls_stats=_plausible_ls_stats())
    program = export.bind(programs[16], loaded, other.hrnet.state_dict(),
                          other.lifter.state_dict(),
                          {k: v.cpu().numpy()
                           for k, v in other.ls_stats.items()})
    images, meta = _export_inputs(torch, np, annot, 16)
    with torch.inference_mode():
        kpts_steps, ang = _export_gap(
            torch, np, program(images, meta),
            other._core(images, meta, alpha_mode="proj"))
        first = model._core(images, meta, alpha_mode="proj")
        moved = float((first - other._core(images, meta,
                                           alpha_mode="proj")).abs().max())
    assert kpts_steps <= 1.0 and ang < EXPORT_ANGLE_RAD, (kpts_steps, ang)
    assert moved > 1.0, moved              # the weights did change
    row["second_weights"] = {"kpts_bf16_steps": kpts_steps,
                             "max_d_angle_rad": ang,
                             "max_d_vs_first_weights": moved}
    del other
    row["op_host_us"] = _op_overhead(torch, fb)
    row["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"export": row}), flush=True)
    del model
    torch.cuda.empty_cache()
    return row


def _op_overhead(torch, fb, n=500):
    """A tiled kernel call's host cost, at a block whose kernel takes a few
    microseconds (C=48, 8x8, one image: one thread block): through its
    wrapper (``op``: the Python wrapper and the C++ operator), through the
    C++ operator alone (``op_dispatch``: ``torch.ops.egonet.
    fused_basic_block.default``) and by a direct launch (``direct``:
    :func:`direct`, ctypes).  ``host_us``: microseconds per call of the host's loop of
    ``n`` calls, before the device is waited for (the launch queue holds
    them); ``wall_us``: per call up to the device's end (the kernel's
    own time bounds it from below)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x, (w1, b1, w2, b2) = _block_inputs(torch, fb, g, 48, 8, 1)
    launch = direct(torch, fb, fb.plan_for(48))
    op = torch.ops.egonet.fused_basic_block.default
    out = {"host_us": {}, "wall_us": {}}
    for name, fn in (("op", lambda: fb.fused_basic_block(x, w1, b1, w2, b2)),
                     ("op_dispatch", lambda: op(x, w1, b1, w2, b2)),
                     ("direct", lambda: launch(x, w1, b1, w2, b2))):
        with torch.inference_mode():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
        out["host_us"][name] = (t1 - t0) / n * 1e6
        out["wall_us"][name] = (time.perf_counter() - t0) / n * 1e6
    return out


# ---------------------------------------------------------------------------
# data parallelism and exact resume: the mesh, dp and resume phases
# ---------------------------------------------------------------------------

# the mesh phase: the W48 slice sharded over two shards of the one card
MESH_SHARDS = 2
MESH_SERVE_REQUESTS, MESH_SERVE_SETTLE = 32, 2
# the dp phase: the dry run's ranks (gloo, all on cuda:0) and budget; the
# one-rank nccl run skips the legs that compare ranks with one process
DP_RANKS, DP_BUDGET_S = 2, 900.0
# the resume phase: the native IGR CLI, epochs straight and the cut
RESUME_EPOCHS, RESUME_CUT, RESUME_BATCH = 3, 2, 4   # 6 steps an epoch


def _mesh_batch(torch, fb, st, model, annot):
    """One sharded batch, the kernels' launch counts set to 0 just before
    and read just after: (records, launches, rows of the padded batch)."""
    read = _launch_counts(fb, st)
    pending = model.dispatch_annot_dict(annot)
    records = model.finalize(pending)
    return records, read(), int(pending[0].shape[0])


def _gap_row(np, got, want):
    """|d ry| and |d alpha| (deg) of two record sets, held to the serve
    bars."""
    d_ry = _d_deg(np, _ry(np, got), _ry(np, want))
    d_al = _d_deg(np, np.concatenate([got[p]["alphas"] for p in got]),
                  np.concatenate([want[p]["alphas"] for p in got]))
    row = {"median_d_ry_deg": float(np.median(d_ry)),
           "max_d_ry_deg": float(d_ry.max()),
           "median_d_alpha_deg": float(np.median(d_al)),
           "max_d_alpha_deg": float(d_al.max())}
    for key in ("ry", "alpha"):
        assert row[f"median_d_{key}_deg"] <= SERVE_MEDIAN_DEG, row
        assert row[f"max_d_{key}_deg"] <= SERVE_MAX_DEG, row
    return row


def mesh_phase(torch, np, fb, st, annot, card):
    """The W48 slice (bf16, 4 frames x 6 boxes) through
    ``EgoNet(mesh=DataMesh([cuda:0, cuda:0]))``: two shards of 16 at
    bucket 32 on the one card, 104 tiled launches and one rigid_solve
    launch per shard by the counters (then 104 stencil launches per shard
    with the stencil selected), each held against the single-device
    facade on the same batch (the serve bars), and a dispatch of each
    facade under the sync debug mode (:func:`_sync_free`); then a served
    pass through a PoseServer over the same mesh, 104 tiled launches per
    shard of every micro-batch, every response held against the
    single-device facade."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.precision import _plausible_ls_stats
    from egonet_tpu_torch.tools import bench_serve
    t_phase = time.perf_counter()
    single = _slice_model(torch, demo_config())
    data_mesh = mesh.DataMesh(["cuda:0"] * MESH_SHARDS)
    sharded = EgoNet(demo_config(), mesh=data_mesh)
    sharded.load_state(ls_stats=_plausible_ls_stats())
    row = {"mesh": [str(d) for d in data_mesh], "shards": MESH_SHARDS,
           "note": "one card: the shards run one after the other on "
                   "cuda:0", "card": card}
    for path, flag in (("tiled", "0"), ("stencil", "1")):
        single.prepare_inference(stencil=flag)
        sharded.prepare_inference(stencil=flag)
        want = single(annot)
        records, launches, rows = _mesh_batch(torch, fb, st, sharded, annot)
        other = "stencil" if path == "tiled" else "tiled"
        assert rows == 32, rows
        assert launches == {path: 104 * MESH_SHARDS, other: 0,
                            "rigid": MESH_SHARDS,
                            "bn_act": BN_ACT_PER_FORWARD * MESH_SHARDS}, \
            launches
        n_inst = N_FRAMES * N_BOXES
        row[path] = {"bucket": rows, "launches": launches[path],
                     "launches_per_shard": launches[path] // MESH_SHARDS,
                     "rigid_launches_per_shard":
                         launches["rigid"] // MESH_SHARDS,
                     "vs_single": _gap_row(np, records, want),
                     # a dispatch of each facade under
                     # set_sync_debug_mode("error"): max |d ry| to single
                     "sync_free": {
                         "single": _gap_row(np, _sync_free(
                             torch, single, annot), want)["max_d_ry_deg"],
                         "sharded": _gap_row(np, _sync_free(
                             torch, sharded, annot), want)["max_d_ry_deg"]},
                     "crops_per_s": n_inst / _steady_s(torch, sharded,
                                                       annot),
                     "single_crops_per_s": n_inst / _steady_s(torch, single,
                                                              annot)}
    single.prepare_inference(stencil="0")
    sharded.prepare_inference(stencil="0")
    with tempfile.TemporaryDirectory() as tmp:
        paths = bench_serve.make_frames(tmp, SERVE_FRAMES)
        payloads = bench_serve.make_payloads(paths, MESH_SERVE_REQUESTS,
                                             SERVE_BOXES)
        line, bodies, launches, batches, _ = _serve_pass(
            torch, fb, st, _server(sharded), payloads,
            settle=MESH_SERVE_SETTLE, n_single=0)
        assert launches == {"tiled": 104 * MESH_SHARDS * batches,
                            "stencil": 0}, (launches, batches)
        row["serve"] = {"requests": len(payloads), "req_per_s": line["value"],
                        "p50_ms": line["p50_ms"], "max_ms": line["max_ms"],
                        "settle_passes": MESH_SERVE_SETTLE,
                        "timed_batches": line["batches"],
                        "batches": batches, "launches": launches["tiled"],
                        "vs_single": _served_vs_offline(np, single, payloads,
                                                        bodies)}
    del single, sharded
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"mesh": row}), flush=True)
    return row


def _dryrun(tmp, args, timeout_s):
    """``tools/dryrun_multigpu`` (its ranks spawned here, their leg lines on
    this output); returns rank 0's summary."""
    from egonet_tpu_torch.tools import dryrun_multigpu
    out = os.path.join(tmp, "dryrun.json")
    dryrun_multigpu.main(args + ["--out", out, "--timeout-s", str(timeout_s)])
    with open(out) as f:
        return json.load(f)


def dp_phase(card):
    """``tools/dryrun_multigpu`` with DP_RANKS ranks over gloo, all on
    cuda:0 (nccl refuses two ranks on one card; gloo reduces the CUDA
    tensors through the host), every leg admitted (the W48 legs at full
    width); then one rank over nccl, to prove that init path."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gloo = _dryrun(tmp, ["--nproc", str(DP_RANKS), "--backend", "gloo",
                             "--device", "cuda:0", "--budget-s",
                             str(DP_BUDGET_S)], 900)
        assert gloo["skipped"] == {} and len(gloo["legs"]) == 7, gloo
        nccl = _dryrun(tmp, ["--nproc", "1", "--backend", "nccl",
                             "--device", "cuda:0"], 300)
        assert nccl["backend"] == "nccl" and "sharded_train" in nccl["legs"]
        assert set(nccl["skipped"].values()) == {"one rank"}, nccl
    row = {"gloo": gloo, "nccl": nccl, "card": card,
           "note": f"{DP_RANKS} ranks on the one card (cuda:0)",
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"dp": row}), flush=True)
    return row


def _ckpt_tensors(torch, path):
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"model.{k}": v for k, v in payload["model"].items()}
    for i, st in payload["optimizer"]["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt.{i}.{k}"] = v
    return out, payload["step"]


def _w48_checkpoint(torch, tmp):
    """Save (asynchronously) and restore one full-state checkpoint of the
    shipped W48 IGR trainer in fp32 after one optimizer step (Adam's
    moments exist): seconds and bytes."""
    from egonet_tpu_torch.config import train_igrs_config
    from egonet_tpu_torch.io.train_ckpt import TrainCheckpointManager
    from egonet_tpu_torch.train.igrs import IGRTrainer
    cfgs = train_igrs_config()
    cfgs["heatmapModel"]["pretrained"] = ""
    trainer = IGRTrainer(cfgs, device="cuda")
    state = trainer.init_state(0)
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step = 1
    n_params = sum(p.numel() for p in state.model.parameters())
    with TrainCheckpointManager(os.path.join(tmp, "w48")) as mgr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, state)
        save_returned_s = time.perf_counter() - t0
        mgr.wait_until_finished()
        fresh = IGRTrainer(cfgs, device="cuda")
        template = fresh.init_state(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(template, step=1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rec = dict(mgr.saves[0])
    got = dict(template.model.state_dict())
    assert all(torch.equal(v, got[k])
               for k, v in state.model.state_dict().items())
    del trainer, state, fresh, template
    torch.cuda.empty_cache()
    return {"params": n_params, "bytes": rec["bytes"],
            "save_returned_s": save_returned_s, "host_copy_s": rec["copy_s"],
            "write_s": rec["write_s"], "restore_s": restore_s}


def resume_phase(torch, np, root, out, card):
    """``tools/train_igrs.main`` on the native config (bf16) over the train
    split, with ``exact_resume``: RESUME_CUT epochs, then the same command
    to RESUME_EPOCHS (resumed from the full-state checkpoint), against
    RESUME_EPOCHS straight, each as a user runs it (``exact_resume``
    switches the CLI to deterministic algorithms itself; the phase checks
    that the mode is off again after each run).  The two final
    full states (parameters, BN buffers, Adam moments, step) must be
    bit-equal; prints the largest gap if not.  Then one W48 full-state
    checkpoint's save and restore seconds and bytes, and how much of each
    asynchronous save the next epoch hid."""
    import warnings
    from egonet_tpu_torch.config import tpu_native_config
    from egonet_tpu_torch.tools import train_igrs
    t_phase = time.perf_counter()

    def run(name, epochs):
        cfgs = tpu_native_config()
        cfgs["dataset"]["root"] = root
        cfgs["dirs"] = {"output": os.path.join(out, name)}
        cfgs["bf16"] = True
        cfgs["heatmapModel"]["pretrained"] = ""
        cfgs["training_settings"].update(total_epochs=epochs,
                                         exact_resume=True,
                                         eval_during=False,
                                         batch_size=RESUME_BATCH)
        t0 = time.perf_counter()
        summary = train_igrs.main(cfgs=cfgs)
        summary["seconds"] = time.perf_counter() - t0
        assert not torch.are_deterministic_algorithms_enabled()
        return summary

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = run("cut", RESUME_CUT)
        resumed = run("cut", RESUME_EPOCHS)
        full = run("full", RESUME_EPOCHS)
    assert [h["epoch"] for h in resumed["history"]] == list(
        range(RESUME_CUT, RESUME_EPOCHS)), resumed["history"]
    a, step_a = _ckpt_tensors(torch, os.path.join(
        full["ckpt_dir"], "orbax", str(RESUME_EPOCHS)))
    b, step_b = _ckpt_tensors(torch, os.path.join(
        resumed["ckpt_dir"], "orbax", str(RESUME_EPOCHS)))
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:5]
    gaps = {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}
    row = {"config": "KITTI_tpu_native.yml, bf16",
           "epochs": RESUME_EPOCHS, "cut": RESUME_CUT,
           "steps": step_a, "tensors": len(a),
           "bit_equal": not gaps and step_a == step_b,
           "unequal_tensors": len(gaps),
           "max_gap": max(gaps.values()) if gaps else 0.0,
           "nondeterministic_ops": sorted({
               str(w.message).split(".")[0][:100] for w in caught
               if "deterministic" in str(w.message)}),
           "run_s": {"cut": first["seconds"], "resumed": resumed["seconds"],
                     "full": full["seconds"]},
           "saves": full["checkpoints"], "card": card}
    # the part of each asynchronous write the next epoch hid: the write's
    # seconds less those the next save (or the drain) waited for it
    row["overlap"] = [
        {"step": s["step"], "write_s": s["write_s"],
         "waited_s": s.get("wait_s", 0.0),
         "hidden_share": 1.0 - s.get("wait_s", 0.0) / s["write_s"]}
        for s in full["checkpoints"]]
    with tempfile.TemporaryDirectory() as tmp:
        row["w48_checkpoint"] = _w48_checkpoint(torch, tmp)
    row["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"resume": row}), flush=True)
    assert row["bit_equal"], {k: gaps[k] for k in sorted(
        gaps, key=gaps.get)[-5:]}
    return row


# the gate phase (tests/torch_gate.py): its shrunk HRNet (8/16/32/64 at a
# 64x64 input, one block a branch) fuses the blocks of width 16, 32 and 64
# on maps of 8, 4 and 2 (the width-8 ones run unfused); both kernels are
# checked there at a full bucket and at an odd batch
GATE_SHAPES = ((16, 8), (32, 4), (64, 2))
GATE_ODD_BATCH = 5


def _gate_kernel_rows(torch, fb, st):
    """Both kernels at the gate's block shapes: held against the plain
    version (one bf16 step) at batch BATCH and GATE_ODD_BATCH, timed
    beside it and the cuDNN convs at BATCH.  {kernel name: [rows]}."""
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = {"fused_basic_block": [], "fused_basic_block_stencil": []}
    for c, h in GATE_SHAPES:
        for batch in (GATE_ODD_BATCH, BATCH):
            x, folded = _block_inputs(torch, fb, g, c, h, batch)
            ref = fb.fused_basic_block_reference(x, *folded)
            for name, fn, module in (
                    ("fused_basic_block", fb.fused_basic_block, fb),
                    ("fused_basic_block_stencil",
                     st.fused_basic_block_stencil, st)):
                y = fn(x, *folded)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                torch.testing.assert_close(y.float(), ref.float(),
                                           atol=5e-2, rtol=2e-2)
                if batch != BATCH:
                    continue
                default = direct(torch, module, module.plan_for(c))
                ops_ms, bytes_ms = _bound(c, h, h)
                rows[name].append({
                    "shape": {"C": c, "H": h, "W": h, "B": batch},
                    "max_abs_err": err,
                    "ms": _time_ms(torch, lambda: default(x, *folded)),
                    "plain_ms": _time_ms(
                        torch, lambda: fb.fused_basic_block_reference(
                            x, *folded), iters=5),
                    "library_ms": _time_ms(
                        torch, _library_block(torch, x, *folded)),
                    "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                    "bound_ms": max(ops_ms, bytes_ms)})
    return rows


def _count_forwards(hrnet_cls):
    """Wrap the HRNet's forward to count its calls; returns (counter, the
    original forward to restore)."""
    calls = [0]
    real = hrnet_cls.forward

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return real(self, *args, **kwargs)
    hrnet_cls.forward = counted
    return calls, real


def _sub_ry(np, sub_dir):
    """rot_y of every line of a submission, in file and line order."""
    out = []
    data = os.path.join(sub_dir, "data")
    for n in sorted(os.listdir(data)):
        with open(os.path.join(data, n)) as f:
            out += [float(ln.split()[14]) for ln in f if ln.strip()]
    return np.array(out)


def gate_phase(torch, np, fb, st, card, donors=None):
    """The closed-loop gate on the card (``tests/torch_gate.py``, the
    pipeline of tests/test_torch_closed_loop_gate.py): the JAX gate's world
    of 40 frames (the port's copy, ``synthetic_world.make_gate_fixture``),
    each donor (``donors``: {family: .pth}, else the committed ones) probed
    through the port's forward on the card against its sidecar, the car,
    pedestrian (W32 family) and native models
    fine-tuned on the card in fp32 and the two 'R3d+T' lifters trained
    there; then each family's inference CLI on both paths on the CPU in
    fp32 (the CPU leg of these weights) and on the card in bf16: the HRNet
    families through the tiled kernel and through the stencil (counts set
    to 0 before each run and read after it: each kernel's launches per
    forward equal the blocks the model routes to it, the width-8 blocks
    running unfused), the native family (no fused block) once.  Every
    leg's AOS / AP_R11 ratio against the protocol ceiling must reach the
    JAX gate's floor and its detection AP the ceiling; printed with the
    gap to the CPU leg and the median / max |d ry| against it.  Both
    kernels are first held against their plain version at the gate's block
    shapes."""
    import importlib.util
    from egonet_tpu_torch.models import hrnet
    from egonet_tpu_torch.tools import synthetic_world as sw
    # by path: a host may have another package named "tests" installed
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_gate.py")
    spec = importlib.util.spec_from_file_location("egonet_torch_gate", path)
    tg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tg)
    donors = donors or tg.DONORS
    t_phase = time.perf_counter()
    kernel_rows = _gate_kernel_rows(torch, fb, st)
    row = {"card": card, "kernel_rows": kernel_rows, "donors": donors}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, pred_dir = sw.make_gate_fixture(tmp)
        row["world_s"] = time.perf_counter() - t0
        label_dir = os.path.join(root, "training", "label_2")
        t0 = time.perf_counter()
        row["donor_px"] = tg.check_donors(root, "cuda", donors)
        row["donor_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        trained = tg.train_all(root, tmp, "cuda", donors)
        row["train_s"] = time.perf_counter() - t0
        row["fine_tune_loss"] = {t: v["loss"] for t, v in trained.items()}
        names = sorted(os.listdir(os.path.join(root, "training", "label_2")))
        names = names[len(names) // 2:]                 # the val split
        ceil = tg.ceiling(label_dir, pred_dir, names,
                          os.path.join(tmp, "ceiling"))
        row["ceiling_ap_r11"] = {
            cls: ceil[(f"{cls}_detection", "AP_R11")][0]
            for cls in ("car", "pedestrian")}
        runs, launches, subs = {}, {}, {}
        for tag in ("car", "ped", "native"):
            hr = tg.BACKBONE[tag] == "hrnet"
            variants = [("cpu_fp32", "cpu", False, None)] + (
                [("tiled", "cuda", True, "0"), ("stencil", "cuda", True, "1")]
                if hr else [("bf16", "cuda", True, None)])
            for name, device, bf16, stencil in variants:
                key = f"{tag}/{name}"
                calls, real = _count_forwards(hrnet.PoseHighResolutionNet)
                fb.fused_basic_block.launches = 0
                st.fused_basic_block_stencil.launches = 0
                t0 = time.perf_counter()
                try:
                    gt, sub = tg.run_inference(
                        root, pred_dir, trained, tag,
                        os.path.join(tmp, f"out_{tag}_{name}"), device,
                        bf16=bf16, stencil=stencil)
                finally:
                    hrnet.PoseHighResolutionNet.forward = real
                seconds = time.perf_counter() - t0
                got = {"tiled": fb.fused_basic_block.launches,
                       "stencil": st.fused_basic_block_stencil.launches}
                want = {"tiled": 0, "stencil": 0}
                if name in want:
                    per = tg.fused_blocks_per_forward(tag, name == "stencil")
                    want[name] = per * calls[0]
                    assert per > 0 and calls[0] > 0, (key, per, calls)
                    launches[key] = {"launches": got[name],
                                     "forwards": calls[0],
                                     "per_forward": got[name] / calls[0]}
                assert got == want, (key, got, want)
                legs = {}
                for leg, ltag, path, cls, floor in tg.LEGS:
                    if ltag != tag:
                        continue
                    ap, aos, c, ratio = tg.leg(
                        tg.score(label_dir, gt if path == "gt" else sub),
                        ceil, cls)
                    legs[leg] = {"ap_r11": ap, "aos_r11": aos,
                                 "ratio": ratio, "floor": floor,
                                 "ap_at_ceiling": abs(ap - c) < 0.2}
                runs[key] = {"legs": legs, "seconds": seconds}
                subs[key] = _sub_ry(np, sub)
        for key, run in runs.items():
            tag, name = key.split("/")
            if name == "cpu_fp32":
                continue
            cpu = runs[f"{tag}/cpu_fp32"]["legs"]
            for leg, r in run["legs"].items():
                r["gap_to_cpu"] = r["ratio"] - cpu[leg]["ratio"]
            d = np.degrees(np.abs(np.angle(np.exp(
                1j * (subs[key] - subs[f"{tag}/cpu_fp32"])))))
            run["d_ry_vs_cpu_deg"] = {"median": float(np.median(d)),
                                      "max": float(d.max())}
    row["runs"] = runs
    row["launches"] = launches
    row["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"gate": row}), flush=True)
    for key, run in runs.items():
        for leg, r in run["legs"].items():
            assert r["ap_at_ceiling"], (key, leg, r)
            assert r["ratio"] >= r["floor"], (key, leg, r)
    return row


# the scratch phase: both from-scratch tools at lengths at which their own
# loss asserts (the last epoch's loss under half the first's) hold, the
# donors on a world of 108 frames (9 steps an epoch; the full length's
# milestones at the same share of the epochs), the full-width PoseNetTPU on
# 48 (4 steps an epoch)
SCRATCH_DONOR_ARGS = ["--epochs", "10", "--images", "108", "--milestones",
                      "6", "9"]
SCRATCH_NATIVE_ARGS = ["--epochs", "20", "--images", "48"]


def scratch_phase(card):
    """The port's training from scratch on the card: ``make_gate_artifacts``
    for both donor families at SCRATCH_DONOR_ARGS (each donor then probed
    on the gate's world, ``write_sidecar``), then
    ``record_native_fullwidth`` at SCRATCH_NATIVE_ARGS (the shipped
    full-width PoseNetTPU through training, checkpoint, the inference CLI
    and the evaluator).  The tools' own asserts decide; the row holds each
    family's losses, val px, sidecar px and seconds and the full-width
    tool's line."""
    from egonet_tpu_torch.tools import make_gate_artifacts as mga
    from egonet_tpu_torch.tools import record_native_fullwidth as rnf
    t_phase = time.perf_counter()
    row = {"card": card, "donor_args": SCRATCH_DONOR_ARGS,
           "native_args": SCRATCH_NATIVE_ARGS}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        made = mga.main(SCRATCH_DONOR_ARGS + ["--out", tmp])
        row["donors_s"] = time.perf_counter() - t0
    row["donors"] = {
        fam: {"first_loss": r["losses"][0], "last_loss": r["losses"][-1],
              "val_px": r["val_px"], "train_s": r["seconds"],
              "sidecar": {k: v for k, v in r["sidecar"].items()
                          if k.startswith("val_px")}}
        for fam, r in made.items()}
    t0 = time.perf_counter()
    row["native"] = rnf.main(SCRATCH_NATIVE_ARGS)
    row["native_s"] = time.perf_counter() - t0
    row["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"scratch": row}), flush=True)
    return row


# the trained_loop phase: the tool's recipe on 96 of its 256 frames (its 60
# epochs, its lifter and legs), so that both families, the lifter and the
# five inference legs take about a minute on the card (the full recipe:
# about three).  At that cut AOS_R11 easy stays under the recipe's 85: the
# phase holds each family to a floor 5 points under the lowest leg of three
# runs of this cut on the card (hrnet 74.57-81.32, native 60.53-64.19;
# PERF.md section 5)
TRAINED_LOOP_ARGS = ["--images", "96", "--epochs", "60"]
TRAINED_LOOP_CUTS = ["frames 256 -> 96 (128 -> 48 trained, 128 -> 48 "
                     "scored); epochs, lifter and legs as the recipe"]
TRAINED_LOOP_AOS_MIN = {"hrnet": 69.56, "tpu_native": 55.52}


def trained_loop_phase(torch, card):
    """``tools/trained_closed_loop`` at TRAINED_LOOP_ARGS, each family's
    AOS held to its TRAINED_LOOP_AOS_MIN (the tool's other bars as they
    are: the loss bars, AP_R11 easy above 99, the C++ AOS equal to the
    Python one, and each bf16 HRNet leg's launches of its kernel equal to
    the blocks routed to it times its forwards, more than 0).  The row
    holds each family's line (AP / AOS per leg, launches, seconds)."""
    from egonet_tpu_torch.tools import trained_closed_loop as tcl
    t_phase = time.perf_counter()
    lines = tcl.main(TRAINED_LOOP_ARGS + [
        "--aos-min", str(min(TRAINED_LOOP_AOS_MIN.values()))])
    row = {"card": card, "args": TRAINED_LOOP_ARGS,
           "cuts": TRAINED_LOOP_CUTS, "aos_min": TRAINED_LOOP_AOS_MIN,
           "recipe_aos_min": tcl.AOS_EASY_MIN,
           "families": {ln["family"]: ln for ln in lines},
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps({"trained_loop": row}), flush=True)
    for line in lines:
        tcl.check(line, torch.device("cuda"),
                  TRAINED_LOOP_AOS_MIN[line["family"]])
    return row


def trained_loop_only(torch, card):
    """``--trained-loop``: ``tools/trained_closed_loop`` alone at its full
    recipe and bars (it builds both kernels and the operators first)."""
    from egonet_tpu_torch.tools import trained_closed_loop as tcl
    tcl.main([])
    _print_ok(torch, card)
    return 0


def gate_only(torch, np, fb, st, card, donor_dir):
    """``--gate-donors DIR``: the gate phase alone, on the donors that
    ``make_gate_artifacts --out DIR`` wrote (both kernels built first)."""
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.tools.make_gate_artifacts import DONORS
    _build.build([fb.library(), st.library()])
    donors = {fam: os.path.join(donor_dir, name) for fam, name in DONORS}
    gate_phase(torch, np, fb, st, card, donors)
    _print_ok(torch, card)
    return 0


# ---------------------------------------------------------------------------
# --cards N: the multi-card paths on N distinct cards
# ---------------------------------------------------------------------------

# the scaling rows: mesh sizes in turns (1, N, 2, 2, N, 1), the device
# program at each batch over about MC_WINDOW_CROPS crops a window, the
# median of MC_REPEATS windows; the e2e loop (tools/bench.bench_e2e) one
# epoch a window
MC_BATCHES, MC_WINDOW_CROPS, MC_REPEATS = (32, 128, 384), 1152, 5
# the overlap rows' batches (frames x boxes): the slice, bucket 32, and
# 16 frames x 24 boxes, bucket 384
MC_OVERLAP, MC_OVERLAP_REPEATS = ((N_FRAMES, N_BOXES), (16, 24)), 3
# the trainers on the synthetic world (tools/synthetic_world): its frames
# (the first half trains: 32 frames x 3 cars, one step an epoch, 96 real
# crops padded to 140), IGR epochs (the first one warm), lifter epochs,
# the fp64 step's instances per rank
MC_WORLD_FRAMES, MC_IGR_EPOCHS, MC_LIFT_EPOCHS = 64, 4, 3
MC_PARITY_PER_RANK = 2
# the fp32 CLI's first step at N ranks against 1 rank (relative loss; the
# cross-rank batch norm sums x and x^2 where one process takes the
# variance in one pass: 3.3e-5 apart over 2 gloo ranks at a shrunk width on
# the CPU); the fp64 first step against one process: tests/
# test_torch_dp.py's bars (loss, gradients, BN running statistics)
MC_CLI_LOSS_REL = 1e-3
MC_LOSS_TOL, MC_TENSOR_TOL, MC_STATS_TOL = 1e-10, 1e-9, 1e-12
MC_ALLREDUCE_REPEATS = 5
MC_RANK_TIMEOUT_S = 900.0


def _smi_cards():
    """``nvidia-smi --query-gpu=name,power.limit`` of every card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()


def _sync_free(torch, model, annot):
    """One dispatch of ``annot`` under ``set_sync_debug_mode("error")``
    after a warm one (libraries, launch plans, pinned blocks): it raises
    at the first host synchronisation the dispatch path makes.  Returns
    the records (finalized after the mode is off again)."""
    model.finalize(model.dispatch_annot_dict(annot))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:                    # the mode's own check: a blocking copy
            torch.tensor([0.0], device=model.device)
        except RuntimeError:
            pass
        else:
            raise AssertionError("set_sync_debug_mode let a copy from "
                                 "pageable host memory pass")
        pending = model.dispatch_annot_dict(annot)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return model.finalize(pending)


def _mc_build_rank(out):
    """One rank of the build race: after a barrier every rank calls
    ``load_ops("cuda")`` at once; writes its seconds, the libraries it
    built itself, and an NCCL sum of ones over the ranks."""
    import torch
    import torch.distributed as dist
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.parallel import mesh
    dist.barrier()
    t0 = time.perf_counter()
    _build.load_ops("cuda")
    row = {"rank": mesh.rank(), "device": torch.cuda.current_device(),
           "seconds": time.perf_counter() - t0,
           "built": sorted(_build.BUILD_INFO)}
    ones = torch.ones(1, device="cuda")
    dist.all_reduce(ones)
    row["nccl_sum"] = float(ones)
    with open(os.path.join(out, f"build.rank{row['rank']}.json"), "w") as f:
        json.dump(row, f)


def _mc_build_race(torch, n, tmp):
    """N ranks (nccl, one card each) reach the operators' first use at
    once: the build lock lets one of them build while the others wait and
    then load.  Also records the transports NCCL's log names for this
    group's connections and which cards can reach each other's memory."""
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.parallel import mesh
    cold = any(_build._stale(*_build._spec(lib))
               for lib in _build.ops_libs("cuda"))
    # NCCL's own log of this first group (one file a rank): the transport
    # each channel's connection took
    log = os.path.join(tmp, "nccl")
    os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_FILE=log + ".%h.%p")
    try:
        mesh.run_ranks(_mc_build_rank, n, args=(tmp,), backend="nccl",
                       device="cuda", timeout_s=MC_RANK_TIMEOUT_S)
    finally:
        del os.environ["NCCL_DEBUG"], os.environ["NCCL_DEBUG_FILE"]
    transports = {}
    for name in os.listdir(tmp):
        if name.startswith("nccl."):
            with open(os.path.join(tmp, name)) as f:
                for m in re.finditer(r" via (\S+)", f.read()):
                    transports[m.group(1)] = transports.get(m.group(1), 0) + 1
    ranks = []
    for r in range(n):
        with open(os.path.join(tmp, f"build.rank{r}.json")) as f:
            ranks.append(json.load(f))
    built_by = [r["rank"] for r in ranks if r["built"]]
    shm = os.statvfs("/dev/shm")
    row = {"cold": cold, "ranks": ranks, "built_by": built_by,
           "nccl_env": {k: v for k, v in os.environ.items()
                        if k.startswith("NCCL_")},
           "nccl_transports": transports,
           "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                            for j in range(n)] for i in range(n)],
           "dev_shm_mb": shm.f_bsize * shm.f_blocks / 2**20}
    assert len(built_by) == (1 if cold else 0), row
    assert [r["device"] for r in ranks] == list(range(n)), row
    assert all(r["nccl_sum"] == n for r in ranks), row
    return row


def _mc_kernels(torch, fb, st, n):
    """Both kernels on each card at every W48 shape (batch 32), their
    inputs on that card and the calling thread's current card cuda:0,
    each held against its plain version (the kernel phases' bar)."""
    per_card = []
    for i in range(n):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(i)
        errs = {}
        for c, h in W48_SHAPES:
            with torch.cuda.device(dev):
                x, folded = _block_inputs(torch, fb, g, c, h, BATCH)
            ref = fb.fused_basic_block_reference(x, *folded).float()
            for name, fn in (("fused_basic_block", fb.fused_basic_block),
                             ("fused_basic_block_stencil",
                              st.fused_basic_block_stencil)):
                y = fn(x, *folded)
                assert y.device == dev, (name, y.device)
                torch.cuda.synchronize(dev)
                torch.testing.assert_close(y.float(), ref, atol=5e-2,
                                           rtol=2e-2)
                errs[name] = max(errs.get(name, 0.0),
                                 float((y.float() - ref).abs().max()))
        per_card.append({"device": str(dev),
                         "name": torch.cuda.get_device_name(i),
                         "max_abs_err": errs})
    return {"shapes": [list(s) for s in W48_SHAPES], "batch": BATCH,
            "tolerance": "atol 5e-2 / rtol 2e-2", "per_card": per_card}


def _overlap(torch, model, annot, planted_sync=False):
    """One batch over ``model``'s mesh, each shard's program between two
    CUDA events on its own card; every card's origin event is recorded
    before the batch, with the cards idle.  Returns each shard's device
    window and host enqueue window (ms from the batch's start), the
    batch's wall ms and its H2D bytes.  ``planted_sync``: after each
    shard's program, one blocking copy of a host value to its card (what
    ``_tail`` and the rigid solve's list indexing made before this
    repair), so the host waits for that shard before the next."""
    from egonet_tpu_torch.models.egonet import EgoNet
    model.finalize(model.dispatch_annot_dict(annot))
    cards = model.mesh.distinct()
    for d in cards:
        torch.cuda.synchronize(d)
    origin = {}
    for d in cards:
        with torch.cuda.device(d):
            origin[d] = torch.cuda.Event(enable_timing=True)
            origin[d].record()
    t0 = time.perf_counter()
    shards = []

    def timed(fn):
        def run(*args, replica, **kwargs):
            dev = replica.scale.device
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            out = fn(*args, replica=replica, **kwargs)
            if planted_sync:
                torch.tensor([0.0], device=dev)
            end.record()
            shards.append((dev, start, end, h0, time.perf_counter()))
            return out
        return run

    model._core = timed(EgoNet._core.__get__(model))
    model._core_packed = timed(EgoNet._core_packed.__get__(model))
    h2d = model.transport_stats["h2d_bytes"]
    try:
        model.finalize(model.dispatch_annot_dict(annot))
    finally:
        del model._core, model._core_packed
    wall = time.perf_counter() - t0
    for d in cards:
        torch.cuda.synchronize(d)
    rows = [{"device": str(dev),
             "device_ms": [origin[dev].elapsed_time(s),
                           origin[dev].elapsed_time(e)],
             "host_enqueue_ms": [1e3 * (a - t0), 1e3 * (b - t0)]}
            for dev, s, e, a, b in shards]
    ends = [r["device_ms"][1] for r in rows]
    starts = [r["device_ms"][0] for r in rows]
    return {"instances": sum(len(b) for b in annot["boxes"]),
            "planted_sync": planted_sync, "shards": rows,
            "wall_ms": 1e3 * wall,
            "device_span_ms": max(ends) - min(starts),
            "device_busy_sum_ms": sum(e - s for s, e in zip(starts, ends)),
            "shards_started_before_first_ended": sum(
                s < min(ends) for s in starts),
            "h2d_bytes": model.transport_stats["h2d_bytes"] - h2d}


def _mc_mesh(torch, np, fb, st, n):
    """The W48 slice (bf16) through ``EgoNet(mesh=make_mesh(N))`` against
    the single-card facade on cuda:0, tiled then stencil: 104 launches per
    shard of the kernel in use and none of the other, the serve bars;
    both dispatches (single, mesh) under ``set_sync_debug_mode("error")``;
    the same N shards on cuda:0 against single; then the overlap rows
    (MC_OVERLAP, each MC_OVERLAP_REPEATS times), as the facade runs and
    with a blocking host copy planted after each shard."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.precision import _plausible_ls_stats
    annot = _frames(np)
    single = _slice_model(torch, demo_config())
    sharded = EgoNet(demo_config(), mesh=mesh.make_mesh(n))
    sharded.load_state(ls_stats=_plausible_ls_stats())
    row = {"mesh": [str(d) for d in sharded.mesh]}
    for path, flag in (("tiled", "0"), ("stencil", "1")):
        single.prepare_inference(stencil=flag)
        sharded.prepare_inference(stencil=flag)
        want = single(annot)
        records, launches, rows = _mesh_batch(torch, fb, st, sharded, annot)
        other = "stencil" if path == "tiled" else "tiled"
        assert launches == {path: 104 * n, other: 0, "rigid": n,
                            "bn_act": BN_ACT_PER_FORWARD * n}, launches
        checked = {"single": _sync_free(torch, single, annot),
                   "mesh": _sync_free(torch, sharded, annot)}
        row[path] = {
            "bucket": rows, "launches": launches[path],
            "launches_per_card": launches[path] // n,
            "vs_single": _gap_row(np, records, want),
            "bit_equal": all(np.array_equal(records[p]["euler_angles"],
                                            want[p]["euler_angles"])
                             for p in want),
            "sync_free": {k: _gap_row(np, v, want)["max_d_ry_deg"]
                          for k, v in checked.items()}}
    sharded.prepare_inference(stencil="0")
    single.prepare_inference(stencil="0")
    # the same N shards on cuda:0: whether a gap to one card comes from
    # the shards' size or from the cards
    one_card = EgoNet(demo_config(), mesh=mesh.DataMesh(["cuda:0"] * n))
    one_card.load_state(ls_stats=_plausible_ls_stats())
    want = single(annot)
    got = one_card(annot)
    row["shards_on_cuda0"] = {
        "vs_single": _gap_row(np, got, want),
        "bit_equal": all(np.array_equal(got[p]["euler_angles"],
                                        want[p]["euler_angles"])
                         for p in want)}
    del one_card
    row["overlap"] = [_overlap(torch, sharded, _frames(np, f, b), sync)
                      for f, b in MC_OVERLAP for sync in (False, True)
                      for _ in range(MC_OVERLAP_REPEATS)]
    del single, sharded
    torch.cuda.empty_cache()
    return row


def _mesh_core_rate(torch, np, model, batch):
    """The device program (``_core``) over ``model``'s mesh at ``batch``
    crops (rounded up to a multiple of the mesh), its inputs already on
    every card (tools/bench's): shard after shard enqueued back to back,
    every output's checksum fetched at a window's end.  Returns {median,
    min, max} crops/s of MC_REPEATS windows."""
    from egonet_tpu_torch.parallel import mesh as pmesh
    from egonet_tpu_torch.tools.bench import build_core_inputs
    batch = pmesh.pad_to_multiple(batch, len(model.mesh))
    images, meta, idx = build_core_inputs(model, batch)
    frames = {d: images.to(d) for d in model.mesh.distinct()}
    shards = [(d, meta[a:b].to(d), idx[a:b]) for d, (a, b) in zip(
        model.mesh, pmesh.shard_bounds(batch, len(model.mesh)))]

    def run():
        outs = []
        for d, m, ix in shards:
            with torch.cuda.device(d):
                outs.append(model._core(frames[d], m, ix, alpha_mode="proj",
                                        replica=model.replicas[d]))
        return outs

    iters = max(2, MC_WINDOW_CROPS // batch)
    rates = []
    with torch.inference_mode():
        for _ in range(2):
            run()
        for _ in range(MC_REPEATS):
            for d in frames:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            sums = [[] for _ in shards]
            for _ in range(iters):
                for j, out in enumerate(run()):
                    sums[j].append(out[:, -2].sum())
            check = sum(float(torch.stack(s).sum()) for s in sums)
            rates.append(batch * iters / (time.perf_counter() - t0))
            assert np.isfinite(check)
    return {"median": float(np.median(rates)), "min": min(rates),
            "max": max(rates), "batch": batch, "iters": iters}


def _mc_turns(n):
    """Mesh sizes in turns, so that each size is measured early and late
    in the call: (1, N, 2, 2, N, 1), without sizes above N."""
    sizes = list(dict.fromkeys(k for k in (1, n, 2) if k <= n))
    return sizes + sizes[::-1]


def _mc_scaling(torch, np, n, tmp):
    """W48 bf16 device-program crops/s at MC_BATCHES and e2e crops/s
    through the facade (``tools/bench.bench_e2e``: decode, host prep,
    device, txts; one epoch a window) over 1, 2 and N cards, in the turns
    of :func:`_mc_turns`."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.tools import bench
    order = _mc_turns(n)
    models = {k: EgoNet(demo_config(), mesh=mesh.make_mesh(k))
              for k in sorted(set(order))}
    program = {k: {str(b): [] for b in MC_BATCHES} for k in models}
    e2e = {k: [] for k in models}
    for k in order:
        for b in MC_BATCHES:
            program[k][str(b)].append(_mesh_core_rate(torch, np, models[k],
                                                      b))
        r = bench.bench_e2e(models[k], tmp, epochs=1, repeats=MC_REPEATS)
        e2e[k].append({key: r[key] for key in (
            "crops_per_sec", "min", "max", "cold_crops_per_sec")})
    del models
    torch.cuda.empty_cache()

    def mean(rows, key="median"):
        return float(np.mean([r[key] for r in rows]))
    return {"order": order, "repeats": MC_REPEATS,
            "device_program": {str(k): v for k, v in program.items()},
            "e2e": {str(k): v for k, v in e2e.items()},
            "vs_one_card": {
                str(k): {**{b: mean(program[k][b]) / mean(program[1][b])
                            for b in program[k]},
                         "e2e": mean(e2e[k], "crops_per_sec")
                         / mean(e2e[1], "crops_per_sec")}
                for k in program}}


def _mc_serve(torch, np, fb, st, n):
    """bench_serve's workload (SERVE_REQUESTS x SERVE_BOXES from
    SERVE_WORKERS clients over SERVE_FRAMES frames) through ``tools/
    serve.main(["--devices", k])`` for k = 1 then N (W48 bf16, tiled,
    seeded random weights, the harness's LS statistics): 104 launches per
    card of every micro-batch, every timed response against the
    single-card offline facade at the serve bars."""
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.precision import _plausible_ls_stats
    from egonet_tpu_torch.tools import bench_serve, serve
    offline = _slice_model(torch, demo_config())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = bench_serve.make_frames(tmp, SERVE_FRAMES)
        payloads = bench_serve.make_payloads(paths, SERVE_REQUESTS,
                                             SERVE_BOXES)
        for k in sorted({1, n}):
            cfgs = demo_config()
            cfgs["pre_trained"] = False
            server = serve.main(["--devices", str(k), "--port", "0",
                                 "--max-batch", "16", "--max-wait-ms",
                                 str(SERVE_WAIT_MS), "--warmup", "0"],
                                cfgs=cfgs, block=False)
            server.batcher.model.load_state(ls_stats=_plausible_ls_stats())
            line, bodies, launches, batches, _ = _serve_pass(
                torch, fb, st, server, payloads, settle=8, n_single=12)
            assert launches == {"tiled": 104 * k * batches, "stencil": 0}, (
                launches, batches)
            out[str(k)] = {key: line[key] for key in (
                "value", "p50_ms", "p90_ms", "max_ms", "batches",
                "single_stream_p50_ms", "frames_decoded", "cache_hits")}
            out[str(k)].update({
                "devices": k, "mesh": server.device.get("mesh"),
                "run_batches": batches, "run_launches": launches["tiled"],
                "vs_offline": _served_vs_offline(np, offline, payloads,
                                                 bodies)})
    del offline
    torch.cuda.empty_cache()
    return {"requests": SERVE_REQUESTS, "boxes": SERVE_BOXES,
            "workers": SERVE_WORKERS, "by_devices": out}


def _mc_dryrun(n, tmp):
    """``tools/dryrun_multigpu --nproc N --backend nccl --device cuda``,
    every leg admitted (each rank on its own card); then, from 3 cards,
    the legs that exercise the 140-instance cap's wrap padding and the
    sharded facade's at 3 ranks (140 and bucket 256 do not divide by
    3)."""
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.tools import dryrun_multigpu
    full = _dryrun(tmp, ["--nproc", str(n), "--backend", "nccl",
                         "--device", "cuda", "--budget-s", "1e9"],
                   MC_RANK_TIMEOUT_S)
    assert full["backend"] == "nccl" and full["ranks"] == n, full
    if n > 1:
        assert full["skipped"] == {} and len(full["legs"]) == 7, full
    row = {"full": full}
    if n >= 3:
        out = os.path.join(tmp, "dryrun3.json")
        mesh.run_ranks(dryrun_multigpu._rank, 3,
                       args=("cuda", 1e9, out, ("inference_parity",)),
                       backend="nccl", device="cuda",
                       timeout_s=MC_RANK_TIMEOUT_S)
        with open(out) as f:
            three = json.load(f)
        assert three["ranks"] == 3 and three["skipped"] == {} and set(
            three["legs"]) == {"sharded_train", "inference_parity"}, three
        row["three_ranks"] = three
    return row


def _mc_igr_cfg(root, out):
    """The shipped W48 IGR config on the synthetic world: one step an
    epoch (the train split's 32 frames a batch), no debug grids."""
    from egonet_tpu_torch.config import train_igrs_config
    cfgs = train_igrs_config()
    cfgs["dataset"]["root"] = root
    cfgs["heatmapModel"]["pretrained"] = ""
    cfgs["dirs"] = {"output": out}
    cfgs["training_settings"].update({
        "batch_size": MC_WORLD_FRAMES // 2, "total_epochs": MC_IGR_EPOCHS,
        "debug": {"save": False}})
    return cfgs


def _mc_lift_cfg(root, out):
    from egonet_tpu_torch.config import train_lifting_config
    cfgs = train_lifting_config()
    cfgs["dataset"]["root"] = root
    cfgs["dirs"] = {"output": out}
    cfgs["training_settings"]["total_epochs"] = MC_LIFT_EPOCHS
    return cfgs


def _rel(a, b):
    """max |a - b| over max |b| (of two tensors, in fp64)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _hold_step(torch, got, ref, what):
    """(loss gap, largest gradient gap, largest BN statistics gap) of a
    data-parallel step against one process's, held to tests/
    test_torch_dp.py's bars: analytically-zero gradients (both sides
    under 1e-14 of the largest) are rounding noise and skipped."""
    loss = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    grad = max((_rel(got["grads"][k], g) for k, g in ref["grads"].items()
                if max(float(g.abs().max()),
                       float(got["grads"][k].abs().max())) >= 1e-14 * scale),
               default=0.0)
    stats = max((float((got["stats"][k].double() - s.double()).abs().max())
                 / max(float(s.double().abs().max()), 1.0)
                 for k, s in ref["stats"].items()), default=0.0)
    gaps = {"loss": loss, "grads": grad, "bn_stats": stats}
    assert set(got["grads"]) == set(ref["grads"]), what
    assert loss <= MC_LOSS_TOL and grad <= MC_TENSOR_TOL \
        and stats <= MC_STATS_TOL, (what, gaps)
    return gaps


def _step_record(state, loss):
    return {"loss": float(loss),
            "grads": {k: p.grad.detach().clone()
                      for k, p in state.model.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def _parity_steps(torch, np, root, device):
    """The IGR (W48) and lifter trainers' first step in fp64 on one global
    batch (MC_PARITY_PER_RANK instances a rank), data parallel and, on
    rank 0, in one process (``mesh.solo``): the gaps (rank 0), else
    None."""
    from egonet_tpu_torch.config import train_igrs_config, \
        train_lifting_config
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.train.igrs import IGRTrainer
    from egonet_tpu_torch.train.lifting import LiftingTrainer
    k = MC_PARITY_PER_RANK * mesh.world()
    f64 = ("joints", "mask", "sup_mask", "input", "output")
    cfgs = train_igrs_config()
    cfgs["dataset"]["root"] = root
    cfgs["heatmapModel"]["pretrained"] = ""
    records = kitti.KITTIDataset(cfgs, "train").records
    batch = next(IGRBatchLoader(records, cfgs, train=True, max_instances=k,
                                seed=0).epoch())
    batch = {key: (v.astype(np.float64) if key in f64 else v)
             for key, v in batch.items()}
    lcfg = train_lifting_config()
    lcfg["FCModel"].update({"input_size": 66, "output_size": 96})
    rng = np.random.RandomState(3)
    lbatch = {"input": rng.randn(k, 66), "output": rng.randn(k, 96),
              "mask": np.ones(k)}

    def igr():
        t = IGRTrainer(cfgs, dtype=torch.float64, device=device)
        state, m = t.train_step(t.init_state(0), batch, apply_cr=True)
        return _step_record(state, m["loss"])

    def lifter():
        t = LiftingTrainer(lcfg, dtype=torch.float64, device=device)
        state, loss = t.train_step(t.init_state(0), lbatch)
        return _step_record(state, loss)

    got = {"igr": igr(), "lifter": lifter()}
    if not mesh.is_main():
        return None
    with mesh.solo():
        ref = {"igr": igr(), "lifter": lifter()}
    return {name: {"instances": k,
                   "gaps": _hold_step(torch, got[name], ref[name], name)}
            for name in got}


def _all_reduce_seconds(torch, np, root, device):
    """Seconds of ``mesh.all_reduce_grads`` over the W48 IGR model's fp32
    gradients (one step's, on the synthetic world), MC_ALLREDUCE_REPEATS
    times after one warm call, each between two synchronisations; and the
    collectives of one such step (``dist.all_reduce`` calls counted: the
    cross-rank batch norm's, forward and backward, the gradients', the
    loss values') with its wall seconds, and the median seconds of one
    all-reduce of 384 floats (a batch norm's statistics), each between
    two synchronisations."""
    import torch.distributed as dist
    from egonet_tpu_torch.data import kitti
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.train.igrs import IGRTrainer
    cfgs = _mc_igr_cfg(root, "")
    records = kitti.KITTIDataset(cfgs, "train").records
    batch = next(IGRBatchLoader(records, cfgs, train=True, seed=0).epoch())
    trainer = IGRTrainer(cfgs, device=device)
    state, _ = trainer.train_step(trainer.init_state(0), batch)
    calls, real = [], dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dist.all_reduce = counted
    try:
        state, metrics = trainer.train_step(state, batch)
        float(metrics["loss"])
    finally:
        dist.all_reduce = real
    step_s = time.perf_counter() - t0
    small = torch.ones(384, device=device)
    lat = []
    for i in range(110):
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        dist.all_reduce(small)
        torch.cuda.synchronize(device)
        if i >= 10:
            lat.append(time.perf_counter() - t1)
    step = {"seconds": step_s, "all_reduces": len(calls),
            "all_reduce_floats": sum(calls),
            "small_all_reduce_median_s": float(np.median(lat))}
    params = list(state.model.parameters())
    nbytes = sum(p.grad.numel() * p.grad.element_size() for p in params
                 if p.grad is not None)
    mesh.all_reduce_grads(params)
    seconds = []
    for _ in range(MC_ALLREDUCE_REPEATS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        mesh.all_reduce_grads(params)
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return {"bytes": nbytes, "seconds": seconds,
            "median_s": float(np.median(seconds)), "step": step}


def _mc_train_rank(out, root, tag, parts):
    """One rank of the train leg (``parallel/mesh.run_ranks``: torchrun's
    environment, nccl, the card of its local rank): ``parts`` of "parity"
    (:func:`_parity_steps`), "all_reduce" (:func:`_all_reduce_seconds`),
    "igr" (``tools/train_igrs.main`` on the synthetic world, fp32) and
    "lifter" (``tools/train_lifting.main``); rank 0 writes
    ``<out>/<tag>.json``."""
    import numpy as np
    import torch
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.tools import train_igrs, train_lifting
    device = torch.device("cuda", torch.cuda.current_device())
    row = {"ranks": mesh.world()}
    if "parity" in parts:
        row["parity_fp64"] = _parity_steps(torch, np, root, device)
        torch.cuda.empty_cache()
    if "all_reduce" in parts:
        row["all_reduce"] = _all_reduce_seconds(torch, np, root, device)
        torch.cuda.empty_cache()
    if "igr" in parts:
        t0 = time.perf_counter()
        summary = train_igrs.main(cfgs=_mc_igr_cfg(
            root, os.path.join(out, f"{tag}_igr")))
        row["igr"] = {"history": summary["history"],
                      "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    if "lifter" in parts:
        t0 = time.perf_counter()
        summary = train_lifting.main(cfgs=_mc_lift_cfg(
            root, os.path.join(out, f"{tag}_lifter")))
        row["lifter"] = {"history": summary["history"],
                         "train_pairs": summary["train_pairs"],
                         "seconds": time.perf_counter() - t0}
    if mesh.is_main():
        with open(os.path.join(out, f"{tag}.json"), "w") as f:
            json.dump(row, f)


def _igr_rates(np, igr):
    """Crops trained per second of the IGR CLI's epochs after the first
    (one step each: real and padded crops over the epoch's wall seconds,
    and over its ``step`` seconds alone)."""
    hist = igr["history"][1:]
    wall = float(np.median([h["seconds"] for h in hist]))
    step = float(np.median([h["split"]["step"] for h in hist]))
    real = 3 * MC_WORLD_FRAMES // 2
    return {"real_crops": real, "padded_crops": 140,
            "median_epoch_s": wall, "median_step_s": step,
            "real_crops_per_s": real / wall,
            "padded_crops_per_s": 140 / wall,
            "padded_crops_per_s_step_only": 140 / step,
            "loss": [h["loss"] for h in igr["history"]],
            "split_s": [h["split"] for h in igr["history"]]}


def _mc_train(torch, np, n, tmp):
    """The trainers under N ranks (nccl): the fp64 first step of the IGR
    (W48) and lifter trainers against one process; the W48 gradients'
    all-reduce seconds at N and 2 ranks; ``tools/train_igrs`` (fp32, the
    shipped W48 config) at N, 2 and 1 ranks, its first step at N against
    1 (MC_CLI_LOSS_REL), crops trained per second; ``tools/
    train_lifting`` at N and 1."""
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.tools import synthetic_world
    root, _ = synthetic_world.make_cars_world(os.path.join(tmp, "world"),
                                              MC_WORLD_FRAMES)
    plan = {1: ("igr", "lifter")}
    if n > 2:
        plan[2] = ("all_reduce", "igr")
    plan[n] = ("parity", "all_reduce", "igr", "lifter")
    got = {}
    for k in sorted(plan, reverse=True):
        tag = f"ranks{k}"
        mesh.run_ranks(_mc_train_rank, k, args=(tmp, root, tag, plan[k]),
                       backend="nccl", device="cuda",
                       timeout_s=MC_RANK_TIMEOUT_S)
        with open(os.path.join(tmp, f"{tag}.json")) as f:
            got[k] = json.load(f)
    first = {k: got[k]["igr"]["history"][0]["loss"] for k in got}
    cli_gap = abs(first[n] - first[1]) / abs(first[1])
    row = {"world_frames": MC_WORLD_FRAMES, "igr_epochs": MC_IGR_EPOCHS,
           "parity_fp64": got[n].get("parity_fp64"),
           "all_reduce": {str(k): got[k]["all_reduce"] for k in got
                          if "all_reduce" in got[k]},
           "igr": {str(k): _igr_rates(np, got[k]["igr"]) for k in got},
           "igr_first_step_loss": {str(k): v for k, v in first.items()},
           "igr_first_step_rel_gap": cli_gap,
           "lifter": {str(k): {
               "loss": [h["loss"] for h in got[k]["lifter"]["history"]],
               "epoch_s": [h["seconds"] for h in got[k]["lifter"]["history"]],
               "train_pairs": got[k]["lifter"]["train_pairs"]}
               for k in got if "lifter" in got[k]}}
    assert cli_gap <= MC_CLI_LOSS_REL, row
    for k in got:
        assert np.isfinite(row["igr"][str(k)]["loss"]).all(), row
    return row


def multicard_phase(torch, np, card, n):
    """``--cards N``: the multi-card paths over the first N cards, one
    JSON row per leg (its seconds, the cards, nvidia-smi's name and power
    limit of each); every leg runs, and the phase fails after the last if
    any failed.  No leg falls back to gloo, to cuda:0 or to a plain
    version."""
    import traceback
    from egonet_tpu_torch.ops import _build
    from egonet_tpu_torch.ops import fused_block as fb
    from egonet_tpu_torch.ops import fused_block_stencil as st
    base = {"n_cards": n,
            "cards": [torch.cuda.get_device_name(i) for i in range(n)],
            "smi": _smi_cards()[:n], "card": card}
    failed = []

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        try:
            row = fn(*args)
        except Exception:          # every leg runs; the phase fails below
            row = {"error": traceback.format_exc()[-6000:]}
            failed.append(name)
        print(json.dumps({"multicard": {
            "leg": name, **row, "seconds": time.perf_counter() - t0,
            **base}}), flush=True)
        torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        leg("build_race", _mc_build_race, torch, n, tmp)
        _build.load_ops("cuda")
        leg("kernels", _mc_kernels, torch, fb, st, n)
        leg("mesh", _mc_mesh, torch, np, fb, st, n)
        leg("scaling", _mc_scaling, torch, np, n, tmp)
        leg("serve", _mc_serve, torch, np, fb, st, n)
        leg("dryrun", _mc_dryrun, n, tmp)
        leg("train", _mc_train, torch, np, n, tmp)
    print(json.dumps({"multicard_s": time.perf_counter() - t_phase,
                      "failed": failed, **base}), flush=True)
    assert not failed, failed


def multicard_only(torch, np, card, n):
    """``--cards N``: the multicard phase alone (the operator and kernel
    libraries built by its first leg); raises unless N cards are
    visible."""
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(f"--cards {n}: {visible} CUDA device(s) are "
                           "visible")
    multicard_phase(torch, np, card, n)
    _print_ok(torch, card)
    return 0


def _print_ok(torch, card):
    """The run's last two lines: the card, then {"ok": true, ...}."""
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _ped_entry(rows, launches):
    """The W32 forward's share of a kernel's entry: per-shape rows summed
    over one W32 pedestrian forward at 32 crops."""
    def total(key):
        return sum(PED_PER_FORWARD[r["shape"]["C"]] * r[key] for r in rows)
    ops_ms, bytes_ms = total("ops_ms"), total("bytes_ms")
    return {"launches": launches, "ms": total("ms"),
            "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "per": "one HRNet-W32 pedestrian forward at 32 crops "
                   "(104 launches)"}


def _shapes(rows):
    return [{**r["shape"], **{k: r[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}}
        for r in rows]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="the port's run on a card")
    ap.add_argument("--gate-donors", metavar="DIR",
                    help="run only the gate phase, on the donors in DIR "
                         "(python -m egonet_tpu_torch.tools."
                         "make_gate_artifacts --out DIR)")
    ap.add_argument("--trained-loop", action="store_true",
                    help="run only tools/trained_closed_loop at its full "
                         "recipe")
    ap.add_argument("--clusters", action="store_true",
                    help="run only the tiled kernel's cluster sweep")
    ap.add_argument("--cards", type=int, metavar="N",
                    help="run only the multicard phase over the first N "
                         "cards (an error when fewer are visible)")
    args = ap.parse_args(argv)
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
    from egonet_tpu_torch.tools.bench import card_line

    t_run = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}",
          flush=True)
    full_precision_fp32()
    if args.gate_donors:
        return gate_only(torch, np, fb, st, card, args.gate_donors)
    if args.trained_loop:
        return trained_loop_only(torch, card)
    if args.clusters:
        return clusters_only(torch, _build, fb, card)
    if args.cards:
        return multicard_only(torch, np, card, args.cards)
    sweep = sweep_plans(fb)
    sweep_lib = fb.library([p for plans in sweep.values() for _, p in plans])
    ssweep = stencil_sweep(st)
    ssweep_lib = st.library([p for plans in ssweep.values() for p in plans])
    ped_tiled, ped_stencil = ped_sweeps(fb, st)
    ped_tiled_lib = fb.library([p for plans in ped_tiled.values()
                                for _, p in plans])
    ped_stencil_lib = st.library([p for plans in ped_stencil.values()
                                  for p in plans])
    cplans = cluster_plans(fb)
    cluster_lib = fb.library([p for by_k in cplans.values()
                              for p in by_k.values()])
    t0 = time.perf_counter()
    # the operator libraries (csrc/egonet_ops*.cpp, the host compiler) and
    # every kernel library (nvcc), all compilers started together
    _build.build(_build.ops_libs("cuda") + [sweep_lib, ssweep_lib,
                                            ped_tiled_lib, ped_stencil_lib,
                                            cluster_lib])
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", flush=True)
    for name, info in _build.BUILD_INFO.items():
        print(f"[{name}] built in {info['seconds']:.1f} s; "
              + "; ".join(_ptxas_summary(info["log"])), flush=True)
    print(json.dumps({"build": {
        "wall_s": build_s, "card": card,
        "seconds": {n: i["seconds"] for n, i in _build.BUILD_INFO.items()}}}),
        flush=True)

    print(json.dumps({"sass": sass_report(_build, fb, st)}), flush=True)
    phase_s = {}

    def timed(name, fn, *args):
        """Run one phase and keep its seconds (printed with the others)."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(json.dumps({"phase_s": {name: phase_s[name]}}), flush=True)
        return out

    rows = timed("kernel", kernel_phase, torch, fb, sweep, sweep_lib)
    srows = timed("stencil_kernel", stencil_kernel_phase, torch, fb, st,
                  ssweep, ssweep_lib)
    ped_rows = timed("kernel_ped", kernel_ped_phase, torch, fb, st,
                     ped_tiled, ped_tiled_lib, ped_stencil, ped_stencil_lib)
    timed("clusters", cluster_phase, torch, fb, cplans, cluster_lib)
    timed("rigid", rigid_phase, torch, np, card)
    timed("bn_act", bn_act_phase, torch, np, card)
    result, model, annot, ry, ry_u = timed("slice", slice_phase, torch, np,
                                           fb, st)
    print(json.dumps({"slice": result}), flush=True)
    sresult = timed("stencil_slice", stencil_slice_phase, torch, np, fb, st,
                    model, annot, ry, ry_u)
    sresult["tiled_crops_per_s"] = result["crops_per_s"]
    print(json.dumps({"stencil_slice": sresult}), flush=True)
    timed("profile", profile_phase, torch, fb, st, model, annot)
    del model
    torch.cuda.empty_cache()
    timed("fixture", fixture_phase, torch, np, fb, st, here)
    torch.cuda.empty_cache()
    timed("native", native_phase, torch, np, fb, st, here, annot)
    with tempfile.TemporaryDirectory() as tmp:
        cli, root, pred_dir = timed("cli", cli_phase, np, fb, st, tmp)
        print(json.dumps({"cli": cli}), flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _write_train_split(np, root)
        out = os.path.join(tmp, "train_out")
        ckpt_dir = timed("train_lifter", train_lifter_phase, torch, np, root,
                         out, card)
        timed("train_igrs", train_igrs_phase, torch, np, here, root,
              pred_dir, ckpt_dir, out, card)
        timed("train_native", train_native_phase, torch, np, root, card)
        ped = timed("train_ped", train_ped_phase, torch, np, fb, st, root,
                    annot, card)
        timed("options", options_phase, torch, np, fb, st, annot, ry, root,
              card)
        print(json.dumps({"training_phases_s": time.perf_counter() - t0,
                          "card": card}), flush=True)
        torch.cuda.empty_cache()
        timed("resume", resume_phase, torch, np, root,
              os.path.join(tmp, "resume_out"), card)
    torch.cuda.empty_cache()
    timed("bench", bench_phase)
    torch.cuda.empty_cache()
    timed("drift", drift_phase)
    torch.cuda.empty_cache()
    serve = timed("serve", serve_phase, torch, np, fb, st, card)
    torch.cuda.empty_cache()
    exported = timed("export", export_phase, torch, np, fb, st, annot, card,
                     here)
    torch.cuda.empty_cache()
    meshed = timed("mesh", mesh_phase, torch, np, fb, st, annot, card)
    torch.cuda.empty_cache()
    timed("dp", dp_phase, card)
    torch.cuda.empty_cache()
    gate = timed("gate", gate_phase, torch, np, fb, st, card)
    torch.cuda.empty_cache()
    timed("scratch", scratch_phase, card)
    torch.cuda.empty_cache()
    trained = timed("trained_loop", trained_loop_phase, torch, card)

    assert sum(PER_FORWARD.values()) == result["launches_per_forward"]
    print(json.dumps({"earlier": EARLIER}), flush=True)
    entries = []
    for w48_rows, launches, name, replaces in (
            (rows, result["launches"], "fused_basic_block",
             "egonet_tpu/ops/pallas_block.py:189"),
            (srows, sresult["launches"], "fused_basic_block_stencil",
             "egonet_tpu/ops/pallas_block_stencil.py:160")):
        entry = _kernel_entry(w48_rows, launches, name=name, route="cuda",
                              source=f"egonet_tpu_torch/csrc/{name}.cu",
                              replaces=replaces,
                              op=f"egonet::{name}, registered in "
                                 "egonet_tpu_torch/csrc/egonet_ops.cpp and "
                                 "egonet_ops_cuda.cpp")
        entry["max_abs_err"] = max(r["max_abs_err"]
                                   for r in w48_rows + ped_rows[name])
        entry["shapes"] = _shapes(w48_rows + ped_rows[name])
        path = "tiled" if name == "fused_basic_block" else "stencil"
        entry["w32_forward"] = _ped_entry(
            ped_rows[name], ped["eval_launches"][path][path])
        # launches of the served W48 micro-batches (serve phase: the whole
        # W48 run for the tiled kernel, the 32-request pass for the
        # stencil) and per call of the exported bucket programs
        served = (serve["run_launches"]["tiled"]
                  if path == "tiled" else serve["stencil"]["launches"][path])
        entry["serve_launches"] = served
        entry["served_batches"] = (serve["run_batches"] if path == "tiled"
                                   else serve["stencil"]["batches"])
        if path == "tiled":
            entry["export_launches_per_call"] = {
                b: r["launches_per_call"]
                for b, r in exported["buckets"].items()}
        # launches of the mesh phase's sharded W48 batch (two shards of 16
        # on cuda:0, 104 each) and of its served micro-batches (tiled)
        entry["mesh_launches"] = meshed[path]["launches"]
        entry["mesh_launches_per_shard"] = meshed[path]["launches_per_shard"]
        if path == "tiled":
            entry["mesh_serve_launches"] = meshed["serve"]["launches"]
        # the gate phase: launches of its bf16 inference runs (per run and
        # per forward) and the kernel at the gate's block shapes
        entry["gate_launches"] = {k: v for k, v in gate["launches"].items()
                                  if k.endswith("/" + path)}
        entry["gate_shapes"] = _shapes(gate["kernel_rows"][name])
        # the trained-loop phase: launches of its bf16 HRNet leg through
        # this kernel, its forwards and launches per forward
        hr = trained["families"]["hrnet"]
        entry["trained_loop_launches"] = {
            "launches": hr["launches"][path][name],
            "forwards": hr["launches"][path]["forwards"],
            "per_forward": hr["launches_per_forward"][name]}
        entry["max_abs_err"] = max(entry["max_abs_err"], max(
            r["max_abs_err"] for r in gate["kernel_rows"][name]))
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    print(json.dumps({"run_s": time.perf_counter() - t_run}), flush=True)
    _print_ok(torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
