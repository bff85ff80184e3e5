"""The offline driver: a user refining a split, the perception stack
handing over decoded frames.  ``EgoNet.stream_annot_dicts`` (host prep of
batch i+1 on a producer thread while the card runs batch i, ``depth``
batches ahead) over annotation dicts that carry the frames, then
``post_process``, which forms each crop's KITTI label line.

The working set's dispatch groups are cycled.  Set-up runs one whole
cycle (every bucket and canvas the cell uses); the window opens at the
next finished dispatch and counts the real crops of every dispatch whose
label lines are formed before it closes.  Frames are never decoded in the
window: decoding is not what these cells measure.
"""

from __future__ import annotations

import gc
import sys
import threading
import time

import numpy as np
import torch

from benchmark import harness, trace
from benchmark.compare import finite


def wrap_dispatch(model, before=None):
    """Each ``dispatch_annot_dict`` call inside a ``bench.dispatch:<real
    crops>`` span, which the trace reduction reads; ``before()``, when
    given, runs first on the calling thread."""
    inner = model.dispatch_annot_dict

    def dispatch(annot, **kwargs):
        if before is not None:
            before()
        n = sum(len(b) for b in annot["boxes"])
        with torch.profiler.record_function(f"{trace.DISPATCH}{n}"):
            return inner(annot, **kwargs)

    model.dispatch_annot_dict = dispatch


def _quarters(ends):
    """The window's crops per second in each quarter of it, on standard
    error (how steady the rate is inside one run)."""
    span = ends[-1][0]
    rates, last = [], (0.0, 0)
    for q in range(1, 5):
        t, c = max((e for e in ends if e[0] <= span * q / 4), default=last)
        rates.append((c - last[1]) / max(t - last[0], 1e-9))
        last = (t, c)
    print("offline: crops/s by quarter of the window "
          + " ".join(f"{r:.2f}" for r in rates), file=sys.stderr, flush=True)


def run(ctx: harness.Context) -> harness.Outcome:
    tr = ctx.traffic
    wl, hs, lst, ls_stats = harness.prepare(ctx)
    frames = wl.frames_host()
    del wl.frames
    model, kept = harness.build_model(ctx, hs, lst, ls_stats)
    del hs, lst
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    wrap_dispatch(model)
    annots = [{"path": [f"{s:06d}.png" for s in g],
               "images": [frames[s] for s in g],
               "boxes": [wl.boxes[s] for s in g],
               "K": [wl.K] * len(g),
               "raw_txt_format": [wl.raw_txt[s] for s in g]}
              for g in wl.groups]
    crops_of = [sum(len(wl.boxes[s]) for s in g) for g in wl.groups]
    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set():
            yield annots[i % len(annots)]
            i += 1

    stream = model.stream_annot_dicts(
        feed(), depth=int(tr["stream_depth"]), enlarge=float(tr["enlarge"]),
        alpha_mode=tr["alpha_mode"])
    count = [0]
    threads = set(threading.enumerate())

    def take():
        recs = model.post_process(next(stream))
        g = count[0] % len(annots)
        count[0] += 1
        # what is alive now, the records kept for the check among it, goes
        # out of the cyclic collector's view: a full collection would
        # otherwise walk every record kept so far, with the interpreter
        # lock held, a pause that grows through the window and that a
        # user, who writes the label lines and drops them, never pays
        gc.freeze()
        return g, recs

    for _ in annots:                      # one whole cycle: set-up
        take()
    # the window opens at a dispatch's completion and closes at the first
    # completion at or after --seconds: every dispatch in it is whole
    t0 = time.monotonic()
    setup_s = t0 - ctx.t_start
    done, crops, ends = [], 0, []
    while True:
        g, recs = take()
        crops += crops_of[g]
        done.append((g, recs))
        ends.append((time.monotonic() - t0, crops))
        if ends[-1][0] >= ctx.seconds:
            break
    window_s = ends[-1][0]
    _quarters(ends)
    traced = {}
    if ctx.trace:
        with trace.profiled(traced):
            t1 = time.monotonic()
            while time.monotonic() < t1 + float(tr["trace_seconds"]):
                take()
    stop.set()
    # the feed ends at its next item: take what was dispatched before that
    # until the stream ends, so that the producer thread ends by itself and
    # not once the collector, which sees nothing frozen, finds the stream
    for _ in stream:
        pass
    # wait for the producer thread, so that nothing of the program runs
    # once the driver returns
    for t in set(threading.enumerate()) - threads:
        t.join(timeout=120.0)
    ctx.sync()
    gc.unfreeze()

    # every answer of the window: one per box, finite, one label line each
    rows, missing = [], 0
    for g, recs in done:
        for s in wl.groups[g]:
            n = len(wl.boxes[s])
            rec = recs.get(f"{s:06d}.png")
            ok = rec is not None and len(rec["alphas"]) == n \
                and rec.get("pred_str", "").count("\n") == n - 1
            if ok:
                ans = harness.answers_of_record(rec)
                ok = finite(*ans)
            if not ok:
                missing += n
                continue
            rows += [(s, j, tuple(a[j] for a in ans)) for j in range(n)]
    pick = harness.sample(len(rows), int(tr["compare_crops"]), ctx.seed)
    rows = [rows[i] for i in pick]
    items = {"frame": np.asarray([s for s, _, _ in rows], np.int64),
             "box": np.asarray([wl.boxes[s][j] for s, j, _ in rows]
                               ).reshape(-1, 4),
             "K": np.repeat(wl.K[None], len(rows), axis=0)}
    outcome = harness.Outcome(
        e2e={"crops_per_s": crops / window_s}, window_s=window_s,
        crops=crops, attempted=crops, failed=missing, missing=missing,
        port=harness.stack_answers([a for _, _, a in rows]) if rows else {},
        items=items,
        frames=frames, weights=kept, trace=traced, setup_s=setup_s)
    del model, stream
    return outcome
