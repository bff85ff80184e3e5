"""Profiling: named stage ranges with always-on totals, ``torch.profiler``
traces and their summary by device category, kernel, facade stage and
idle gap (port of ``egonet_tpu/utils/profiling.py``).

The facade (``models/egonet.py``) wraps each stage of a batch in a named
range, ``span(name)``, one of :data:`SPANS`; the IGR trainer
(``train/igrs.py``) wraps each stage of a step in one of
:data:`TRAIN_SPANS`; the pipeline around the facade and its set-up use
:data:`PIPELINE_SPANS` and :data:`SETUP_SPANS`.  A span is one
``torch.profiler.record_function`` range, which costs about ten
microseconds on the host when no profiler runs, and it adds its wall and
thread-CPU time to its thread's totals (:func:`totals`), which a run reads
without a profiler.  Under :func:`trace` on the card, CUPTI ties every
kernel and copy to the host call that launched it, so
:func:`summarize_trace` can give each stage its device time, the way the
JAX package reads XLA's op metadata, and name what the card waited for in
each idle gap.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import threading
import time

import torch

# The facade's stages, in the order a batch passes through them:
#   host_prep       dispatch_annot_dict up to the upload (crop matrices,
#                   packing, meta)
#   h2d             the pinned host->device copies of frames and meta
#   warp            the separable crop warp
#   normalize       crop normalization (mean / std)
#   backbone        the keypoint model (HRNet, PoseNetTPU) with its
#                   'coordinates' head (the HRNet's fused BasicBlock
#                   kernels run here), or a model with a 'heatmap' head
#                   (PoseResNet) up to its maps
#   readout         a 'heatmap' head's maps to coordinates (soft-argmax);
#                   a 'coordinates' head opens no such span
#   inverse_affine  local -> screen coordinates
#   lifter          LS-normalize -> FC lifter -> un-normalize
#   rigid           template fit, rigid solve and euler angles: one launch
#                   of the operator egonet::rigid_solve (ops/rigid_solve.py)
#   alpha           the observation angle
#   d2h             the device->host copy of the flat output
#   finalize        waiting for that copy and regrouping per image
SPANS = ("host_prep", "h2d", "warp", "normalize", "backbone", "readout",
         "inverse_affine", "lifter", "rigid", "alpha", "d2h", "finalize")

# The IGR train step's stages, in order:
#   h2d        the pinned host->device copies of the batch
#   warp       the separable crop warp of every instance
#   normalize  crop normalization (mean / std)
#   forward    the train-mode HRNet forward
#   targets    the Gaussian heatmap targets
#   loss       the composite loss
#   backward   autograd's backward pass (its kernels launch from autograd's
#              own thread while this range is open on the caller's)
#   optimizer  the Adam / SGD update
TRAIN_SPANS = ("h2d", "warp", "normalize", "forward", "targets", "loss",
               "backward", "optimizer")

# Around the facade's batches:
#   post_process  EgoNet.post_process: the KITTI label lines (consumer)
#   queue_put     utils/pipeline.prefetch_map's producer handing a finished
#                 item over: blocked while the consumer is behind
PIPELINE_SPANS = ("post_process", "queue_put")

# Set-up:
#   init_weights  EgoNet.__init__'s numpy draw of every weight
SETUP_SPANS = ("init_weights",)

_NAMES = frozenset(SPANS + TRAIN_SPANS + PIPELINE_SPANS + SETUP_SPANS)

# Each thread's totals, {name: [count, wall ns, thread-CPU ns]}, written by
# that thread alone, so the hot path takes no lock and loses no update;
# the tables of finished threads are folded into _retired when a thread
# registers, and reset_totals() moves the baseline that totals() subtracts.
_local = threading.local()
_lock = threading.Lock()
_tables: list = []                 # [(thread, its table)]
_retired: dict = {}
_baseline: dict = {}


def _table() -> dict:
    table = getattr(_local, "table", None)
    if table is None:
        table = _local.table = {}
        with _lock:
            live = []
            for thread, t in _tables:
                if thread.is_alive():
                    live.append((thread, t))
                else:
                    _add_into(_retired, t)
            live.append((threading.current_thread(), table))
            _tables[:] = live
    return table


def _add_into(dst: dict, src: dict, sign: int = 1) -> None:
    for name, row in list(src.items()):
        acc = dst.setdefault(name, [0, 0, 0])
        for i in range(3):
            acc[i] += sign * row[i]


def _merged() -> dict:
    """Every thread's totals summed (the caller holds ``_lock``)."""
    merged: dict = {}
    _add_into(merged, _retired)
    for _, table in _tables:
        _add_into(merged, table)
    return merged


class _Span:
    """One stage's ``record_function`` range, timed into the thread's
    totals."""

    __slots__ = ("name", "_range", "_wall", "_cpu")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        # the wall interval holds the CPU one: wall >= CPU where the
        # thread clock is fine (one that counts scheduler ticks charges a
        # short span a whole tick or none)
        self._wall = time.perf_counter_ns()
        self._cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        cpu = time.thread_time_ns() - self._cpu
        wall = time.perf_counter_ns() - self._wall
        table = _table()
        row = table.get(self.name)
        if row is None:
            row = table[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += wall
        row[2] += cpu
        return self._range.__exit__(*exc)


def span(name: str) -> _Span:
    """The named range of one stage (``name`` must be in SPANS,
    TRAIN_SPANS, PIPELINE_SPANS or SETUP_SPANS)."""
    if name not in _NAMES:
        raise ValueError(f"unknown span {name!r}; SPANS = {SPANS}, "
                         f"TRAIN_SPANS = {TRAIN_SPANS}, PIPELINE_SPANS = "
                         f"{PIPELINE_SPANS}, SETUP_SPANS = {SETUP_SPANS}")
    return _Span(name)


def totals() -> dict:
    """{name: (count, wall s, thread-CPU s)} of every span closed in this
    process since the last :func:`reset_totals`, over all threads.  Wall
    minus CPU is the time the thread spent off the CPU inside the span:
    waiting for the interpreter lock, another lock, I/O or the
    scheduler.  Where the thread clock counts scheduler ticks (10 ms on
    the H100 machines measured), CPU is a sample: read it over many
    spans."""
    with _lock:
        merged = _merged()
        _add_into(merged, _baseline, -1)
    return {name: (c, wall / 1e9, cpu / 1e9)
            for name, (c, wall, cpu) in merged.items() if c}


def reset_totals() -> None:
    """Start the totals from zero."""
    with _lock:
        merged = _merged()
        _baseline.clear()
        _baseline.update(merged)


TRACE_FILE = "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the body (CPU activity on every thread, so a pipeline's
    producer thread too, plus CUDA activity on the card) and write a
    Chrome trace to ``<log_dir>/trace.json``.  ``device=None`` means the
    card.  On the card, raises if the trace holds no kernel."""
    from egonet_tpu_torch.device import resolve_device
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch.profiler import _ExperimentalConfig
        kw = {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):          # a torch without the option
        kw = {}
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, **kw) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if dev.type == "cuda":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if not any(e.get("cat") == "kernel" for e in events):
            raise RuntimeError(f"{path}: the profiler recorded no CUDA "
                               "kernel (is CUPTI tracing available?)")


def kernel_category(name: str) -> str:
    """The category of a device kernel, from its name."""
    low = name.lower()
    if "fused_basic_block_stencil" in low:
        return "fused_basic_block_stencil"
    if "fused_basic_block" in low:
        return "fused_basic_block"
    if "rigid_solve" in low:
        return "rigid_solve"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "implicit", "winograd", "nchwtonhwc",
                              "nhwctonchw")):
        return "conv"
    if any(k in low for k in ("gemm", "gemv", "cublas", "cutlass", "matmul",
                              "dot_kernel", "splitk")):
        return "gemm"
    if any(k in low for k in ("elementwise", "reduce", "vectorized",
                              "unrolled", "index", "cat", "copy", "softmax",
                              "norm", "scatter", "gather", "fill", "sort",
                              "at::native")):
        return "elementwise/reduce"
    return "other"


def _device_category(e) -> str:
    if e["cat"] == "gpu_memset":
        return "memset"
    if e["cat"] == "gpu_memcpy":
        name = e["name"]
        for tag, cat in (("HtoD", "memcpy H2D"), ("DtoH", "memcpy D2H")):
            if tag in name:
                return cat
        return "memcpy D2D"
    return kernel_category(e["name"])


class _Intervals:
    """Named [start, end) intervals of one thread (non-overlapping, as the
    facade's spans are), searchable by time."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ev]

    def at(self, ts):
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts <= self.ev[i]["ts"] + self.ev[i]["dur"]:
            return self.ev[i]["name"]
        return None

    def split(self, a, b) -> collections.Counter:
        """[a, b) split by the intervals over it ('none' outside them)."""
        out = collections.Counter()
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        for e in self.ev[i:bisect.bisect_left(self.starts, b)]:
            ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if ov > 0:
                out[e["name"]] += ov
        out["none"] += (b - a) - sum(out.values())
        return +out


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize_trace(log_dir: str, iters: int = 1, spans=SPANS) -> dict:
    """Aggregate ``<log_dir>/trace.json`` (written by :func:`trace`).
    ``iters``: how many identical steps the trace covers (times and counts
    are divided by it); ``spans``: the stage names to charge time to
    (:data:`SPANS`, or :data:`TRAIN_SPANS` for a train step).

    Returns {'total_ms': device busy ms per step (on the CPU: the window's
    ms), 'window_ms', 'by_category': [(category, ms)],
    'launches_by_category': {category: kernels or copies per step},
    'by_kernel': [(name, ms, launches)] (top 10), 'by_span': {span:
    ms} (device ms of the kernels and copies each facade stage launched;
    on the CPU, the stage's host ms), 'host_by_span': {span: host ms},
    'idle': {'share', 'busy_ms', 'by_cause': {cause: ms per step},
    'gaps': [(ms, cause)] (longest 5)} or None on the CPU, 'text'}.

    An idle gap's cause is what the card waited for: follow the device
    event that ends the gap to the host call that launched it.  A launch
    made after the gap began means the card waited for the host: the gap
    is split over the program spans the launching thread was in during it
    (any span of :data:`SPANS`, :data:`TRAIN_SPANS`, :data:`PIPELINE_SPANS`
    or :data:`SETUP_SPANS`; 'none' outside them), and a gap in the list is
    named by the largest part.  A launch made before it is 'queued': the
    work waited on the device's side.  'unknown': no launch record (or no
    device event after the gap)."""
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    names = tuple(spans)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in names]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    everything = spans + dev + [e for e in events
                                if e.get("cat") == "cpu_op"]
    t0 = min(e["ts"] for e in everything)
    t1 = max(e["ts"] + e["dur"] for e in everything)
    window = (t1 - t0) / 1e3 / iters
    per_thread = collections.defaultdict(list)
    for e in spans:
        per_thread[e["tid"]].append(e)
    host = {tid: _Intervals(evs) for tid, evs in per_thread.items()}
    every = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in _NAMES:
            every[e["tid"]].append(e)
    opened = {tid: _Intervals(evs) for tid, evs in every.items()}

    def span_at(tid, ts):
        """The stage open on thread ``tid`` at ``ts``; for a thread with
        none (autograd's), the one open on any thread."""
        if tid in host:
            return host[tid].at(ts)
        hits = [iv.at(ts) for iv in host.values()]
        return next((h for h in hits if h), None)

    host_by_span = dict.fromkeys(names, 0.0)
    for e in spans:
        host_by_span[e["name"]] += e["dur"] / 1e3 / iters
    by_span = dict.fromkeys(names, 0.0)
    if not dev:                                   # CPU-only trace
        by_span = host_by_span
        total, by_cat, by_kernel, idle = window, [], [], None
        launches = {}
    else:
        # each device event's launching host call, through the correlation
        # id CUPTI gives both; its host span is the stage it belongs to
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = e
        gpu_ann = _Intervals([e for e in events
                              if e.get("cat") == "gpu_user_annotation"
                              and e["name"] in names])
        cat_ms = collections.Counter()
        cat_n = collections.Counter()
        kern_ms = collections.Counter()
        kern_n = collections.Counter()
        for e in dev:
            ms = e["dur"] / 1e3 / iters
            cat_ms[_device_category(e)] += ms
            cat_n[_device_category(e)] += 1
            if e["cat"] == "kernel":
                kern_ms[e["name"]] += ms
                kern_n[e["name"]] += 1
            src = launch.get(e.get("args", {}).get("correlation"))
            name = (span_at(src["tid"], src["ts"]) if src is not None
                    else gpu_ann.at(e["ts"]))
            if name is not None:
                by_span[name] += ms
        total = sum(cat_ms.values())
        by_cat = cat_ms.most_common()
        launches = {c: n / iters for c, n in cat_n.items()}
        by_kernel = [(k, ms, kern_n[k] / iters)
                     for k, ms in kern_ms.most_common(10)]
        busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
        busy_us = sum(b - a for a, b in busy)
        first = {}                        # start time -> device event
        for e in sorted(dev, key=lambda e: e["ts"]):
            first.setdefault(e["ts"], e)
        gaps, by_cause = [], collections.Counter()
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                nxt = first.get(b)
                src = launch.get(nxt.get("args", {}).get("correlation")) \
                    if nxt is not None else None
                if src is None or src["ts"] <= a:
                    parts = {"unknown" if src is None else "queued": b - a}
                else:
                    # for a launching thread without spans (autograd's),
                    # a thread with one open when the gap began
                    ivs = opened.get(src["tid"]) or next(
                        (iv for iv in opened.values() if iv.at(a)), None)
                    parts = (ivs.split(a, b) if ivs is not None
                             else {"none": b - a})
                for cause, us in parts.items():
                    by_cause[cause] += us / 1e3 / iters
                gaps.append(((b - a) / 1e3, max(parts, key=parts.get)))
        gaps.sort(key=lambda g: -g[0])
        idle = {"share": 1.0 - busy_us / (t1 - t0),
                "busy_ms": busy_us / 1e3 / iters,
                "by_cause": dict(by_cause.most_common()),
                "gaps": gaps[:5]}

    lines = [f"window: {window:.3f} ms per step"
             + (f"; device busy {total:.3f} ms, idle share "
                f"{idle['share']:.3f}" if idle else " (CPU trace)")]
    if by_cat:
        lines.append("by category (ms per step):")
        lines += [f"  {c:28s} {ms:9.3f}" for c, ms in by_cat]
    lines.append("by span (ms per step: device, host):" if idle
                 else "by span (ms per step, host):")
    lines += [f"  {s:28s} {ms:9.3f}"
              + (f" {host_by_span[s]:9.3f}" if idle else "")
              for s, ms in by_span.items()]
    if by_kernel:
        lines.append(f"top {len(by_kernel)} kernels (ms, launches per step):")
        lines += [f"  {ms:9.3f} {n:7.1f}  {k[:100]}"
                  for k, ms, n in by_kernel]
    if idle:
        lines.append("idle by cause (ms per step):")
        lines += [f"  {c:28s} {ms:9.3f}"
                  for c, ms in idle["by_cause"].items()]
        lines.append("longest idle gaps (ms, cause):")
        lines += [f"  {ms:9.3f}  {c}" for ms, c in idle["gaps"]]
    return {"total_ms": total, "window_ms": window, "by_category": by_cat,
            "launches_by_category": launches, "by_kernel": by_kernel,
            "by_span": by_span, "host_by_span": host_by_span, "idle": idle,
            "text": "\n".join(lines)}

