"""Profiling: a step timer, ``torch.profiler`` traces and their summary by
device category, kernel, facade stage and idle gap (port of
``egonet_tpu/utils/profiling.py``).

The facade (``models/egonet.py``) wraps each stage of a batch in a named
range, ``span(name)``, one of :data:`SPANS`; the IGR trainer
(``train/igrs.py``) wraps each stage of a step in one of
:data:`TRAIN_SPANS`.  A range costs about a
microsecond on the host when no profiler runs.  Under :func:`trace` on the
card, CUPTI ties every kernel and copy to the host call that launched it,
so :func:`summarize_trace` can give each stage its device time, the way the
JAX package reads XLA's op metadata.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
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
#                   kernels run here)
#   inverse_affine  local -> screen coordinates
#   lifter          LS-normalize -> FC lifter -> un-normalize
#   rigid           template fit and rigid solve (six_dof_from_cuboids)
#   alpha           the observation angle
#   d2h             the device->host copy of the flat output
#   finalize        waiting for that copy and regrouping per image
SPANS = ("host_prep", "h2d", "warp", "normalize", "backbone",
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

TRACE_FILE = "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """The named range of one facade or train-step stage (``name`` must be
    in SPANS or TRAIN_SPANS)."""
    if name not in SPANS and name not in TRAIN_SPANS:
        raise ValueError(f"unknown span {name!r}; SPANS = {SPANS}, "
                         f"TRAIN_SPANS = {TRAIN_SPANS}")
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling per-step wall-clock statistics (samples/sec logging)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self.steps = 0
        self.total = 0.0

    def tick(self):
        now = time.perf_counter()
        if self._t0 is not None:
            self.total += now - self._t0
            self.steps += 1
        self._t0 = now

    def rate(self, items_per_step: int = 1) -> float:
        if not self.steps:
            return 0.0
        return items_per_step * self.steps / self.total


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the body (CPU activity, plus CUDA activity on the card) and
    write a Chrome trace to ``<log_dir>/trace.json``.  ``device=None``
    means the card.  On the card, raises if the trace holds no kernel."""
    from egonet_tpu_torch.device import resolve_device
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
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
    'idle': {'share', 'busy_ms', 'gaps':
    [(ms, span)] (longest 5)} or None on the CPU, 'text'}."""
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

    def host_span(tid, ts):
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
            name = (host_span(src["tid"], src["ts"]) if src is not None
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
        gaps = []
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append(((b - a) / 1e3, _gap_span(spans, a, b)))
        gaps.sort(key=lambda g: -g[0])
        idle = {"share": 1.0 - busy_us / (t1 - t0),
                "busy_ms": busy_us / 1e3 / iters,
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
        lines.append("longest idle gaps (ms, host span open):")
        lines += [f"  {ms:9.3f}  {s}" for ms, s in idle["gaps"]]
    return {"total_ms": total, "window_ms": window, "by_category": by_cat,
            "launches_by_category": launches, "by_kernel": by_kernel,
            "by_span": by_span, "host_by_span": host_by_span, "idle": idle,
            "text": "\n".join(lines)}


def _gap_span(spans, a, b):
    """The facade span that overlaps the gap [a, b) the most (None if no
    span is open during it)."""
    best, name = 0.0, None
    for e in spans:
        ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
        if ov > best:
            best, name = ov, e["name"]
    return name
