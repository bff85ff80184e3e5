"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over every
thread (the facade's dispatches run on a producer thread), its
Chrome trace reduced to what the per-layer readers and the result line
need, then deleted.

The reduction follows ``egonet_tpu_torch/utils/profiling.summarize_trace``
(copied here so that the yardstick stays with the benchmark): each device
event (kernel, copy or memset) is tied through CUPTI's correlation id to
the runtime call that launched it, and so to the host thread and time of
that call; a host span on that thread at that time is the layer it
belongs to.

A dispatch is one ``bench.dispatch:<crops>`` span (the harness's own,
around ``EgoNet.dispatch_annot_dict``) that lies wholly in the trace and
holds the facade's ``host_prep`` and ``d2h`` spans.  For each, the record
keeps its real crops, the ``host_prep`` span's host ms, the device events
it launched, the device ms of those launched inside ``backbone``, and
``span_ms``: the device ms of every launch of the dispatch by the facade
span open on its thread when it was launched (any span but the
harness's own ``bench.*``; ``"none"`` outside them), so that a reader of
a span the facade gains needs no edit here.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import shutil
import sys
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DISPATCH = "bench.dispatch:"


@contextlib.contextmanager
def profiled(out: dict):
    """The body traced by ``torch.profiler`` (every host thread and the
    device); its reduced trace (see :func:`reduce`) lands in ``out``."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        from torch.profiler import _ExperimentalConfig
        kw = {"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        kw = {}
        print("trace: this torch cannot profile every thread; spans of "
              "other threads are missing", file=sys.stderr)
    prof = profile(activities=acts, **kw)
    with prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cats = collections.Counter(e.get("cat") for e in events)
    print(f"trace: {len(events)} events, by category "
          f"{dict(cats.most_common())}", file=sys.stderr, flush=True)
    out.update(reduce(events))


class _Spans:
    """Named [start, end) intervals of one thread, searchable by time."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ev]

    def at(self, ts):
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts <= self.ev[i]["ts"] + self.ev[i]["dur"]:
            return self.ev[i]
        return None

    def within(self, a, b):
        i = bisect.bisect_left(self.starts, a)
        j = bisect.bisect_right(self.starts, b)
        return [e for e in self.ev[i:j] if e["ts"] + e["dur"] <= b]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events) -> dict:
    """{'busy_s', 'window_s', 'dispatches': [{'crops', 'host_prep_ms',
    'launches', 'backbone_ms', 'span_ms': {span: ms}}], 'device_ops':
    [[name, s]] (top 10), 'idle_gaps': [[host span open, s]] (top 10)}."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    if not dev:
        return {}
    # the window runs from the first device event to the end of the last:
    # before the first, the profiler itself is starting (CUPTI records
    # nothing while it does)
    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e["dur"] for e in dev)
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(b - a for a, b in busy)

    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] / 1e6
    gaps = []
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_open_span(spans, a, b), (b - a) / 1e6] for a, b in gaps[:10]]

    # launches: correlation id -> (thread, time) of the runtime call
    launch = {}
    calls = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], e["ts"])
    by_thread = collections.defaultdict(list)
    for e in spans:
        by_thread[e["tid"]].append(e)
    per_tid = {tid: _Spans(evs) for tid, evs in by_thread.items()}
    for e in dev:
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is not None:
            calls[src[0]].append((src[1], e["dur"]))
    for tid in calls:
        calls[tid].sort()

    dispatches = []
    for tid, sp in per_tid.items():
        for d in sp.ev:
            if not d["name"].startswith(DISPATCH):
                continue
            a, b = d["ts"], d["ts"] + d["dur"]
            inner = sp.within(a, b)
            prep = [e for e in inner if e["name"] == "host_prep"]
            if not prep or not any(e["name"] == "d2h" for e in inner):
                continue
            facade = _Spans([e for e in inner
                             if not e["name"].startswith("bench.")])
            mine = calls.get(tid, [])
            i = bisect.bisect_left(mine, (a, -1))
            j = bisect.bisect_right(mine, (b, float("inf")))
            span_us = collections.defaultdict(float)
            for ts, dur in mine[i:j]:
                span = facade.at(ts)
                span_us["none" if span is None else span["name"]] += dur
            dispatches.append({
                "crops": int(d["name"][len(DISPATCH):]),
                "host_prep_ms": sum(e["dur"] for e in prep) / 1e3,
                "launches": j - i,
                "backbone_ms": span_us.get("backbone", 0.0) / 1e3,
                "span_ms": {k: v / 1e3 for k, v in span_us.items()}})
    return {"busy_s": busy_us / 1e6, "window_s": (t1 - t0) / 1e6,
            "dispatches": dispatches,
            "device_ops": [[k, v] for k, v in by_name.most_common(10)],
            "idle_gaps": idle}


def _open_span(spans, a, b) -> str:
    """The facade span that overlaps the idle gap [a, b) the most, else
    the harness's own ('none' if no span is open during it)."""
    best = {}
    for e in spans:
        ov = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
        own = e["name"].startswith("bench.")
        if ov > 0 and ov > best.get(own, (0.0, ""))[0]:
            best[own] = (ov, e["name"])
    return (best.get(False) or best.get(True) or (0.0, "none"))[1]
