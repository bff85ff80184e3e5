"""The trace reduction on hand-made Chrome traces: device events tied to
the dispatch and the span that launched them, each dispatch's device time
split by facade span, busy and idle time, and the idle gaps named by the
host span open during them."""

import collections
import hashlib
import itertools
import json
import random

import pytest

from benchmark import run, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce():
    events = [
        _x("user_annotation", "bench.dispatch:5", 0, 100),
        _x("user_annotation", "host_prep", 0, 10),
        _x("user_annotation", "backbone", 20, 30),
        _x("user_annotation", "d2h", 90, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 91, 1, corr=3),
        _x("kernel", "conv", 30, 30, tid=7, corr=1),
        _x("kernel", "lifter", 70, 10, tid=7, corr=2),
        _x("gpu_memcpy", "Memcpy DtoH", 92, 4, tid=7, corr=3),
        # another thread's launch: not this dispatch's
        _x("cuda_runtime", "cudaLaunchKernel", 40, 1, tid=2, corr=4),
        _x("kernel", "other", 150, 50, tid=7, corr=4),
        # a dispatch cut by the trace's end (no d2h): not counted
        _x("user_annotation", "bench.dispatch:9", 160, 40),
        _x("user_annotation", "host_prep", 160, 5),
    ]
    out = trace.reduce(events)
    assert out["window_s"] == pytest.approx(170e-6)   # first to last
    #                                                   device event
    assert out["busy_s"] == pytest.approx(94e-6)
    assert out["dispatches"] == [{
        "crops": 5, "host_prep_ms": 0.01, "launches": 3, "backbone_ms": 0.03,
        "span_ms": {"backbone": 0.03, "none": 0.01, "d2h": 0.004}}]
    assert out["device_ops"][0] == ["other", pytest.approx(50e-6)]
    # idle [60, 70), [80, 92), [96, 150): longest first, each named by
    # the facade span over it, else the harness's own
    assert [(name, round(s * 1e6)) for name, s in out["idle_gaps"]] == [
        ("bench.dispatch:5", 54), ("d2h", 12), ("bench.dispatch:5", 10)]


FACADE = ("host_prep", "h2d", "warp", "normalize", "backbone",
          "inverse_affine", "lifter", "rigid", "alpha", "d2h")


def _pipeline(seed, dispatches=4):
    """A seeded trace: a producer thread (tid 1) runs ``dispatches``
    dispatches, each the facade's spans in turn with launches inside them
    and in the gaps between them (under the harness's span alone), then
    one without its ``d2h``, as the trace's end cuts one; a consumer
    thread (tid 2) launches inside its own spans meanwhile.  Returns the
    events and, for each whole dispatch, the device us of the producer's
    launches by the span open when each was made."""
    rng = random.Random(seed)
    events, truth, corr = [], [], itertools.count(1)
    free = {7: 0, 8: 0}                  # each stream is free from here

    def launch(tid, ts, stream):
        c = next(corr)
        dur = rng.randint(1, 8)
        start = max(free[stream], ts + rng.randint(1, 5))
        free[stream] = start + dur
        events.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
                         corr=c))
        events.append(_x(rng.choice(trace.DEVICE_CATS),
                         f"k{rng.randint(0, 5)}", start, dur, tid=stream,
                         corr=c))
        return dur

    t = 0
    for k in range(dispatches + 1):
        a, spent = t, collections.Counter()
        names = FACADE if k < dispatches else FACADE[:4]
        for name in names:
            if rng.random() < 0.5:       # a launch between two spans
                spent["none"] += launch(1, t + 1, 7)
                t += 3
            n = rng.randint(0, 4)
            events.append(_x("user_annotation", name, t, 4 * n + 2))
            for i in range(n):
                spent[name] += launch(1, t + 1 + 4 * i, 7)
            t += 4 * n + 3
        events.append(_x("user_annotation", f"{trace.DISPATCH}{k + 1}", a,
                         t - a))
        if k < dispatches:
            truth.append(dict(spent))
        t += rng.randint(1, 20)
    for name in ("finalize", "post_process") * dispatches:
        ts = rng.randint(0, t)
        events.append(_x("user_annotation", name, ts, 6, tid=2))
        launch(2, ts + 2, 8)
    rng.shuffle(events)
    return events, truth


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_span_ms_splits_the_dispatch(seed):
    """Each launch of a dispatch counted once, under the facade span open
    on its thread, or 'none' under the harness's span alone; the other
    thread's launches in none of them; backbone_ms the same number."""
    events, truth = _pipeline(seed)
    ds = sorted(trace.reduce(events)["dispatches"], key=lambda d: d["crops"])
    assert [d["crops"] for d in ds] == list(range(1, len(truth) + 1))
    for d, spent in zip(ds, truth):
        assert d["span_ms"] == pytest.approx(
            {k: v / 1e3 for k, v in spent.items()}, rel=1e-12)
        assert set(d["span_ms"]) <= set(FACADE) | {"none"}
        assert sum(d["span_ms"].values()) == pytest.approx(
            sum(spent.values()) / 1e3, rel=1e-12)
        assert d["span_ms"].get("backbone", 0.0) == d["backbone_ms"]


# the reduction before span_ms, on _pipeline(5): sha256 of its output as
# json.dumps(..., sort_keys=True), first 16 hex digits
GOLDEN = "4e2a13790862e974"


def test_other_fields_read_as_before():
    """Everything but span_ms reads as the reduction read before it kept
    span_ms: the digest of that reduction's output for _pipeline(5)."""
    out = trace.reduce(_pipeline(5)[0])
    for d in out["dispatches"]:
        del d["span_ms"]
    text = json.dumps(out, sort_keys=True)
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == GOLDEN


def test_warp_ms_reads_the_warp_span():
    read = run.reader("warp_ms.offline")
    ds = [{"span_ms": {"warp": 12.0, "backbone": 90.0}},
          {"span_ms": {"warp": 14.0, "none": 0.5}},
          {"span_ms": {"backbone": 88.0}}]
    assert read({"trace": {"dispatches": ds}}) == pytest.approx(26.0 / 3)
    assert read({"trace": {"dispatches": ds[2:]}}) is None
    assert read({"trace": {"dispatches": []}}) is None
    assert read({"trace": {}}) is None
