"""The trace reduction on a hand-made Chrome trace: device events tied to
the dispatch and the span that launched them, busy and idle time, and
the idle gaps named by the host span open during them."""

import pytest

from benchmark import trace


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
    assert out["dispatches"] == [{"crops": 5, "host_prep_ms": 0.01,
                                  "launches": 3, "backbone_ms": 0.03}]
    assert out["device_ops"][0] == ["other", pytest.approx(50e-6)]
    # idle [60, 70), [80, 92), [96, 150): longest first, each named by
    # the facade span over it, else the harness's own
    assert [(name, round(s * 1e6)) for name, s in out["idle_gaps"]] == [
        ("bench.dispatch:5", 54), ("d2h", 12), ("bench.dispatch:5", 10)]
