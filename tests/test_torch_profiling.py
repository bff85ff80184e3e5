"""The port's profiling module (``egonet_tpu_torch/utils/profiling.py``):
the spans' always-on totals (two threads, wall against thread CPU,
reset), CPU traces of the shrunk facade read back by ``summarize_trace``
(one batch at a time, and pipelined through ``stream_annot_dicts`` with
``post_process``), and the device-side bookkeeping (categories, spans
through CUPTI correlation ids, idle gaps and their causes) on
hand-written Chrome traces of the shape ``torch.profiler`` writes on the
card; and the JAX package's step timer."""

import json
import os

import numpy as np
import pytest
import torch

from egonet_tpu_torch.config import demo_config
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.utils import profiling
from tests import fixtures

torch.set_num_threads(1)


def test_step_timer_matches_jax(monkeypatch):
    """The JAX package's step timer on a fixed clock: steps, rate, reset
    (the port keeps totals per span instead: the tests below)."""
    from egonet_tpu.utils import profiling as mod
    clock = iter([1.0, 1.5, 2.5, 3.0])
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    t = mod.StepTimer()
    assert t.rate(10) == 0.0
    for _ in range(4):
        t.tick()
    assert t.steps == 3 and t.total == pytest.approx(2.0)
    assert t.rate(10) == pytest.approx(15.0)
    t.reset()
    assert t.steps == 0 and t.rate() == 0.0


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """Two batches of the shrunk facade, dispatch -> finalize, traced."""
    cfg = fixtures.shrink_hrnet(demo_config())
    model = EgoNet(cfg, device="cpu")
    rng = np.random.RandomState(0)
    annot = {"path": ["a.png", "b.png"],
             "images": [rng.randint(0, 255, (375, 1242, 3), np.uint8)
                        for _ in range(2)],
             "boxes": [np.array([[100.0, 120, 260, 220],
                                 [500, 150, 600, 230]]),
                       np.array([[700.0, 130, 900, 260]])]}
    model.forward_annot_dict(annot)
    log_dir = str(tmp_path_factory.mktemp("trace"))
    with profiling.trace(log_dir, "cpu"):
        for _ in range(2):
            model.forward_annot_dict(annot)
    return log_dir


def test_cpu_trace_has_every_span(cpu_trace):
    """Every span of the HRNet's facade holds time, but ``readout``: a
    'coordinates' head opens none."""
    s = profiling.summarize_trace(cpu_trace, iters=2)
    assert list(s["by_span"]) == list(profiling.SPANS)
    for name, ms in s["by_span"].items():
        assert ms == 0 if name == "readout" else ms > 0, name
    # the spans do not overlap, so their host time fits in the window
    assert sum(s["by_span"].values()) <= s["window_ms"]
    assert s["idle"] is None and s["by_category"] == []
    assert s["host_by_span"] == s["by_span"]
    for name in profiling.SPANS:
        assert name in s["text"]


def test_trace_file_is_chrome_json(cpu_trace):
    with open(os.path.join(cpu_trace, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(profiling.SPANS) - {"readout"} <= names
    assert "readout" not in names


def test_span_names_are_fixed():
    with pytest.raises(ValueError):
        profiling.span("not_a_stage")
    assert len(set(profiling.SPANS)) == len(profiling.SPANS) == 12


@pytest.mark.parametrize("name", sorted(set(
    profiling.SPANS + profiling.TRAIN_SPANS + profiling.PIPELINE_SPANS
    + profiling.SETUP_SPANS)))
def test_every_group_is_a_span(name):
    """span() takes every group's names and counts each closed range."""
    profiling.reset_totals()
    for _ in range(3):
        with profiling.span(name):
            pass
    count, wall, cpu = profiling.totals()[name]
    assert count == 3 and wall > 0.0 and cpu >= 0.0


def test_totals_from_many_threads_lose_nothing():
    """Each thread adds to its own table: more threads than cores, switched
    every microsecond, and every span is counted; the tables of finished
    threads stay in the totals."""
    import sys
    import threading
    profiling.reset_totals()
    n_threads, n_spans = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(name):
            for _ in range(n_spans):
                with profiling.span(name):
                    pass
        threads = [threading.Thread(target=work, args=(
            ("host_prep", "queue_put")[i % 2],)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    # a new thread folds the finished ones' tables; nothing is lost
    t = threading.Thread(target=work, args=("post_process",))
    t.start()
    t.join(timeout=60)
    tot = profiling.totals()
    assert tot["host_prep"][0] == tot["queue_put"][0] == \
        n_spans * n_threads // 2
    assert tot["post_process"][0] == n_spans
    profiling.reset_totals()
    assert profiling.totals() == {}


@pytest.mark.parametrize("kind", ["sleep", "spin"])
def test_totals_split_wall_and_cpu(kind):
    """A span that sleeps reads wall >> thread CPU; one that spins reads
    CPU close to wall."""
    import time
    profiling.reset_totals()
    with profiling.span("host_prep"):
        if kind == "sleep":
            time.sleep(0.05)
        else:
            c0 = time.thread_time()
            while time.thread_time() - c0 < 0.05:
                pass
    count, wall, cpu = profiling.totals()["host_prep"]
    assert count == 1
    if kind == "sleep":
        assert wall >= 0.05 and cpu < 0.5 * wall
    else:
        assert cpu >= 0.05 and cpu >= 0.5 * wall


def test_facade_draws_its_weights_in_one_span():
    profiling.reset_totals()
    EgoNet(fixtures.shrink_hrnet(demo_config()), device="cpu")
    count, wall, cpu = profiling.totals()["init_weights"]
    assert count == 1 and wall > 0.0


def _frames(rng, n):
    return [rng.randint(0, 255, (375, 1242, 3), np.uint8) for _ in range(n)]


def test_pipelined_trace_spans_by_thread(tmp_path):
    """The shrunk facade through ``stream_annot_dicts`` and
    ``post_process``, traced: host prep, the device program's spans and
    the hand-over on the producer thread, ``finalize`` and
    ``post_process`` on the consumer; no two spans of one thread overlap;
    the totals count every batch."""
    model = EgoNet(fixtures.shrink_hrnet(demo_config()), device="cpu")
    rng = np.random.RandomState(1)
    boxes = [np.array([[100.0, 120, 260, 220], [500, 150, 600, 230]]),
             np.array([[700.0, 130, 900, 260]])]
    raw = [[{"class": "Car", "truncation": 0.0, "occlusion": 0,
             "alpha": 0.0, "bbox": [float(v) for v in b],
             "dimensions": [1.5, 1.7, 3.9], "locations": [0.0, 1.6, 20.0],
             "rot_y": 0.0, "score": 0.9} for b in bs] for bs in boxes]
    annots = [{"path": [f"{i}a.png", f"{i}b.png"], "images": _frames(rng, 2),
               "boxes": boxes, "raw_txt_format": raw} for i in range(3)]
    log_dir = str(tmp_path)
    profiling.reset_totals()
    with profiling.trace(log_dir, "cpu"):
        for recs in model.stream_annot_dicts(iter(annots), depth=1):
            recs = model.post_process(recs)
            assert all(r["pred_str"] for r in recs.values())
    tot = profiling.totals()
    for name in ("host_prep", "backbone", "queue_put", "finalize",
                 "post_process"):
        assert tot[name][0] == len(annots), name
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    by_tid = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(e)
    names = {tid: {e["name"] for e in evs} for tid, evs in by_tid.items()}
    producer = next(t for t, n in names.items() if "host_prep" in n)
    consumer = next(t for t, n in names.items() if "post_process" in n)
    assert producer != consumer
    assert names[producer] == {"host_prep", "queue_put"} | set(
        profiling.SPANS[1:11]) - {"readout"}    # h2d ... d2h
    assert names[consumer] == {"finalize", "post_process"}
    for evs in by_tid.values():
        evs.sort(key=lambda e: e["ts"])
        for a, b in zip(evs, evs[1:]):
            assert a["ts"] + a["dur"] <= b["ts"], (a["name"], b["name"])
    s = profiling.summarize_trace(log_dir, iters=len(annots))
    assert s["host_by_span"]["finalize"] > 0 and s["idle"] is None


def test_trace_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path)):
            pass


@pytest.mark.parametrize("name,cat", [
    ("void fused_basic_block_kernel<2, 3, 48>(...)", "fused_basic_block"),
    ("void fused_basic_block_stencil_kernel<1, 2, 3>(...)",
     "fused_basic_block_stencil"),
    ("(anonymous namespace)::rigid_solve_kernel(float const*, float*, int, "
     "int)", "rigid_solve"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float>(...)", "conv"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", "gemm"),
    ("ampere_sgemm_32x32_sliced1x4_nn", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>(...)",
     "elementwise/reduce"),
    ("void at::native::reduce_kernel<512, 1, ...>(...)",
     "elementwise/reduce"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_category(name, cat):
    assert profiling.kernel_category(name) == cat


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_device_trace_summary(tmp_path):
    """Kernels are charged to the span whose host call launched them
    (through the correlation id), a kernel without a launch record to the
    device-side range it lies in; idle gaps are named by what the card
    waited for."""
    ev = [
        _x("user_annotation", "h2d", 0, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 2, 1, corr=1),
        _x("user_annotation", "backbone", 10, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=2),
        _x("cuda_driver", "cuLaunchKernelEx", 14, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 16, 1, corr=4),
        _x("user_annotation", "rigid", 50, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 52, 1, corr=5),
        _x("gpu_user_annotation", "rigid", 60, 30, tid=7),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5, 5, 7, 1),
        _x("kernel", "sm90_xmma_fprop_implicit_gemm_x", 20, 10, 7, 2),
        _x("kernel", "void fused_basic_block_kernel<2,3,48>", 30, 20, 7, 3),
        _x("kernel", "void at::native::elementwise_kernel", 50, 5, 7, 4),
        _x("kernel", "void at::native::reduce_kernel", 70, 10, 7, 5),
        _x("kernel", "jacobi_kernel", 85, 5, 7, 99),
    ]
    with open(tmp_path / profiling.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": ev}, f)
    s = profiling.summarize_trace(str(tmp_path))
    assert s["total_ms"] == pytest.approx(0.055)
    assert s["by_span"]["h2d"] == pytest.approx(0.005)
    assert s["by_span"]["backbone"] == pytest.approx(0.035)
    assert s["by_span"]["rigid"] == pytest.approx(0.015)
    assert s["host_by_span"]["backbone"] == pytest.approx(0.040)
    assert sum(s["by_span"].values()) == pytest.approx(s["total_ms"])
    cats = dict(s["by_category"])
    assert cats["memcpy H2D"] == pytest.approx(0.005)
    assert cats["fused_basic_block"] == pytest.approx(0.020)
    assert cats["conv"] == pytest.approx(0.010)
    assert s["by_kernel"][0][0].startswith("void fused_basic_block")
    # window 0..90 us; busy 5-10, 20-55, 70-80, 85-90 -> 55 us busy
    assert s["idle"]["share"] == pytest.approx(35 / 90)
    # [55, 70): the next kernel was launched at 52, before the gap: queued;
    # [10, 20): launched at 12, while the launcher sat in backbone; [0, 5):
    # in h2d; [80, 85): the next kernel has no launch record
    assert s["idle"]["gaps"][0] == (pytest.approx(0.015), "queued")
    assert s["idle"]["gaps"][1] == (pytest.approx(0.01), "backbone")
    assert s["idle"]["by_cause"] == {
        "queued": pytest.approx(0.015), "backbone": pytest.approx(0.01),
        "h2d": pytest.approx(0.005), "unknown": pytest.approx(0.005)}


def test_idle_gaps_by_cause(tmp_path):
    """The causal rule on a pipelined trace: a producer thread launches,
    the consumer sits in ``post_process`` through every gap (the span
    that overlaps them most).  A gap whose next kernel was launched after
    it began is split over the spans the launching thread was in during
    it; one whose kernel was launched before is 'queued'."""
    ev = [
        _x("user_annotation", "host_prep", 0, 30),
        _x("user_annotation", "h2d", 30, 2),
        _x("cuda_runtime", "cudaMemcpyAsync", 31, 1, corr=1),
        _x("user_annotation", "backbone", 32, 8),
        _x("cuda_runtime", "cudaLaunchKernel", 33, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=3),
        _x("user_annotation", "rigid", 40, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 65, 1, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 68, 1, corr=5),
        _x("user_annotation", "queue_put", 72, 18),
        _x("user_annotation", "post_process", 0, 90, tid=2),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 34, 2, 7, 1),
        _x("kernel", "sm90_xmma_fprop_implicit_gemm_x", 36, 14, 7, 2),
        _x("kernel", "void at::native::elementwise_kernel", 50, 5, 7, 3),
        _x("kernel", "void at::native::reduce_kernel", 66, 4, 7, 4),
        _x("kernel", "void at::native::reduce_kernel", 80, 10, 7, 5),
    ]
    with open(tmp_path / profiling.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": ev}, f)
    s = profiling.summarize_trace(str(tmp_path))
    # busy 34-55, 66-70, 80-90 of 0-90; idle [0, 34) while the launcher
    # sat in host_prep (30), h2d (2) and backbone (2), [55, 66) in rigid,
    # [70, 80) already enqueued
    assert s["idle"]["share"] == pytest.approx(55 / 90)
    assert s["idle"]["gaps"] == [(pytest.approx(0.034), "host_prep"),
                                 (pytest.approx(0.011), "rigid"),
                                 (pytest.approx(0.010), "queued")]
    assert s["idle"]["by_cause"] == {
        "host_prep": pytest.approx(0.030), "rigid": pytest.approx(0.011),
        "queued": pytest.approx(0.010), "h2d": pytest.approx(0.002),
        "backbone": pytest.approx(0.002)}
    assert "idle by cause" in s["text"]


def test_idle_gap_launched_by_a_thread_without_spans(tmp_path):
    """Kernels autograd launches from its own thread: the gap is split over
    the spans of the thread that had one open when it began ('none' for
    the rest)."""
    ev = [
        _x("user_annotation", "backward", 0, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 1, 1, tid=9, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, tid=9, corr=2),
        _x("kernel", "void at::native::reduce_kernel", 2, 3, 7, 1),
        _x("kernel", "void at::native::reduce_kernel", 25, 5, 7, 2),
    ]
    with open(tmp_path / profiling.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": ev}, f)
    s = profiling.summarize_trace(str(tmp_path), spans=profiling.TRAIN_SPANS)
    assert s["by_span"]["backward"] == pytest.approx(0.003)
    # [0, 2) before the first kernel: launched at 1, inside backward
    assert s["idle"]["by_cause"] == {"backward": pytest.approx(0.017),
                                     "none": pytest.approx(0.005)}
    assert s["idle"]["gaps"][0] == (pytest.approx(0.020), "backward")
