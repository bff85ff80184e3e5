"""The port's profiling module (``egonet_tpu_torch/utils/profiling.py``):
the step timer against the JAX package's, a CPU trace of the shrunk
facade read back by ``summarize_trace``, and the device-side bookkeeping
(categories, spans through CUPTI correlation ids, idle gaps) on a
hand-written Chrome trace of the shape ``torch.profiler`` writes on the
card."""

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


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_step_timer_matches_jax(impl, monkeypatch):
    """Both timers give the same steps and rate on the same clock."""
    from egonet_tpu.utils import profiling as jax_profiling
    mod = jax_profiling if impl == "jax" else profiling
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
    s = profiling.summarize_trace(cpu_trace, iters=2)
    assert list(s["by_span"]) == list(profiling.SPANS)
    for name, ms in s["by_span"].items():
        assert ms > 0, name
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
    assert set(profiling.SPANS) <= names


def test_span_names_are_fixed():
    with pytest.raises(ValueError):
        profiling.span("not_a_stage")
    assert len(set(profiling.SPANS)) == len(profiling.SPANS) == 11


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
    device-side range it lies in; idle gaps are named by the open span."""
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
    assert s["idle"]["gaps"][0] == (pytest.approx(0.015), "rigid")
    assert s["idle"]["gaps"][1] == (pytest.approx(0.01), "backbone")
