"""The port's bench (``egonet_tpu_torch/tools/bench.py``) against the root
``bench.py`` (its workload draws), its frame writer (the port's PNG
encoder) and its FLOP count (``utils/summary.py``), and its JSON line on
the CPU at the shrunk config."""

import json
import types

import numpy as np
import pytest
import torch

import bench as jax_bench
from egonet_tpu_torch.config import demo_config
from egonet_tpu_torch.data import png
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.tools import bench
from egonet_tpu_torch.utils import summary
from tests import fixtures

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,mean", [(0, 6), (1, 6), (2, 3)])
def test_kitti_like_boxes_match_root_bench(seed, mean):
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(6):                 # the same stream, call after call
        np.testing.assert_array_equal(jax_bench.kitti_like_boxes(rj, mean),
                                      bench.kitti_like_boxes(rt, mean))


@pytest.mark.parametrize("batch", [8, 32])
def test_core_inputs_match_root_bench(batch):
    stub = types.SimpleNamespace(resolution=(256, 256),
                                 _upload=lambda a: torch.from_numpy(a))
    images_j, meta_j = jax_bench.build_core_inputs(stub, batch)
    images_t, meta_t, idx = bench.build_core_inputs(stub, batch)
    np.testing.assert_array_equal(np.asarray(images_j), images_t.numpy())
    np.testing.assert_array_equal(np.asarray(meta_j), meta_t.numpy())
    np.testing.assert_array_equal(idx, np.asarray(meta_j)[:, 8])


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (37, 61)])
def test_png_encoder_round_trips(tmp_path, shape):
    img = np.random.RandomState(sum(shape)).randint(
        0, 256, (*shape, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(png.encode(img))
    np.testing.assert_array_equal(png.decode(str(path)), img)
    assert png.image_size(str(path)) == (shape[1], shape[0])


def test_bench_frame_round_trips(tmp_path):
    frame = bench._frame(np.random.RandomState(1))
    assert frame.shape == (375, 1242, 3) and frame.dtype == np.uint8
    path = tmp_path / "f.png"
    path.write_bytes(png.encode(frame))
    np.testing.assert_array_equal(png.decode(str(path)), frame)


def _conv_flops(model, rows):
    """2 x output elements x (Cin/groups x kh x kw), from each module's own
    weight shape."""
    mods = dict(model.named_modules())
    total = 0
    for r in rows:
        w = mods[r["name"]].weight
        total += 2 * int(np.prod(r["out"])) * int(np.prod(w.shape[1:]))
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_summary_flops_are_analytic(dtype):
    cfg = fixtures.shrink_hrnet(demo_config())
    model = EgoNet(cfg, dtype=dtype, device="cpu")
    x = torch.randn(2, 3, 64, 64)
    s = summary.model_summary(model.hrnet, x)
    rows = summary.layer_rows(model.hrnet, x)
    assert rows and all(r["name"] != "?" for r in rows)
    assert s["flops"] == _conv_flops(model.hrnet, rows)
    assert s["params"] == summary.count_params(model.hrnet)
    # the lifter: 66 -> 1024, two residual blocks of two 1024 x 1024
    # linears, 1024 -> 96
    fc = cfg["FCModel"]
    n = fc["num_neurons"]
    macs = fc["input_size"] * n + 4 * n * n + n * fc["output_size"]
    assert summary.model_summary(model.lifter, torch.randn(3, 66))[
        "flops"] == 2 * 3 * macs
    # the fused blocks count as their plain version: the same FLOPs either
    # way, and the model's switch is restored
    assert model.hrnet.fuse_blocks
    text = summary.per_layer_summary(model.hrnet, x, depth=1)
    assert f"{s['flops']:,}" in text and "stage4.0" in text


@pytest.fixture(scope="module")
def cpu_model():
    return EgoNet(fixtures.shrink_hrnet(demo_config()),
                  dtype=torch.bfloat16, device="cpu")


@pytest.fixture(scope="module")
def cpu_line():
    cfg = fixtures.shrink_hrnet(demo_config())
    env = {"BENCH_BATCH": "4,8", "BENCH_ITERS": "1", "BENCH_WARMUP": "1",
           "BENCH_E2E": "0"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        from contextlib import redirect_stdout
        import io
        buf = io.StringIO()
        with redirect_stdout(buf):
            line = bench.main(cfgs=cfg, device="cpu",
                              native_cfgs=fixtures.shrink_tpu_native(
                                  demo_config()))
    return line, buf.getvalue()


KEYS = ("metric", "value", "unit", "batch", "w48_crops_per_sec", "windows",
        "sync_crops_per_sec", "flops_per_crop", "mfu", "by_batch",
        "act_quant", "fuse_merge", "tpu_native_crops_per_sec",
        "tpu_native_vs_w48", "tpu_native_flops_per_crop", "tpu_native_mfu",
        "tpu_native_by_batch", "headline_family", "best_gated_crops_per_sec",
        "device", "card")
E2E_KEYS = ("e2e_crops_per_sec", "e2e_windows", "e2e_cold_crops_per_sec",
            "e2e_vs_core", "e2e_transport", "h2d_kb_per_crop",
            "h2d_mb_per_sec")


def test_bench_prints_one_json_line(cpu_line):
    line, out = cpu_line
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(json.dumps(line))
    for k in KEYS:
        assert k in line, k
    assert not any(k in line for k in E2E_KEYS)       # BENCH_E2E=0
    assert line["batch"] == 8 and sorted(line["by_batch"]) == ["4", "8"]
    assert line["value"] == line["by_batch"]["8"]["crops_per_sec"] > 0
    w = line["windows"]
    assert w["n"] == bench.REPEATS == 5
    assert w["min"] <= line["value"] <= w["max"]
    # the native half, and the root bench's headline over both families
    nat = line["tpu_native_by_batch"]
    assert sorted(nat) == ["4", "8"]
    assert line["tpu_native_crops_per_sec"] == nat["8"]["crops_per_sec"] > 0
    assert line["tpu_native_vs_w48"] == pytest.approx(
        line["tpu_native_crops_per_sec"] / line["value"])
    assert line["tpu_native_flops_per_crop"] > 0
    best = max(line["value"], line["tpu_native_crops_per_sec"])
    assert line["best_gated_crops_per_sec"] == best
    assert line["headline_family"] == (
        "hrnet_w48_parity" if best == line["value"] else "tpu_native_stride8")
    assert line["act_quant"] == "none" and not line["fuse_merge"]


def test_bench_cpu_line_has_no_device_metrics(cpu_line, cpu_model):
    line, _ = cpu_line
    assert line["device"] == "cpu" and line["card"] is None
    assert line["mfu"] is None and line["flops_per_crop"] > 0
    assert line["tpu_native_mfu"] is None
    e2e = bench.e2e_fields(cpu_model, 100.0, epochs=1, n_images=3,
                           repeats=2)
    assert sorted(e2e) == sorted(E2E_KEYS)
    assert e2e["h2d_mb_per_sec"] is None and e2e["h2d_kb_per_crop"] > 0
    assert e2e["e2e_vs_core"] == pytest.approx(
        e2e["e2e_crops_per_sec"] / 100.0)


def test_bench_e2e_windows(tmp_path, cpu_model):
    """Every crop of the warm-up, the cold epoch and the timed windows is
    counted; the median lies within the windows' spread."""
    r = bench.bench_e2e(cpu_model, str(tmp_path), epochs=1, n_images=3,
                        repeats=2)
    annots = bench.build_e2e_dataset(str(tmp_path / "frames_torch"), 3, 6)
    per_epoch = sum(len(a["boxes"]) for a in annots)
    cold = cpu_model.image_store is not None
    assert r["n"] == 2
    assert r["crops_done"] == per_epoch * (1 + cold + 2)
    assert r["min"] <= r["crops_per_sec"] <= r["max"]
    assert (r["cold_crops_per_sec"] is not None) == cold


def test_bench_w48_switches_of_the_root_bench(monkeypatch):
    """BENCH_ACT_QUANT / BENCH_FUSE_MERGE reach the model (as in the root
    bench); BENCH_NATIVE=0 leaves the native half out."""
    from contextlib import redirect_stdout
    import io
    env = {"BENCH_BATCH": "4", "BENCH_ITERS": "1", "BENCH_WARMUP": "1",
           "BENCH_E2E": "0", "BENCH_NATIVE": "0", "BENCH_ACT_QUANT": "int8",
           "BENCH_FUSE_MERGE": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    built = []
    real = bench.bench_core
    monkeypatch.setattr(bench, "bench_core", lambda model, *a: built.append(
        model.hrnet) or real(model, *a))
    with redirect_stdout(io.StringIO()):
        line = bench.main(cfgs=fixtures.shrink_hrnet(demo_config()),
                          device="cpu")
    assert line["act_quant"] == "int8" and line["fuse_merge"]
    assert len(built) == 1
    assert built[0].act_quant == "int8" and built[0].fuse_merge
    assert "tpu_native_crops_per_sec" not in line
    assert line["headline_family"] == "hrnet_w48_parity"
