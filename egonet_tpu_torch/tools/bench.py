"""Benchmark of the port's inference on one card (port of the root
``bench.py``: the W48 half and the native half).  Prints ONE JSON line:

  w48_crops_per_sec      the device program (``EgoNet._core``: warp ->
                         HRNet-W48 -> inverse affine -> lifter -> rigid
                         solve -> alpha) on inputs already on the card,
                         batches enqueued back to back, every output's
                         checksum fetched: the median of REPEATS (5)
                         windows of BENCH_ITERS batches, with their min and
                         max, at each batch of BENCH_BATCH (a comma list;
                         ``value`` is the median at the largest).
  sync_crops_per_sec     one blocking call at a time (per-batch latency).
  flops_per_crop / mfu   FLOPs of one ``_core`` call (FlopCounterMode, the
                         fused blocks counted on their plain version) per
                         crop, in GFLOP, and the achieved rate over the H100
                         SXM dense bf16 peak (bf16 runs only).
  e2e_crops_per_sec      frames on disk -> decode -> host prep -> device ->
                         txt files, pipelined (``stream_annot_dicts``, depth
                         3), warm (decoded frames in the RAM store); the
                         median of REPEATS windows; ``_cold`` with the
                         store emptied first; ``e2e_vs_core`` over the
                         largest batch's core rate.
  h2d_kb_per_crop / h2d_mb_per_sec  frame bytes moved per crop in the e2e
                         loop, and a pinned host->device copy's rate.

  tpu_native_crops_per_sec / _vs_w48 / _flops_per_crop / _mfu
                         the native half of the root bench: the same
                         device program with PoseNetTPU at its defaults
                         (``heatmapModel.name: tpu_native``, ``extra:
                         {}``, i.e. ``config.native_demo_config()``) at the
                         largest batch, and ``tpu_native_by_batch`` at each.
  headline_family / best_gated_crops_per_sec  as the root bench: the faster
                         of the two families ("hrnet_w48_parity" or
                         "tpu_native_stride8") and its rate.  The root
                         bench calls it gated because its closed-loop gate
                         covers both families; the gate's port leg is
                         still queued (ROADMAP).

Environment: BENCH_BATCH (384), BENCH_ITERS (20), BENCH_WARMUP (3),
BENCH_DTYPE (bf16 | fp32), BENCH_E2E (1), BENCH_NATIVE (1), and the root
bench's W48 switches BENCH_ACT_QUANT (e.g. int8) and BENCH_FUSE_MERGE
(1), which the native half inherits as the root bench's does.  The e2e
loop runs over 32 frames, 2 epochs a window.

    python -m egonet_tpu_torch.tools.bench

Runs on the card; ``main(cfgs=..., device="cpu")`` runs it on the CPU,
where the device-only fields (``mfu``, ``h2d_mb_per_sec``) are null.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

H100_BF16_PEAK_FLOPS = 989e12          # SXM, dense
REPEATS = 5             # timed windows per figure: the median, min and max


def build_core_inputs(model, batch, n_img=4, seed=0):
    """(images [n_img, 384, 1280, 3] uint8 on the device, meta [batch,
    META_COLS] on the device, img_idx [batch] host ints), drawn as the root
    bench draws them."""
    from egonet_tpu_torch.models.egonet import pack_meta
    from egonet_tpu_torch.ops import affine
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(n_img, 384, 1280, 3), dtype=np.uint8)
    boxes = np.stack([
        np.array([x, y, x + w, y + h])
        for x, y, w, h in zip(rng.uniform(0, 900, batch),
                              rng.uniform(0, 200, batch),
                              rng.uniform(60, 300, batch),
                              rng.uniform(40, 150, batch))])
    width, height = model.resolution
    mats = affine.crop_matrices_for_boxes(boxes, (height, width),
                                          height / width, 1.1)
    meta = pack_meta(mats["inv"], rng.randint(0, n_img, batch),
                     np.ones(batch), 707.0, 604.0,
                     (images.shape[2], images.shape[1]))
    return (model._upload(images), model._upload(meta),
            meta[:, 8].astype(np.int64))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def bench_core(model, batch, iters, warmup, repeats):
    """Device-program throughput at one batch: {'crops_per_sec' (median of
    ``repeats`` windows), 'min', 'max', 'sync_crops_per_sec', 'flops',
    'step_s' (median seconds per batch)}."""
    from egonet_tpu_torch.utils.summary import count_flops
    args = build_core_inputs(model, batch)

    def run():
        return model._core(*args, alpha_mode="proj")

    flops = count_flops(run, modules=(model.hrnet,))
    with torch.inference_mode():
        for _ in range(warmup):
            float(run()[-1, -2])
        t0 = time.perf_counter()
        acc = 0.0
        for _ in range(iters):
            acc += float(run()[-1, -2])        # one blocking call at a time
        sync_dt = (time.perf_counter() - t0) / iters
        assert np.isfinite(acc)

        def window():
            _sync(model.device)
            t0 = time.perf_counter()
            sums = [run()[:, -2].sum() for _ in range(iters)]
            checksum = float(torch.stack(sums).sum())
            dt = (time.perf_counter() - t0) / iters
            assert np.isfinite(checksum)
            return dt

        dts = sorted(window() for _ in range(repeats))
    step = float(np.median(dts))
    return {"crops_per_sec": batch / step, "min": batch / dts[-1],
            "max": batch / dts[0], "sync_crops_per_sec": batch / sync_dt,
            "flops": flops, "step_s": step}


def kitti_like_boxes(rng, mean_per_img=6):
    """Detection boxes with a KITTI-like size/count distribution: counts
    Poisson(mean)+1, apparent height f*H/z for depth z ~ U(5, 60) m (many
    small far cars, a long tail of big near ones), aspect from yaw, boxes
    hugging the horizon line."""
    n = int(rng.poisson(mean_per_img)) + 1
    z = rng.uniform(5.0, 60.0, n)
    h = np.clip(707.0 * 1.5 / z, 22.0, 340.0)
    w = h * rng.uniform(1.2, 2.8, n)
    y1 = np.clip(185.0 - h * rng.uniform(0.35, 0.65, n), 0, 374)
    x1 = rng.uniform(0, np.maximum(1242 - w, 1), n)
    return np.stack([x1, y1, np.minimum(x1 + w, 1241.0),
                     np.minimum(y1 + h, 374.0)], axis=1)


def _frame(px_rng):
    """A 375x1242 frame: coarse noise upsampled (torch bicubic), so PNG
    size and decode cost resemble a natural image's."""
    low = px_rng.randint(0, 255, (375 // 8, 1242 // 8, 3), dtype=np.uint8)
    up = torch.nn.functional.interpolate(
        torch.from_numpy(low).permute(2, 0, 1)[None].float(),
        size=(375, 1242), mode="bicubic", align_corners=False)
    return up[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()


def build_e2e_dataset(root, n_images, mean_boxes_per_img, seed=0):
    """Synthetic KITTI-like PNG frames on disk + D4LCN-style detection
    dicts (frames written by the port's PNG encoder; the boxes are the root
    bench's)."""
    from egonet_tpu_torch.data import png
    rng = np.random.RandomState(seed)
    # frame pixels come from their own stream: they are drawn only when the
    # PNG is not already on disk, and the boxes must not depend on that
    px_rng = np.random.RandomState(seed + 1)
    os.makedirs(root, exist_ok=True)
    annots = []
    for i in range(n_images):
        path = os.path.join(root, f"{i:06d}.png")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(png.encode(_frame(px_rng)))
        boxes = kitti_like_boxes(rng, mean_boxes_per_img)
        raw = [{"class": "Car", "truncation": 0.0, "occlusion": 0.0,
                "alpha": 0.0, "bbox": list(map(float, b)),
                "dimensions": [3.9, 1.5, 1.6],
                "locations": [0.0, 1.6, 20.0], "rot_y": 0.0, "score": 0.9}
               for b in boxes]
        annots.append({"path": path, "boxes": boxes, "raw": raw,
                       "K": np.array([[707.0, 0, 604.0],
                                      [0, 707.0, 180.0], [0, 0, 1.0]])})
    return annots


def bench_e2e(model, out_dir, epochs=2, images_per_batch=16,
              mean_boxes_per_img=6, n_images=32, repeats=REPEATS):
    """Pipelined decode -> prep -> device -> txt loop: {'crops_per_sec'
    (median of ``repeats`` windows of ``epochs`` epochs), 'min', 'max',
    'n' (windows), 'cold_crops_per_sec', 'crops_done' (every crop, warm-up
    included)}."""
    # frames_torch: frames of the port's encoder, never the root bench's
    annots = build_e2e_dataset(os.path.join(out_dir, "frames_torch"),
                               n_images, mean_boxes_per_img)
    save_dict = {"flag": True, "save_dir": os.path.join(out_dir, "data")}

    def batches():
        for start in range(0, len(annots), images_per_batch):
            chunk = annots[start:start + images_per_batch]
            yield {"path": [a["path"] for a in chunk],
                   "boxes": [a["boxes"] for a in chunk],
                   "K": [a["K"] for a in chunk],
                   "raw_txt_format": [a["raw"] for a in chunk]}

    def run_epoch():
        crops = 0
        for records in model.stream_annot_dicts(batches(), depth=3,
                                                enlarge=1.1,
                                                alpha_mode="proj"):
            model.post_process(records, save_dict=save_dict)
            crops += sum(len(r["boxes"]) for r in records.values())
        return crops

    crops_done = run_epoch()                 # warm-up: first decode, plans
    cold = None
    if model.image_store is not None:
        model.image_store.clear_ram()        # every frame decoded again
        t0 = time.perf_counter()
        n = run_epoch()
        cold = n / (time.perf_counter() - t0)
        crops_done += n
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        total = sum(run_epoch() for _ in range(epochs))
        rates.append(total / (time.perf_counter() - t0))
        crops_done += total
    return {"crops_per_sec": float(np.median(rates)), "min": min(rates),
            "max": max(rates), "n": repeats, "cold_crops_per_sec": cold,
            "crops_done": crops_done}


def h2d_rate(device, n=3):
    """Bytes/s of a pinned host->device copy of 16 canvases (384x1280x3
    uint8, 23.6 MB), CUDA-event timed."""
    x = torch.randint(0, 255, (16, 384, 1280, 3), dtype=torch.uint8)
    x = x.pin_memory()
    x.to(device, non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        x.to(device, non_blocking=True)
    end.record()
    end.synchronize()
    return x.numel() * n / (start.elapsed_time(end) / 1e3)


def e2e_fields(model, core_crops_per_sec, **kwargs) -> dict:
    """The line's e2e fields: :func:`bench_e2e` (``kwargs`` go to it) in a
    scratch directory, over the core rate, and the bytes it moved."""
    import tempfile
    on_card = model.device.type == "cuda"
    model.transport_stats = {k: 0 for k in model.transport_stats}
    with tempfile.TemporaryDirectory() as tmp:
        e2e = bench_e2e(model, tmp, **kwargs)
    ts = model.transport_stats
    moved = ts["packed_bytes"] + ts["canvas_bytes"]
    return {
        "e2e_crops_per_sec": e2e["crops_per_sec"],
        "e2e_windows": {"n": e2e["n"], "min": e2e["min"], "max": e2e["max"]},
        "e2e_cold_crops_per_sec": e2e["cold_crops_per_sec"],
        "e2e_vs_core": e2e["crops_per_sec"] / core_crops_per_sec,
        "e2e_transport": ("roi_packed" if ts["packed_batches"]
                          >= ts["canvas_batches"] else "canvas"),
        "h2d_kb_per_crop": moved / e2e["crops_done"] / 1e3,
        "h2d_mb_per_sec": h2d_rate(model.device) / 1e6 if on_card else None}


def card_line():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _by_batch(model, batches, iters, warmup, bf16, on_card):
    """{batch: its figures} and the FLOPs per crop of ``model``'s device
    program."""
    out = {}
    for b in batches:
        r = bench_core(model, b, iters, warmup, REPEATS)
        out[str(b)] = {
            "crops_per_sec": r["crops_per_sec"],
            "windows": {"n": REPEATS, "iters": iters, "min": r["min"],
                        "max": r["max"]},
            "sync_crops_per_sec": r["sync_crops_per_sec"],
            "mfu": (r["flops"] / r["step_s"] / H100_BF16_PEAK_FLOPS
                    if on_card and bf16 else None)}
        flops_per_crop = r["flops"] / b
    return out, flops_per_crop


def main(cfgs=None, device=None, native_cfgs=None) -> dict:
    """Run the bench and print its JSON line (also returned).  ``cfgs``
    defaults to the shipped W48 config, ``native_cfgs`` to it with the
    native switch of the root bench; ``device=None`` is the card."""
    import copy
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    env = os.environ.get
    batches = sorted(int(b) for b in env("BENCH_BATCH", "384").split(","))
    iters = int(env("BENCH_ITERS", "20"))
    warmup = int(env("BENCH_WARMUP", "3"))
    bf16 = env("BENCH_DTYPE", "bf16") == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    cfgs = copy.deepcopy(cfgs or demo_config())
    if env("BENCH_ACT_QUANT"):
        cfgs["heatmapModel"]["act_quant"] = env("BENCH_ACT_QUANT")
    if env("BENCH_FUSE_MERGE"):
        cfgs["heatmapModel"]["fuse_merge"] = env("BENCH_FUSE_MERGE") == "1"
    model = EgoNet(cfgs, pre_trained=False, dtype=dtype, device=device)
    on_card = model.device.type == "cuda"

    by_batch, flops_per_crop = _by_batch(model, batches, iters, warmup, bf16,
                                         on_card)
    head = by_batch[str(batches[-1])]
    line = {"metric": "w48_crops_per_sec", "value": head["crops_per_sec"],
            "unit": "crops/s", "batch": batches[-1],
            "dtype": "bf16" if bf16 else "fp32",
            "w48_crops_per_sec": head["crops_per_sec"],
            "windows": head["windows"],
            "sync_crops_per_sec": head["sync_crops_per_sec"],
            "flops_per_crop": flops_per_crop / 1e9,       # GFLOP
            "mfu": head["mfu"], "by_batch": by_batch,
            "act_quant": cfgs["heatmapModel"].get("act_quant", "none"),
            "fuse_merge": bool(cfgs["heatmapModel"].get("fuse_merge"))}
    best, family = head["crops_per_sec"], "hrnet_w48_parity"
    if env("BENCH_NATIVE", "1") == "1":
        if native_cfgs is None:
            native_cfgs = copy.deepcopy(cfgs)
            native_cfgs["heatmapModel"]["name"] = "tpu_native"
            native_cfgs["heatmapModel"]["extra"] = {}
        native = EgoNet(native_cfgs, pre_trained=False, dtype=dtype,
                        device=device)
        n_by, n_flops = _by_batch(native, batches, iters, warmup, bf16,
                                  on_card)
        del native
        n_head = n_by[str(batches[-1])]
        line.update({
            "tpu_native_crops_per_sec": n_head["crops_per_sec"],
            "tpu_native_vs_w48": n_head["crops_per_sec"]
            / head["crops_per_sec"],
            "tpu_native_flops_per_crop": n_flops / 1e9,   # GFLOP
            "tpu_native_mfu": n_head["mfu"],
            "tpu_native_by_batch": n_by})
        if n_head["crops_per_sec"] > best:
            best, family = n_head["crops_per_sec"], "tpu_native_stride8"
    line.update({"headline_family": family,
                 "best_gated_crops_per_sec": best})

    if env("BENCH_E2E", "1") == "1":
        line.update(e2e_fields(model, head["crops_per_sec"]))
    line.update({"device": (torch.cuda.get_device_name(model.device)
                            if on_card else "cpu"),
                 "card": card_line() if on_card else None})
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
