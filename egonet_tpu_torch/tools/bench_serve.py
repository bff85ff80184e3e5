"""Concurrent-load benchmark of the HTTP pose service on the card (port of
``tools/bench_serve.py``).

Boots a PoseServer in-process on a synthetic KITTI-like workload and fires
concurrent requests from a thread pool, printing ONE JSON line with the
JAX bench's keys (``serve_requests_per_sec``, ``p50_ms``, ``p90_ms``,
``max_ms``, ``batches``, ``single_stream_p50_ms``,
``single_stream_idle_dispatches``, ``idle_floor``) plus what the port
adds: the device, the frame decoder and the store's traffic during the
timed pass (``decoder``, ``frames_decoded``, ``cache_hits``: the port's
PNG reader runs its Average / Paeth rows in Python, so one cold frame can
cost more than a batch), and the fused-block kernels' launches during the
timed pass (``fused_launches``, ``stencil_launches``).

Workload (the JAX bench's): 128 requests of 6 boxes, 16 client threads,
16 frames of 375x1242 (PNG, written by the port's encoder), linger
``--max-wait-ms`` 80, at most 16 images a micro-batch; untimed settle
passes until a pass stops getting faster (at most 8), one timed pass, then
12 sequential requests on the idle server (the adaptive bucket floor).

    python -m egonet_tpu_torch.tools.bench_serve [--requests 128]
        [--boxes 6] [--workers 16] [--cfg <yaml>]

Runs on the card with the shipped W48 config and seeded random weights;
``main(argv, cfgs=..., device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

K_BENCH = [[707.0, 0, 604.0], [0, 707.0, 180.0], [0, 0, 1.0]]
FRAME_HW = (375, 1242)


def make_frames(root: str, n: int, seed: int = 0, hw=FRAME_HW) -> list:
    """``n`` natural-entropy frames as PNGs under ``root`` (bicubic
    upsampling of 1/8-size noise, as the JAX bench draws them through
    cv2), written by the port's encoder."""
    from egonet_tpu_torch.data import png
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    paths = []
    for i in range(n):
        p = os.path.join(root, f"{i:06d}.png")
        if not os.path.exists(p):
            low = rng.randint(0, 255, (h // 8, w // 8, 3), np.uint8)
            up = torch.nn.functional.interpolate(
                torch.from_numpy(low).permute(2, 0, 1)[None].float(),
                size=(h, w), mode="bicubic", align_corners=False)
            img = up[0].permute(1, 2, 0).round().clamp(0, 255).to(
                torch.uint8).numpy()
            with open(p, "wb") as f:
                f.write(png.encode(img))
        paths.append(p)
    return paths


def make_payloads(paths: list, n_requests: int, n_boxes: int,
                  seed: int = 1, hw=FRAME_HW) -> list:
    """The JAX bench's requests: boxes of cars at 5-60 m on the frames in
    turn."""
    rng = np.random.RandomState(seed)
    h_img, w_img = hw

    def payload(i):
        z = rng.uniform(5.0, 60.0, n_boxes)
        h = np.clip(707.0 * 1.5 / z, 22.0, 340.0)
        w = h * rng.uniform(1.2, 2.8, n_boxes)
        y1 = np.clip(185.0 - h * 0.5, 0, h_img - 1)
        x1 = rng.uniform(0, np.maximum(w_img - w, 1), n_boxes)
        boxes = np.stack([x1, y1, np.minimum(x1 + w, w_img - 1.0),
                          np.minimum(y1 + h, h_img - 1.0)], 1)
        return {"image_path": paths[i % len(paths)],
                "boxes": boxes.tolist(), "K": K_BENCH}

    return [payload(i) for i in range(n_requests)]


def post(port: int, payload: dict) -> tuple:
    """(response body, seconds) of one POST /v1/pose; transient socket
    drops are retried, the retried latency counting from the first try."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/pose",
                                 data=json.dumps(payload).encode())
    t0 = time.perf_counter()
    for attempt in range(3):
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                body = json.loads(resp.read())
            break
        except (ConnectionResetError, ConnectionRefusedError) as e:
            if attempt == 2:
                raise
            print(f"# retrying after {type(e).__name__}", file=sys.stderr)
            time.sleep(0.2 * (attempt + 1))
    if len(body["instances"]) != len(payload["boxes"]):
        raise RuntimeError(f"{len(body['instances'])} instances for "
                           f"{len(payload['boxes'])} boxes")
    return body, time.perf_counter() - t0


def _launches():
    from egonet_tpu_torch.ops import fused_block, fused_block_stencil
    return (fused_block.fused_basic_block.launches,
            fused_block_stencil.fused_basic_block_stencil.launches)


def run(server, payloads: list, workers: int, settle: int = 8,
        n_single: int = 12) -> tuple:
    """Drive a started, warmed server: up to ``settle`` untimed passes,
    one timed pass, ``n_single`` sequential requests.  Returns (the JSON
    line's fields, the timed pass's responses in payload order)."""

    def one_pass():
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            out = list(pool.map(lambda p: post(server.port, p), payloads))
        return time.perf_counter() - t0, out

    prev = float("inf")
    for i in range(settle):
        wall, _ = one_pass()
        print(f"# settle pass {i}: {wall:.2f} s", file=sys.stderr)
        if wall > 0.8 * prev:
            break
        prev = wall

    store = server.batcher.model.image_store
    store0 = dict(store.stats) if store is not None else {}
    batches0 = server.batcher.stats["batches"]
    tiled0, stencil0 = _launches()
    wall, out = one_pass()
    tiled1, stencil1 = _launches()
    batches = server.batcher.stats["batches"] - batches0
    lats_ms = np.sort([s for _, s in out]) * 1e3
    store1 = dict(store.stats) if store is not None else {}

    idle0 = server.batcher.stats["idle_dispatches"]
    single = np.sort([post(server.port, payloads[i % len(payloads)])[1]
                      * 1e3 for i in range(n_single)])
    idle_used = server.batcher.stats["idle_dispatches"] - idle0
    single_p50 = float(single[len(single) // 2]) if n_single else None
    line = {
        "metric": "serve_requests_per_sec",
        "value": len(payloads) / wall,
        "unit": "req/s",
        "requests": len(payloads),
        "instances": sum(len(p["boxes"]) for p in payloads),
        "workers": workers,
        "p50_ms": float(lats_ms[len(lats_ms) // 2]),
        "p90_ms": float(lats_ms[int(len(lats_ms) * 0.9)]),
        "max_ms": float(lats_ms[-1]),
        "batches": batches,
        "single_stream_p50_ms": single_p50,
        "single_stream_idle_dispatches": int(idle_used),
        "idle_floor": server.batcher.idle_floor,
        **server.device,
        "decoder": store1.get("decoder"),
        "frames_decoded": store1.get("decodes", 0) - store0.get("decodes", 0),
        "cache_hits": store1.get("ram_hits", 0) - store0.get("ram_hits", 0),
        "fused_launches": tiled1 - tiled0,
        "stencil_launches": stencil1 - stencil0,
    }
    return line, [body for body, _ in out]


def main(argv=None, cfgs=None, device=None) -> dict:
    """Run the bench and print its JSON line (also returned).  ``cfgs``
    defaults to ``--cfg`` or the shipped W48 config; ``device=None`` is the
    card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default=None,
                    help="inference yaml (default: the shipped W48 config)")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--boxes", type=int, default=6, help="boxes per request")
    ap.add_argument("--workers", type=int, default=16,
                    help="concurrent client threads")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=80.0,
                    help="micro-batch linger")
    args = ap.parse_args(argv)

    from egonet_tpu_torch import config as cfg_mod
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.serving import PoseServer
    if cfgs is None:
        cfgs = (cfg_mod.load_config(args.cfg) if args.cfg
                else cfg_mod.demo_config())
    # random weights: this measures transport and program throughput
    model = EgoNet(cfgs, pre_trained=False, dtype=cfg_mod.config_dtype(cfgs),
                   device=device)
    server = PoseServer(model, port=0, max_images=16,
                        max_wait_ms=args.max_wait_ms).start()
    try:
        server.warmup()
        with tempfile.TemporaryDirectory() as tmp:
            paths = make_frames(tmp, args.frames)
            payloads = make_payloads(paths, args.requests, args.boxes)
            line, _ = run(server, payloads, args.workers)
    finally:
        server.stop()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
