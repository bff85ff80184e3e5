"""Request-driven serving for the fused EgoNet pipeline on the card.  Port
of ``egonet_tpu/serving/server.py``.

Independent HTTP requests (one image + its 2D detections each) are
micro-batched into the instance buckets the offline pipeline uses
(``models/egonet.py`` ``dispatch_annot_dict`` with the serving packing
profile), so concurrent load reaches the card as a few large batches, each
running the HRNet's 104 fused BasicBlocks through the Hopper kernel.
Dispatch is asynchronous: the dispatch thread host-preps batch *i+1* and
launches it on its current CUDA stream while the finalize thread waits on
batch *i*'s CUDA event (recorded after its device->host copy) and answers
its requests.

No external dependencies: ``http.server`` + threads.  Endpoints:

  POST /v1/pose   {"image_b64": <base64 PNG, or another format cv2
                  decodes where cv2 is installed>} or {"image_path": path},
                  "boxes": [[x1,y1,x2,y2], ...],
                  "K": [[fx,0,cx],[0,fy,cy],[0,0,1]]  (optional),
                  "scores": [...], "score_threshold": float (optional)
                  -> {"instances": [{"alpha", "rot_y", "euler_angles",
                      "translation", "kpts_2d", "kpts_3d"}, ...],
                      "batched_with": n_images_in_microbatch,
                      "latency_ms": ...}
  GET  /healthz   liveness + the model's device (type, card name) and,
                  sharded, the mesh's devices
  GET  /v1/stats  request/batch counters + model transport stats

Status codes: 400 malformed payload, 404 unknown path, 500 inference
error, 503 queue full (:class:`OverloadedError`), 504 timed out.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from egonet_tpu_torch.data import png


class OverloadedError(RuntimeError):
    """Raised by submit() when the pending queue is at capacity; the HTTP
    layer maps it to 503 so callers can back off."""


class _Request:
    """One in-flight request: an image, its boxes, and a completion event."""

    __slots__ = ("key", "image", "boxes", "K", "event", "result", "error",
                 "batched_with")

    def __init__(self, key, image, boxes, K):
        self.key = key
        self.image = image
        self.boxes = boxes
        self.K = K
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batched_with = 0


class MicroBatcher:
    """Groups concurrent requests into one device dispatch.

    ``submit`` enqueues; a dispatch thread drains up to ``max_images``
    requests per micro-batch, waiting at most ``max_wait_ms`` after the
    first pending request before launching a partial batch, and hands the
    asynchronous dispatch to a finalize thread, keeping up to ``depth``
    batches in flight.  ``idle_floor``: an uncongested micro-batch of at
    most that many instances runs at that bucket instead of the congestion
    floor of 128 (0: always 128).
    """

    def __init__(self, model, max_images: int = 16, max_wait_ms: float = 10.0,
                 depth: int = 2, enlarge: float = 1.1,
                 alpha_mode: str = "proj", max_queue: int = 256,
                 idle_floor: int = 16):
        self.model = model
        self.max_images = int(max_images)
        self.max_wait = float(max_wait_ms) / 1e3
        self.enlarge = float(enlarge)
        self.alpha_mode = alpha_mode
        self.max_queue = int(max_queue)
        self.idle_floor = int(idle_floor)
        self.stats = {"requests": 0, "batches": 0, "instances": 0,
                      "empty_requests": 0, "idle_dispatches": 0,
                      "floor_dispatches": 0}
        self._lock = threading.Condition()
        self._queue: list[_Request] = []
        self._inflight = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = False
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="egonet-serve-dispatch"),
            threading.Thread(target=self._finalize_loop, daemon=True,
                             name="egonet-serve-finalize"),
        ]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------------- API

    def submit(self, req: _Request):
        with self._lock:
            if self._stop:
                raise RuntimeError("batcher stopped")
            if len(self._queue) >= self.max_queue:
                self.stats["rejected"] = self.stats.get("rejected", 0) + 1
                raise OverloadedError(
                    f"queue full ({self.max_queue} pending)")
            self._queue.append(req)
            self.stats["requests"] += 1
            self._lock.notify_all()

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        # the dispatch loop emits the inflight sentinel itself after
        # draining the queued batches
        for t in self._threads:
            t.join(timeout=5.0)

    # -------------------------------------------------------------- loops

    def _take_batch(self):
        """Block until requests exist, then drain a micro-batch; returns
        (batch, congested) or None once stopped and drained."""
        with self._lock:
            while not self._queue and not self._stop:
                self._lock.wait()
            if self._stop and not self._queue:
                return None
            deadline = time.monotonic() + self.max_wait
            while len(self._queue) < self.max_images and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            batch = self._queue[:self.max_images]
            del self._queue[:len(batch)]
            # congestion signal for the adaptive bucket floor: requests
            # already waiting behind this drain
            return batch, bool(self._queue)

    def _dispatch_loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                self._inflight.put(None)
                return
            batch, congested = taken
            live = [r for r in batch if len(r.boxes)]
            for r in batch:
                if not len(r.boxes):
                    self.stats["empty_requests"] += 1
                    r.result = []
                    r.event.set()
            if not live:
                continue
            try:
                annot = {
                    "path": [r.key for r in live],
                    "images": [r.image for r in live],
                    "boxes": [np.asarray(r.boxes, np.float64)
                              for r in live],
                    "K": [r.K for r in live],
                }
                n_inst = sum(len(r.boxes) for r in live)
                idle = (self.idle_floor > 0 and not congested
                        and n_inst <= self.idle_floor)
                pending = self.model.dispatch_annot_dict(
                    annot, enlarge=self.enlarge, alpha_mode=self.alpha_mode,
                    pack_profile="serving",
                    bucket_floor=self.idle_floor if idle else 128)
                self.stats["batches"] += 1
                self.stats["idle_dispatches" if idle
                           else "floor_dispatches"] += 1
                self.stats["instances"] += n_inst
                self._inflight.put((pending, live))
            except Exception as exc:  # noqa: BLE001  (answered as a 500)
                for r in live:
                    r.error = exc
                    r.event.set()

    def _finalize_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            pending, live = item
            try:
                records = self.model.finalize(pending)
                for r in live:
                    r.result = _record_to_instances(records[r.key])
                    r.batched_with = len(live)
                    r.event.set()
            except Exception as exc:  # noqa: BLE001  (answered as a 500)
                for r in live:
                    r.error = exc
                    r.event.set()


def _record_to_instances(rec) -> list:
    euler = np.asarray(rec["euler_angles"], np.float64)
    alphas = np.asarray(rec["alphas"], np.float64)
    trans = np.asarray(rec["translation"], np.float64)
    k3d = np.asarray(rec["kpts_3d_pred"], np.float64)
    out = []
    for i in range(len(alphas)):
        k2d = np.asarray(rec["kpts_2d_pred"][i], np.float64).reshape(-1, 2)
        out.append({
            "alpha": float(alphas[i]),
            # the KITTI writer's rot_y (io/kitti_writer.py): euler[:, 1]
            "rot_y": float(euler[i, 1]),
            "euler_angles": euler[i].tolist(),
            "translation": trans[i].tolist(),
            "kpts_2d": k2d.tolist(),
            "kpts_3d": k3d[i].tolist(),
        })
    return out


def decode_b64(text: str) -> np.ndarray:
    """A request's ``image_b64`` -> RGB uint8 [H, W, 3]: PNG through the
    port's own reader, any other format through cv2 (imported here; a
    ValueError naming it where it is missing, as on hosts without
    OpenCV)."""
    data = base64.b64decode(text, validate=True)
    if png.is_png(data):
        return png.decode_bytes(data, "image_b64")
    try:
        import cv2
    except ImportError:
        raise ValueError("image_b64 is not a PNG, and decoding other "
                         "formats needs cv2 (OpenCV), which is not "
                         "installed") from None
    # IMREAD_IGNORE_ORIENTATION matches load_image's flags, so an
    # EXIF-rotated JPEG decodes alike through either field
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if img is None:
        raise ValueError("image_b64 did not decode")
    return img[:, :, ::-1].copy()                   # BGR -> RGB


def device_info(model) -> dict:
    """The model's device for /healthz: ``platform`` ('gpu' or 'cpu'),
    the torch device and, on a card, its name; with a mesh of more than
    one shard, its devices in shard order (``mesh``)."""
    dev = torch.device(model.device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "device": str(dev)}
    if dev.type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(dev)
    if len(getattr(model, "mesh", ())) > 1:
        info["mesh"] = [str(d) for d in model.mesh]
    return info


class _HTTPServer(ThreadingHTTPServer):
    # a burst of concurrent clients (bench_serve's 16) overflows the
    # default accept backlog of 5 while the handler threads are busy, and
    # the kernel resets the connections it drops
    request_queue_size = 128


class PoseServer:
    """HTTP facade over :class:`MicroBatcher` (stdlib ThreadingHTTPServer:
    each request blocks its own handler thread on the batcher, so many
    concurrent posts coalesce into shared micro-batches)."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 600.0, **batcher_kwargs):
        # generous default: the first request after boot may build the
        # kernels (warmup does that at boot instead)
        self.request_timeout_s = float(request_timeout_s)
        self.batcher = MicroBatcher(model, **batcher_kwargs)
        self._decode = model.load_image
        self.device = device_info(model)
        self._counter = 0
        self._counter_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):           # no per-request lines
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True, **server.device})
                elif self.path == "/v1/stats":
                    stats = dict(server.batcher.stats)
                    stats["transport"] = dict(
                        getattr(server.batcher.model, "transport_stats", {}))
                    self._json(200, stats)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/pose":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n))
                    t0 = time.monotonic()
                    req = server._build_request(payload)
                    try:
                        server.batcher.submit(req)
                    except OverloadedError as exc:
                        self._json(503, {"error": str(exc)})
                        return
                    if not req.event.wait(timeout=server.request_timeout_s):
                        self._json(504, {"error": "inference timed out"})
                        return
                    if req.error is not None:
                        self._json(500, {"error": str(req.error)})
                        return
                    self._json(200, {
                        "instances": req.result,
                        "batched_with": req.batched_with,
                        "latency_ms": round(
                            (time.monotonic() - t0) * 1e3, 2),
                    })
                except (ValueError, KeyError, IndexError,
                        TypeError) as exc:
                    # malformed payloads (a base64 or PNG error, a
                    # scores/boxes length mismatch) -> 400
                    self._json(400, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001  (submit after stop)
                    self._json(500, {"error": str(exc)})

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="egonet-serve-http")

    def _build_request(self, payload: dict) -> _Request:
        if "image_b64" in payload:
            img = decode_b64(payload["image_b64"])
        elif "image_path" in payload:
            img = self._decode(payload["image_path"])
        else:
            raise ValueError("need image_b64 or image_path")
        boxes = np.asarray(payload.get("boxes", []),
                           np.float64).reshape(-1, 4)
        thr = payload.get("score_threshold")
        scores = payload.get("scores")
        if thr is not None and scores is not None and len(boxes):
            boxes = boxes[np.asarray(scores, np.float64) >= float(thr)]
        K = np.asarray(payload["K"], np.float64) if "K" in payload \
            else np.eye(3)
        if K.shape != (3, 3):
            raise ValueError(f"K must be 3x3, got {K.shape}")
        with self._counter_lock:
            self._counter += 1
            key = f"req-{self._counter:08d}"
        return _Request(key, img, boxes, K)

    def warmup(self):
        """Dispatch synthetic KITTI-shaped requests at boot: the first
        builds the model's kernel libraries (once, on the dispatch thread)
        and both serving buckets — the idle floor and the congestion floor
        of 128 — run before any user request.  The second request carries
        idle_floor + 1 boxes, which takes the 128 floor even while the
        server is idle.  A failed request re-raises its error here."""
        rng = np.random.RandomState(0)
        K = np.asarray([[707.0, 0, 604.0], [0, 707.0, 180.0], [0, 0, 1.0]])
        one_box = np.asarray([[500.0, 160.0, 620.0, 250.0]])
        idle_floor = self.batcher.idle_floor
        n_burst = (idle_floor + 1) if idle_floor > 0 else 1
        x0 = rng.uniform(0, 1000, n_burst)
        y0 = rng.uniform(0, 180, n_burst)
        burst = np.stack([x0, y0, x0 + rng.uniform(60, 240, n_burst),
                          y0 + rng.uniform(40, 160, n_burst)], axis=1)
        boxes_list = [one_box, burst] if idle_floor > 0 else [one_box]
        for boxes in boxes_list:
            img = rng.randint(0, 255, (375, 1242, 3), np.uint8)
            req = _Request("warmup", img, boxes, K)
            self.batcher.submit(req)
            if not req.event.wait(timeout=self.request_timeout_s):
                raise TimeoutError("warmup request timed out")
            if req.error is not None:
                raise req.error

    def start(self):
        self._serve_thread.start()
        return self

    def stop(self):
        # BaseServer.shutdown() blocks until serve_forever() acknowledges:
        # forever, if start() was never called
        if self._serve_thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
