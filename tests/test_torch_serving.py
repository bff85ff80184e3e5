"""The port's serving layer (``egonet_tpu_torch/serving``, ``tools/serve.py``,
``tools/bench_serve.py``) on the CPU: the cases of tests/test_serving.py
against the port's server (a shrunk HRNet, fp32), the served instances
against the port's offline facade on the same requests, and the port's
server against the JAX package's ``PoseServer`` on the same weights
(``from_jax_variables``).

The JAX server runs its program under ``jit``, whose CPU warp differs from
its own eager warp (ROADMAP §3), so the cross-package bars are those of a
jitted JAX warp: kpts 0.1 px, angles 1e-3 rad.  Within the port, served
and offline runs are the same arithmetic up to fp32 rounding (1e-6)."""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonet_tpu_torch.config import demo_config
from egonet_tpu_torch.data import png
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.serving import OverloadedError, PoseServer
from egonet_tpu_torch.serving.server import MicroBatcher, _Request
from tests import fixtures

torch.set_num_threads(1)

K = [[707.0, 0, 64.0], [0, 707.0, 48.0], [0, 0, 1.0]]


def _cfg():
    cfg = fixtures.shrink_hrnet(demo_config())
    cfg["bf16"] = False
    return cfg


@pytest.fixture(scope="module")
def small_model():
    return EgoNet(_cfg(), device="cpu")


@pytest.fixture()
def server(small_model):
    srv = PoseServer(small_model, port=0, max_images=8,
                     max_wait_ms=60.0).start()
    yield srv
    srv.stop()


def _post(port, payload, path="/v1/pose"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _status(port, payload, path="/v1/pose"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    return err.value.code, json.loads(err.value.read())


def _img(rng, h=96, w=128):
    return rng.randint(0, 255, (h, w, 3), np.uint8)


def _b64(img):
    return base64.b64encode(png.encode(img)).decode()


def test_healthz_and_single_request(server, rng):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health == {"ok": True, "platform": "cpu", "device": "cpu"}
    resp = _post(server.port, {
        "image_b64": _b64(_img(rng)),
        "boxes": [[10, 10, 70, 60], [40, 20, 120, 90]], "K": K})
    assert len(resp["instances"]) == 2
    for inst in resp["instances"]:
        assert np.isfinite(inst["alpha"]) and np.isfinite(inst["rot_y"])
        assert abs(inst["alpha"]) <= np.pi + 1e-6
        assert len(inst["euler_angles"]) == 3
        assert len(inst["translation"]) == 3
        assert np.asarray(inst["kpts_2d"]).shape == (33, 2)
        assert np.isfinite(np.asarray(inst["kpts_3d"])).all()


def test_concurrent_requests_share_a_microbatch(server, rng):
    """Posts issued together coalesce: the batch counter grows by less
    than the request count, and responses report companions."""
    b0 = server.batcher.stats["batches"]
    n = 6
    payloads = [{"image_b64": _b64(_img(rng, 80 + 8 * i, 112)),
                 "boxes": [[5 + i, 5, 60 + i, 55]]} for i in range(n)]
    results = [None] * n

    def work(i):
        results[i] = _post(server.port, payloads[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and len(r["instances"]) == 1 for r in results)
    assert server.batcher.stats["batches"] - b0 < n
    assert any(r["batched_with"] > 1 for r in results)


def _offline(model, img, boxes, K_):
    return model({"path": ["x"], "images": [img],
                  "boxes": [np.asarray(boxes, np.float64)],
                  "K": [np.asarray(K_)]})["x"]


def test_served_equals_offline_facade(server, small_model, rng):
    """Served instances equal the offline facade (``EgoNet.__call__``) on
    the same image and boxes within fp32 rounding: the batcher adds no
    numerics, though it packs a ROI canvas at the serving bucket."""
    img = _img(rng, 100, 140)
    boxes = [[12.0, 8.0, 90.0, 70.0], [30.0, 20.0, 120.0, 88.0]]
    resp = _post(server.port, {"image_b64": _b64(img), "boxes": boxes,
                               "K": K})
    rec = _offline(small_model, img, boxes, K)
    for i, inst in enumerate(resp["instances"]):
        # angles in rad; coordinates relative to their largest magnitude
        # (the summation order differs with the bucket and the transport)
        assert inst["alpha"] == pytest.approx(float(rec["alphas"][i]),
                                              abs=1e-6)
        np.testing.assert_allclose(inst["euler_angles"],
                                   rec["euler_angles"][i], atol=1e-6)
        for got, ref in ((inst["kpts_2d"], np.asarray(
                rec["kpts_2d_pred"][i]).reshape(-1, 2)),
                         (inst["kpts_3d"], rec["kpts_3d_pred"][i])):
            np.testing.assert_allclose(got, ref,
                                       atol=1e-6 * np.abs(ref).max())


def test_empty_boxes_and_bad_payloads(server, rng):
    resp = _post(server.port, {"image_b64": _b64(_img(rng)), "boxes": []})
    assert resp["instances"] == []
    for bad in ({"boxes": [[1, 2, 3, 4]]},                   # no image
                {"image_b64": "not-base64!!", "boxes": []},
                {"image_b64": base64.b64encode(b"\x89PNG\r\n\x1a\nxx")
                 .decode(), "boxes": []},                    # broken PNG
                {"image_b64": _b64(_img(rng)), "boxes": [],
                 "K": [[1, 2], [3, 4]]},                     # bad K shape
                {"image_b64": _b64(_img(rng)),               # scores/boxes
                 "boxes": [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                 "scores": [0.9, 0.2], "score_threshold": 0.5}):
        code, body = _status(server.port, bad)
        assert code == 400, body
    code, _ = _status(server.port, {}, path="/v1/nothing")
    assert code == 404


def test_non_png_needs_cv2(server, rng, monkeypatch):
    """A JPEG decodes through cv2 where it imports; without cv2 the 400
    names the missing decoder."""
    import sys
    import cv2
    ok, buf = cv2.imencode(".jpg", _img(rng))
    payload = {"image_b64": base64.b64encode(buf.tobytes()).decode(),
               "boxes": [[10, 10, 70, 60]]}
    assert len(_post(server.port, payload)["instances"]) == 1
    monkeypatch.setitem(sys.modules, "cv2", None)
    code, body = _status(server.port, payload)
    assert code == 400 and "cv2" in body["error"]


def test_score_threshold_filters_boxes(server, rng):
    resp = _post(server.port, {
        "image_b64": _b64(_img(rng)),
        "boxes": [[10, 10, 70, 60], [20, 15, 80, 65], [30, 20, 90, 70]],
        "scores": [0.9, 0.2, 0.8], "score_threshold": 0.5})
    assert len(resp["instances"]) == 2


def test_stats_endpoint(server, rng):
    _post(server.port, {"image_b64": _b64(_img(rng)),
                        "boxes": [[10, 10, 70, 60]]})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/v1/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["instances"] >= 1
    assert stats["transport"]["packed_batches"] >= 1


def test_warmup_runs_both_buckets(small_model):
    srv = PoseServer(small_model, port=0, max_images=4, max_wait_ms=5.0)
    try:
        srv.warmup()
        assert srv.batcher.stats["idle_dispatches"] == 1
        assert srv.batcher.stats["floor_dispatches"] == 1
    finally:
        srv.stop()


def test_warmup_reraises_the_first_error(small_model, monkeypatch):
    srv = PoseServer(small_model, port=0, max_images=4, max_wait_ms=5.0)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel build failed")

    try:
        monkeypatch.setattr(small_model, "dispatch_annot_dict", broken)
        with pytest.raises(RuntimeError, match="kernel build failed"):
            srv.warmup()
    finally:
        srv.stop()


def test_serving_profile_never_falls_back_to_canvas(small_model, rng):
    before = dict(small_model.transport_stats)
    annot = {"path": ["p"], "images": [_img(rng, 100, 140)],
             "boxes": [np.asarray([[10.0, 10.0, 70.0, 60.0]])],
             "K": [np.eye(3)]}
    rec = small_model.finalize(small_model.dispatch_annot_dict(
        annot, pack_profile="serving"))["p"]
    assert np.isfinite(np.asarray(rec["alphas"])).all()
    assert (small_model.transport_stats["packed_batches"]
            == before["packed_batches"] + 1)
    assert (small_model.transport_stats["canvas_batches"]
            == before["canvas_batches"])


def test_adaptive_bucket_floor(server, small_model, rng):
    """An uncongested small request runs at the idle bucket; one larger
    than the idle floor at the congestion floor of 128; the results do not
    depend on the floor."""
    stats = server.batcher.stats
    i0, f0 = stats["idle_dispatches"], stats["floor_dispatches"]
    resp = _post(server.port, {"image_b64": _b64(_img(rng)),
                               "boxes": [[10, 10, 70, 60]]})
    assert len(resp["instances"]) == 1
    assert (stats["idle_dispatches"], stats["floor_dispatches"]) == (
        i0 + 1, f0)
    n = server.batcher.idle_floor + 1
    boxes = [[float(x), 8.0, float(x) + 50.0, 70.0]
             for x in np.linspace(2, 60, n)]
    resp = _post(server.port, {"image_b64": _b64(_img(rng)),
                               "boxes": boxes})
    assert len(resp["instances"]) == n
    assert (stats["idle_dispatches"], stats["floor_dispatches"]) == (
        i0 + 1, f0 + 1)
    img = _img(rng)
    one_box = np.asarray([[10.0, 10.0, 70.0, 60.0]])
    results = []
    for floor in (0, 16):
        mb = MicroBatcher(small_model, max_images=4, max_wait_ms=5.0,
                          idle_floor=floor)
        try:
            r = _Request("a", img, one_box, np.eye(3))
            mb.submit(r)
            assert r.event.wait(timeout=120) and r.error is None
            key = "floor_dispatches" if floor == 0 else "idle_dispatches"
            assert mb.stats[key] == 1
            results.append(r.result[0])
        finally:
            mb.close()
    assert results[0]["alpha"] == pytest.approx(results[1]["alpha"], abs=1e-6)
    np.testing.assert_allclose(results[0]["kpts_3d"], results[1]["kpts_3d"],
                               atol=1e-4)


def test_queue_bound_rejects_overload(small_model, rng):
    """submit() raises OverloadedError past max_queue, and the HTTP layer
    answers 503."""
    srv = PoseServer(small_model, port=0, max_images=4, max_wait_ms=5000.0,
                     max_queue=2).start()
    mb = srv.batcher
    try:
        img = np.zeros((64, 64, 3), np.uint8)
        reqs = [_Request(f"q{i}", img, np.asarray([[1.0, 1, 30, 30]]),
                         np.eye(3)) for i in range(4)]
        # the long linger keeps arrivals in the queue: the third submit
        # finds max_queue = 2 pending
        mb.submit(reqs[0])
        mb.submit(reqs[1])
        with pytest.raises(OverloadedError):
            mb.submit(reqs[2])
        code, body = _status(srv.port, {"image_b64": _b64(img),
                                        "boxes": [[1, 1, 30, 30]]})
        assert code == 503 and "queue full" in body["error"]
        assert mb.stats["rejected"] == 2
    finally:
        srv.stop()
    for r in reqs[:2]:
        assert r.event.is_set() and r.error is None


def test_serve_cli_boots_and_refuses_devices(small_model, monkeypatch):
    """The CLI boots on the CPU; ``--devices 2`` is refused on a CPU config
    and when fewer cards are visible (here none), and, given a mesh,
    boots a server whose /healthz lists the mesh's devices."""
    from egonet_tpu_torch.parallel import mesh
    from egonet_tpu_torch.tools import serve
    cfg = dict(_cfg(), device="cpu", pre_trained=False)
    srv = serve.main(["--port", "0", "--warmup", "0"], cfgs=cfg,
                     block=False)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["platform"] == "cpu"
    finally:
        srv.stop()
    with pytest.raises(SystemExit):
        serve.main(["--devices", "2"], cfgs=cfg, block=False)
    card_cfg = dict(_cfg(), pre_trained=False)          # device: the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        serve.main(["--devices", "2"], cfgs=card_cfg, block=False)
    with pytest.raises(ValueError, match="0 CUDA device"):
        mesh.make_mesh(2)
    monkeypatch.setattr(mesh, "make_mesh",
                        lambda n: mesh.DataMesh(["cpu"] * n))
    srv = serve.main(["--port", "0", "--warmup", "0", "--devices", "2"],
                     cfgs=card_cfg, block=False)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["mesh"] == ["cpu", "cpu"]
        assert len(srv.batcher.model.mesh) == 2
    finally:
        srv.stop()


def test_bench_serve_line(tmp_path):
    """The bench's workload at a small size: the JAX bench's keys plus the
    decoder, the store's traffic and the kernels' launches (none on the
    CPU), every request answered."""
    from egonet_tpu_torch.tools import bench_serve
    line = bench_serve.main(["--requests", "8", "--frames", "2",
                             "--workers", "4", "--max-wait-ms", "20"],
                            cfgs=_cfg(), device="cpu")
    for key in ("serve_requests_per_sec", "p50_ms", "p90_ms", "max_ms",
                "batches", "single_stream_p50_ms",
                "single_stream_idle_dispatches", "idle_floor"):
        assert key in line or line["metric"] == key
    assert line["requests"] == 8 and line["instances"] == 48
    assert 1 <= line["batches"] <= 8
    assert line["single_stream_idle_dispatches"] == 12
    assert line["frames_decoded"] == 0 and line["cache_hits"] == 8
    assert line["fused_launches"] == 0 and line["device"] == "cpu"
    # the frames are the port's PNGs and decode to what was encoded
    paths = bench_serve.make_frames(str(tmp_path), 1)
    assert png.decode(paths[0]).shape == (375, 1242, 3)


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX EgoNet fp32, the port's EgoNet fp32 on the CPU) with the JAX
    model's weights carried over."""
    from egonet_tpu.config import default_demo_config
    from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
    from egonet_tpu_torch.io.weights import from_jax_variables
    jcfg = fixtures.shrink_hrnet(default_demo_config())
    j = JaxEgoNet(jcfg, dtype=jnp.float32, rng_seed=3)
    hv = jax.tree_util.tree_map(np.asarray, dict(j.hrnet_vars))
    lv = jax.tree_util.tree_map(np.asarray, dict(j.lifter_vars))
    t = EgoNet(_cfg(), dtype=torch.float32, device="cpu")
    t.load_state(from_jax_variables(hv), from_jax_variables(lv),
                 dict(j.ls_stats))
    return j, t


def test_served_equals_jax_server(jax_pair, rng):
    """The port's server and the JAX package's PoseServer answer the same
    request alike: kpts within 0.1 px, angles within 1e-3 rad."""
    from egonet_tpu.serving import PoseServer as JaxPoseServer
    j, t = jax_pair
    payload = {"image_b64": _b64(_img(rng, 100, 140)), "K": K,
               "boxes": [[12.0, 8.0, 90.0, 70.0], [30.0, 20.0, 120.0, 88.0],
                         [5.0, 30.0, 70.0, 95.0]]}
    got = {}
    for name, cls, model in (("jax", JaxPoseServer, j), ("torch", PoseServer,
                                                         t)):
        srv = cls(model, port=0, max_images=4, max_wait_ms=5.0).start()
        try:
            got[name] = _post(srv.port, payload)["instances"]
        finally:
            srv.stop()
    assert len(got["jax"]) == len(got["torch"]) == 3
    for a, b in zip(got["jax"], got["torch"]):
        for key in ("alpha", "rot_y"):
            d = abs(a[key] - b[key]) % (2 * np.pi)
            assert min(d, 2 * np.pi - d) < 1e-3, (key, a[key], b[key])
        np.testing.assert_allclose(a["kpts_2d"], b["kpts_2d"], atol=0.1)
