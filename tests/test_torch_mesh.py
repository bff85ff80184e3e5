"""The port's data mesh (egonet_tpu_torch/parallel/mesh.py) and what runs
over it in one process: ``pad_instance_batch`` against the JAX package's,
``EgoNet(mesh=...)`` over a mesh of CPU devices against the single-device
port and against the JAX facade on ``make_mesh(8)`` (conftest's 8 virtual
CPU devices; JAX run eagerly, as in tests/test_torch_egonet.py; slice bars:
kpts 1e-3 px, angles 1e-4 rad), the server over a mesh, the node shards
of ``host_shard`` outside a process group.  The kernels' device guard (a
launch on a tensor of one card runs with that card current) is the C++
operators' ``CUDAGuard``, which ``chip_smoke.py --cards N`` holds on the
cards."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.models.egonet import EgoNet as JaxEgoNet
from egonet_tpu.parallel import mesh as jmesh
from egonet_tpu_torch.data import loader as tld
from egonet_tpu_torch.models.egonet import EgoNet
from egonet_tpu_torch.parallel import mesh
from tests.test_torch_egonet import _annot, _compare_records, _pair

torch.set_num_threads(2)


# ------------------------------------------------------------ padding

def _batch(rng, n, with_meta):
    b = {"images": rng.randint(0, 255, (2, 8, 8, 3)).astype(np.uint8),
         "inv_mats": rng.randn(n, 2, 3).astype(np.float32),
         "img_idx": rng.randint(0, 2, n).astype(np.int32),
         "joints": rng.randn(n, 33, 3).astype(np.float32),
         "mask": np.ones(n, np.float32),
         "sup_mask": (rng.rand(n) > 0.3).astype(np.float32)}
    if with_meta:
        b["meta"] = {"count": n, "center": rng.randn(n, 2)}
    return b


@pytest.mark.parametrize("with_meta", [False, True])
@pytest.mark.parametrize("n,multiple", [(140, 8), (14, 4), (16, 8)])
def test_pad_instance_batch_equals_jax(rng, n, multiple, with_meta):
    """Wrap rows for content, zero rows for mask / sup_mask, images and
    meta untouched: bit-equal to the JAX function, divisible or not."""
    b = _batch(rng, n, with_meta)
    got = mesh.pad_instance_batch(b, multiple)
    want = jmesh.pad_instance_batch(b, multiple)
    assert set(got) == set(want)
    for k in got:
        if k == "meta":
            assert got[k] is b[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    assert len(got["mask"]) == mesh.pad_to_multiple(n, multiple) \
        == jmesh.pad_to_multiple(n, multiple)
    assert got["mask"][n:].sum() == 0


def test_mesh_helpers_outside_a_group(monkeypatch):
    """No process group: rank 0 of 1, node (0, 1), sums are identities;
    a mesh may repeat a device and is never made silently."""
    assert (mesh.rank(), mesh.world(), mesh.node(), mesh.is_main()) == \
        (0, 1, (0, 1), True)
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t and mesh.all_reduce_count(t) is t
    m = mesh.DataMesh(["cpu", "cpu"])
    assert len(m) == 2 and m.distinct() == [torch.device("cpu")]
    assert mesh.shard_bounds(16, 4) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError):
        mesh.shard_bounds(14, 4)
    with pytest.raises(ValueError):
        mesh.DataMesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="0 CUDA device"):
        mesh.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh(2).devices == [torch.device("cuda", 0),
                                         torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="3 card"):
        mesh.make_mesh(3)


def test_host_shard_defaults_to_the_node(monkeypatch):
    """Without a group every record is this node's; explicit index / count
    still shard (the JAX package's rule)."""
    recs = list(range(11))
    assert tld.host_shard(recs) == recs
    assert tld.host_shard(recs, 1, 2) == [1, 3, 5, 7, 9, 1]
    monkeypatch.setattr(mesh, "node", lambda: (1, 2))
    assert tld.host_shard(recs) == [1, 3, 5, 7, 9, 1]


# ------------------------------------------------------------ the facade

@pytest.fixture(scope="module")
def trio():
    """(JAX facade, JAX facade on an 8-device mesh, the port's facade),
    one set of weights and LS statistics."""
    cfg, j, t = _pair(96)
    jm = JaxEgoNet(cfg, dtype=jnp.float32, rng_seed=5,
                   mesh=jmesh.make_mesh(8))
    jm.hrnet_vars = jax.tree_util.tree_map(np.asarray, j.hrnet_vars)
    jm.lifter_vars = jax.tree_util.tree_map(np.asarray, j.lifter_vars)
    jm.ls_stats = jax.tree_util.tree_map(np.asarray, j.ls_stats)
    jm.to_device()
    jm._get_jitted = lambda alpha_mode, packed=False: functools.partial(
        jm._core_packed if packed else jm._core, alpha_mode=alpha_mode)
    return cfg, j, jm, t


def _on_mesh(cfg, t, n):
    m = EgoNet(cfg, dtype=torch.float32, rng_seed=5, device="cpu",
               mesh=mesh.DataMesh(["cpu"] * n))
    m.load_state(t.hrnet.state_dict(), t.lifter.state_dict(),
                 {k: v.numpy() for k, v in t.ls_stats.items()})
    return m


@pytest.mark.parametrize("n_per", [1, 3])          # 3 and 9 boxes
@pytest.mark.parametrize("pack_mode", ["never", "always"])
def test_sharded_facade_matches_single_and_jax_mesh(trio, n_per, pack_mode):
    """The port over a mesh of 4 against the single-device port (the same
    crops: within fp32 rounding), both transports; 3 boxes in canvas mode
    and 9 packed also against the JAX facade on make_mesh(8) at the slice
    bars (each other case would compile JAX's eager ops anew)."""
    cfg, _, jm, t = trio
    tm = _on_mesh(cfg, t, 4)
    jm.pack_mode = t.pack_mode = tm.pack_mode = pack_mode
    annot = _annot(seed=3, n_img=3, n_per=n_per)
    got = tm.forward_annot_dict(annot)
    single = t.forward_annot_dict(annot)
    _compare_records(single, got)
    for p in got:
        np.testing.assert_allclose(got[p]["kpts_3d_pred"],
                                   single[p]["kpts_3d_pred"], atol=1e-4)
    if (pack_mode == "never") == (n_per == 1):
        _compare_records(jm.forward_annot_dict(annot), got)


@pytest.mark.parametrize("pack_mode", ["never", "always"])
def test_dispatch_makes_no_tensor_from_host_values(trio, pack_mode,
                                                   monkeypatch):
    """The [width, height] scale and the crop normalisation's (mean, std)
    are made once per replica (``to_device``): a batch over a two-shard
    mesh (two ``_tail`` calls) calls neither ``torch.tensor`` nor
    ``torch.as_tensor`` (on a card, each copies from the host and waits
    for the device), and answers as the single-device facade."""
    cfg, _, _, t = trio
    tm = _on_mesh(cfg, t, 2)
    tm.pack_mode = t.pack_mode = pack_mode
    annot = _annot(seed=4, n_img=2, n_per=3)
    want = t.forward_annot_dict(annot)
    calls, tails = [], []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    tail = tm._tail
    monkeypatch.setattr(tm, "_tail", lambda *a: tails.append(a[-1])
                        or tail(*a))
    got = tm.forward_annot_dict(annot)
    monkeypatch.undo()
    assert calls == [] and len(tails) == 2
    assert all(r is tm.replicas[torch.device("cpu")] for r in tails)
    _compare_records(want, got)


@pytest.mark.parametrize("n_boxes", [3, 9, 100])
def test_bucket_equals_the_jax_mesh_bucket(trio, n_boxes, monkeypatch):
    """For the same mesh size (8), the port pads a batch to JAX's bucket
    (rounded up to a multiple of the mesh after the serving floor).  The
    device programs are replaced by one that returns the padded meta."""
    cfg, _, jm, t = trio
    tm = _on_mesh(cfg, t, 8)
    monkeypatch.setattr(tm, "_run", lambda run, images, meta, *a:
                        (torch.from_numpy(meta), []))
    monkeypatch.setattr(jm, "_get_jitted", lambda *a, **k:
                        lambda *args, **kw: args[4])
    annot = _annot(seed=5, n_img=1, n_per=n_boxes)
    for profile, floor in (("transport", None), ("serving", 12)):
        host, _, _ = tm.dispatch_annot_dict(annot, pack_profile=profile,
                                            bucket_floor=floor)
        out, _ = jm.dispatch_annot_dict(annot, pack_profile=profile,
                                        bucket_floor=floor)
        assert host.shape[0] == out.shape[0] and host.shape[0] % 8 == 0
        np.testing.assert_array_equal(host[:, 9].numpy(),
                                      np.asarray(out)[:, 9])


def test_mesh_replicas_follow_load_state(trio):
    """Every mesh device's replica takes the weights load_state lays in."""
    cfg, _, _, t = trio
    tm = _on_mesh(cfg, t, 2)
    assert list(tm.replicas) == [torch.device("cpu")]
    w = {k: v * 0 for k, v in t.lifter.state_dict().items()}
    tm.load_state(lifter_state=w)
    for replica in tm.replicas.values():
        assert all(not v.any() for v in replica.lifter.state_dict().values())


# ------------------------------------------------------------ serving

def test_server_over_a_cpu_mesh_matches_single():
    """Counterpart of tests/test_serving.py's mesh test: the server over
    a 4-device CPU mesh answers as the offline single-device facade."""
    from egonet_tpu_torch.serving import PoseServer
    from tests.test_torch_serving import _cfg, _post
    cfg = _cfg()
    single = EgoNet(cfg, device="cpu")
    sharded = EgoNet(cfg, device="cpu", mesh=mesh.DataMesh(["cpu"] * 4))
    annot = _annot(seed=7, n_img=2, n_per=3)
    srv = PoseServer(sharded, port=0, max_images=4, max_wait_ms=5.0).start()
    try:
        for i in range(2):
            body = _post(srv.port, {"image_b64": _png_b64(annot["images"][i]),
                                    "boxes": annot["boxes"][i].tolist(),
                                    "K": annot["K"][i].tolist()})
            want = single.forward_annot_dict(
                {"path": ["x"], "images": [annot["images"][i]],
                 "boxes": [annot["boxes"][i]], "K": [annot["K"][i]]})["x"]
            got = np.array([inst["euler_angles"]
                            for inst in body["instances"]])
            d = np.abs(got - want["euler_angles"]) % (2 * np.pi)
            assert np.minimum(d, 2 * np.pi - d).max() < 1e-4, d
        assert srv.device["mesh"] == ["cpu"] * 4
    finally:
        srv.stop()


def _png_b64(img):
    import base64
    from egonet_tpu_torch.data import png
    return base64.b64encode(png.encode(img)).decode()
