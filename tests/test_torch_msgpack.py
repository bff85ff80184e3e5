"""The port's flax ``.msgpack`` checkpoints (egonet_tpu_torch/io/checkpoint.py
``save_variables`` / ``load_variables``, its codec ``msgpack_serialize`` /
``msgpack_restore``, and ``io/weights.to_jax_variables``) against flax's
own codec (``flax.serialization``) and the JAX package's
``egonet_tpu/io/checkpoint.py``: the port writes flax's bytes exactly, reads
flax's files to the same arrays bit for bit (fp32, fp16, bf16, int and bool
arrays, numpy scalars, nested keys), and the IGR CLI
resumes from a JAX-written ``HC.msgpack``."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization as fser

from egonet_tpu.io import checkpoint as jckpt
from egonet_tpu.io import torch_convert as tc
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.io import checkpoint as tckpt
from egonet_tpu_torch.io import weights as tw
from egonet_tpu_torch.models import factory
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.tools import train_igrs
from tests import fixtures

torch.set_num_threads(2)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "params": {
            "stage2_0": {"kernel": rng.randn(3, 3, 8, 16).astype(np.float32),
                         "bias": rng.randn(16).astype(np.float32)},
            "bn": {"scale": rng.randn(16).astype(np.float32)},
            "deep": {"nested": {"ids": rng.randint(-9, 9, (4, 5)).astype(
                np.int32), "steps": np.arange(6, dtype=np.int64)}},
        },
        "batch_stats": {"bn": {"mean": rng.randn(16).astype(np.float16),
                               "var": rng.rand(16).astype(np.float64)}},
        "flags": rng.rand(7) > 0.5,
        "scalar": np.float32(2.5),
        "epoch": 3,
    }


def _bf16(shape, seed=0):
    """The same bf16 values as ml_dtypes' (flax's) numpy array and as a
    torch tensor."""
    x = np.asarray(jnp.asarray(np.random.RandomState(seed).randn(*shape),
                               jnp.bfloat16))
    return x, torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)


def _assert_same_leaves(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_same_leaves(got[k], ref[k], f"{path}/{k}")
        return
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and ref.dtype.name == "bfloat16"
        got = got.view(torch.int16).numpy()
        ref = np.asarray(ref).view(np.int16)
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    assert got.tobytes() == ref.tobytes(), path


def test_port_writes_flax_bytes():
    """fp32 / fp16 / fp64 / int / bool arrays, a numpy scalar and a Python
    int, nested keys in any order: byte-identical to flax."""
    tree = _tree()
    shuffled = {k: tree[k] for k in reversed(list(tree))}
    assert tckpt.msgpack_serialize(shuffled) == fser.msgpack_serialize(tree)


def test_bf16_both_ways():
    """A torch bf16 leaf is written as flax writes ml_dtypes' bfloat16;
    flax's bfloat16 is read back as a torch bf16 tensor of the same
    bits."""
    ref, t = _bf16((3, 3, 4, 8))
    data = fser.msgpack_serialize({"params": {"conv": {"kernel": ref}}})
    assert tckpt.msgpack_serialize({"params": {"conv": {"kernel": t}}}) \
        == data
    got = tckpt.msgpack_restore(data)["params"]["conv"]["kernel"]
    _assert_same_leaves(got, ref)


def test_port_reads_flax_bytes():
    tree = _tree(1)
    got = tckpt.msgpack_restore(fser.msgpack_serialize(tree))
    _assert_same_leaves(got, tree)
    assert type(got["scalar"]) is np.float32 and got["epoch"] == 3
    # and flax reads the port's bytes to the same tree
    _assert_same_leaves(fser.msgpack_restore(tckpt.msgpack_serialize(tree)),
                        tree)


def test_an_array_flax_would_chunk_is_refused(monkeypatch):
    """flax splits an array over 2**30 bytes into chunks, which the port
    does not write: such an array raises (the limit lowered here)."""
    monkeypatch.setattr(tckpt, "_MAX_LEAF_BYTES", 64)
    tckpt.msgpack_serialize({"ok": np.zeros(16, np.float32)})
    for leaf in (np.zeros(17, np.float32), torch.zeros(33, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="chunk"):
            tckpt.msgpack_serialize({"big": leaf})


def _hrnet_state(dtype=torch.float32, seed=5):
    cfg = fixtures.shrink_hrnet(tcfg.demo_config())
    net = numpy_init(factory.build_heatmap_model(cfg), seed)
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g))
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + .5)
    return cfg, {k: (v.to(dtype) if v.is_floating_point() else v)
                 for k, v in net.state_dict().items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_state_dict_round_trips_through_the_flax_tree(dtype):
    """to_jax_variables then from_jax_variables returns every tensor bit
    for bit (num_batches_tracked, which flax has no slot for, as 0), and
    the tree equals the JAX package's torch_to_flax of the same state."""
    _, sd = _hrnet_state(dtype)
    back = tw.from_jax_variables(tw.to_jax_variables(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        want = torch.zeros_like(v) if k.endswith("num_batches_tracked") \
            else v
        assert back[k].dtype == v.dtype and torch.equal(back[k], want), k
    if dtype == torch.float32:
        _assert_same_leaves(tw.to_jax_variables(sd), tc.torch_to_flax(sd))


def test_port_written_msgpack_loads_in_flax(tmp_path):
    """HC.msgpack written by the port from a module loads through the JAX
    package's load_variables to the JAX converter's arrays, bit for bit,
    and the file's bytes are the JAX package's save_variables bytes."""
    cfg, sd = _hrnet_state()
    net = numpy_init(factory.build_heatmap_model(cfg), 0)
    net.load_state_dict(sd)
    port = tckpt.save_variables(str(tmp_path / "port" / "HC.msgpack"), net)
    ref = tc.torch_to_flax(sd)
    _assert_same_leaves(jckpt.load_variables(port), ref)
    jax_path = jckpt.save_variables(str(tmp_path / "jax.msgpack"), ref)
    with open(port, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_jax_written_msgpack_loads_strictly(tmp_path):
    cfg, sd = _hrnet_state(seed=6)
    path = jckpt.save_variables(str(tmp_path / "HC.msgpack"),
                                tc.torch_to_flax(sd))
    loaded = tw.from_jax_variables(tckpt.load_variables(path))
    net = factory.build_heatmap_model(cfg)
    net.load_state_dict(loaded, strict=True)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_missing_msgpack_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="'msgpack'"):
        tckpt.save_variables(str(tmp_path / "x.msgpack"), _tree())


def test_igr_cli_resumes_from_a_jax_written_msgpack(tmp_path):
    """The port's IGR CLI with ``training_settings.resume`` = a JAX-written
    HC.msgpack starts from its weights (at lr 0 the parameters leave the
    run unchanged, bit for bit) and writes HC.pth and HC.msgpack that hold
    the same tensors; the epoch snapshot has its .msgpack too."""
    scenes = [fixtures.random_scene(np.random.RandomState(i), n_cars=2,
                                    n_peds=0) for i in range(2)]
    root, _ = fixtures.make_kitti_root(tmp_path / "kitti", n_images=2,
                                       classes_per_image=scenes)
    _, sd = _hrnet_state(seed=7)
    resume = jckpt.save_variables(str(tmp_path / "jax" / "HC.msgpack"),
                                  tc.torch_to_flax(sd))
    cfg = fixtures.shrink_hrnet(tcfg.train_igrs_config())
    cfg["dataset"]["root"] = root
    cfg["dirs"] = {"output": str(tmp_path / "out")}
    cfg["device"] = "cpu"
    cfg["heatmapModel"]["pretrained"] = ""
    cfg["optimizer"]["lr"] = 0.0
    cfg["training_settings"].update(total_epochs=1, batch_size=1,
                                    resume=resume, debug=False,
                                    snapshot_epochs=[1])
    out = train_igrs.main(cfgs=cfg)
    ckpt = out["ckpt_dir"]
    hc = tw.load_torch_state_dict(os.path.join(ckpt, "HC.pth"))
    params = {n for n, _ in factory.build_heatmap_model(
        fixtures.shrink_hrnet(tcfg.demo_config())).named_parameters()}
    for k in params:
        assert torch.equal(hc[k], sd[k]), k
    _assert_same_leaves(
        jckpt.load_variables(os.path.join(ckpt, "HC.msgpack")),
        tc.torch_to_flax(hc))
    assert os.path.exists(os.path.join(ckpt, "HC_epoch1.msgpack"))
