"""The keypoint families, found by ``heatmapModel.name``
(``egonet_ref.keypoint_model``): the aliases and the message for an
unknown name or an alias of a family without a file; a stand-in family
that is a file alone (``keypoint_standin.py``) carried through the
seeded weights, the work count, the reference and the tiny cut; and
HRNet's seeded weights and reference outputs held to digests taken
before the family modules were split out."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import benchmark.reference as reference_pkg
from benchmark import run, traffic, weights, work
from benchmark.reference import egonet_ref as ref
from benchmark.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))


def _config(name):
    conf = next(c for c in run.load_spec()["configs"] if c["name"] == name)
    with open(os.path.join(run.ROOT, conf["file"])) as f:
        return json.load(f)


def _tiny_inputs(config, seed, n=4):
    """The tiny mix of ``config``'s first cell: its frames and its first
    ``n`` frames' crops."""
    mix = next(c["traffic"] for c in run.load_spec()["workloads"]
               if c["config"] == config)
    with open(os.path.join(run.ROOT, "benchmark", "traffic",
                           mix + ".json")) as f:
        tr = tiny.shrink_traffic(json.load(f))
    wl = traffic.make(tr, seed, "cpu")
    return wl, wl.items(list(range(n)))


@pytest.mark.parametrize("name", ["hrnet", "pose_hrnet", "HRNet", None])
def test_names_and_aliases(name):
    hm = {} if name is None else {"name": name}
    assert ref.keypoint_model({"heatmapModel": hm}).__name__ == \
        "benchmark.reference.keypoint_hrnet"


@pytest.mark.parametrize("name", ["nosuch", "made_up_alias", "../hrnet"])
def test_an_unknown_name_names_the_file(name, monkeypatch):
    """An unknown name, an alias of a family that has no file, and a name
    that is no module's: none is a name the port's factory accepts, so a
    family's file added later leaves every case standing."""
    monkeypatch.setitem(ref.KEYPOINT_ALIASES, "made_up_alias",
                        "made_up_family")
    file = "keypoint_" + ref.KEYPOINT_ALIASES.get(name, name) + ".py"
    with pytest.raises(FileNotFoundError) as err:
        ref.keypoint_model({"heatmapModel": {"name": name}})
    assert os.path.join(os.path.dirname(ref.__file__), file) in str(err.value)


@pytest.fixture
def standin(monkeypatch):
    """``keypoint_standin.py`` on ``benchmark.reference``'s search path."""
    monkeypatch.setattr(reference_pkg, "__path__",
                        [*reference_pkg.__path__, HERE])
    yield
    sys.modules.pop("benchmark.reference.keypoint_standin", None)


def test_a_family_is_a_file(standin):
    """Weights, work, reference and tiny cut of a family that no file of
    the benchmark names."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _config("egonet_w32_ped")
    cfg["heatmapModel"] = {"name": "standin", "num_joints": 33,
                           "input_size": [128, 128],
                           "heatmap_size": [16, 16],
                           "extra": {"widths": [32, 64, 128]}}
    family = ref.keypoint_model(cfg)
    assert family.__file__ == os.path.join(HERE, "keypoint_standin.py")
    big = work.crop_work(cfg)

    cfg = tiny.shrink_config(cfg)
    assert cfg["heatmapModel"]["extra"]["widths"] == [8, 16]
    assert cfg["limits"] == tiny.TINY_LIMITS
    wk = work.crop_work(cfg)
    assert 0 < wk["keypoint_flops"] < big["keypoint_flops"]
    state = {k: torch.randn(s) for k, s in family.shapes(cfg).items()
             if not k.endswith("num_batches_tracked")}
    with FlopCounterMode(display=False) as counter:
        family.forward(state, torch.zeros(1, 3, 64, 64), cfg)
    assert wk["keypoint_flops"] == counter.get_total_flops()
    assert wk["weight_bytes"] == 2 * (3 * 8 * 9 + 8 * 16 * 9 + 16 * 33)

    wl, items = _tiny_inputs("egonet_w32_ped", seed=5)
    ks, lst, ls_stats = weights.make(cfg, 5, "cpu", wl.frames, items)
    assert set(ks) == set(family.shapes(cfg))
    assert float(ks["features.1.bn.running_var"][0]) != 1.0  # calibrated
    out = ref.run(wl.frames, items, ks, lst, ls_stats, cfg)
    n = len(items["frame"])
    assert out["kpts_2d"].shape == (n, 33, 2) and n > 0
    assert all(np.isfinite(v).all() for v in out.values())
    # every keypoint lies inside its crop
    box = np.asarray(items["box"], np.float64)
    cx = (box[:, 0] + box[:, 2]) / 2
    assert (np.abs(out["kpts_2d"][..., 0] - cx[:, None])
            <= out["crop_w"][:, None] / 2 + 1e-6).all()


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        v = arrays[k]
        a = np.ascontiguousarray(v.cpu().numpy() if torch.is_tensor(v)
                                 else np.asarray(v))
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


# crop_work at the published widths, and at the tiny cut of each
# configuration and its cell's mix, seed 1, on one CPU thread: digests of
# the (keypoint, lifter, LS) states and of the reference's outputs for the
# first 4 frames' crops (21)
GOLDEN = {
    "egonet_w48_car": (42_034_513_920, 127_794_408,
                       ("06f5343a4a1d3438", "e3537432d3d0219c",
                        "7708296b3de9aa5b", "b3d45cc4e7212374")),
    "egonet_w32_ped": (11_573_002_368, 57_664_144,
                       ("a9ddcd0b9ec4c987", "66813f3b4a50ce18",
                        "c5dbf8f746d77cec", "aaf3d597b53a9775")),
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_hrnet_numbers_stand(name, one_thread):
    flops, weight_bytes, digests = GOLDEN[name]
    cfg = _config(name)
    wk = work.crop_work(cfg)
    assert (wk["keypoint_flops"], wk["weight_bytes"]) == (flops,
                                                          weight_bytes)
    cfg = tiny.shrink_config(copy.deepcopy(cfg))
    wl, items = _tiny_inputs(name, seed=1)
    hs, lst, ls_stats = weights.make(cfg, 1, "cpu", wl.frames, items)
    out = ref.run(wl.frames, items, hs, lst, ls_stats, cfg)
    assert len(out["alpha"]) == 21
    assert (_digest(hs), _digest(lst), _digest(ls_stats),
            _digest(out)) == digests
