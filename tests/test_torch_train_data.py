"""The port's training data (egonet_tpu_torch/data/{kitti,loader,
normalization}.py) against the JAX package's on the fixture KITTI roots:
the '2dto3d' pairs and statistics, the 'instanceto2d' and 'finetune'
records, host_shard, jitter_bbox, ArrayBatchLoader and IGRBatchLoader
batches (with meta, cap subsampling and ss slots) are bit-equal; the
shipped training configs' dicts equal their YAML."""

import os

import numpy as np
import pytest
import yaml

from egonet_tpu.data import kitti as jk
from egonet_tpu.data import loader as jld
from egonet_tpu.data import normalization as jn
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch.data import kitti as tk
from egonet_tpu_torch.data import loader as tld
from egonet_tpu_torch.data import normalization as tn
from tests import fixtures

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "egonet_tpu",
                       "configs")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    scenes = [fixtures.random_scene(np.random.RandomState(i), n_cars=3,
                                    n_peds=1) for i in range(6)]
    r, _ = fixtures.make_kitti_root(tmp_path_factory.mktemp("td"),
                                    n_images=6, classes_per_image=scenes)
    return r


def _yaml(name):
    with open(os.path.join(CONFIGS, name)) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name,fn", [
    ("KITTI_train_lifting.yml", tcfg.train_lifting_config),
    ("KITTI_train_IGRs.yml", tcfg.train_igrs_config)])
def test_training_config_dicts_equal_the_yaml(name, fn):
    assert fn() == _yaml(name)


def _eq(a, b, what=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _eq(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def _lift_cfg(root, out_rep, aug_times=7, classes=("Car",)):
    cfg = tcfg.train_lifting_config()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["lft_out_rep"] = out_rep
    cfg["dataset"]["detect_classes"] = list(classes)
    cfg["training_settings"]["lft_aug_times"] = aug_times
    cfg["seed"] = 3
    return cfg


@pytest.mark.parametrize("out_rep", ["R3d", "R3d+T"])
@pytest.mark.parametrize("classes", [("Car",), ("Car", "Pedestrian")])
def test_lifting_pairs_and_statistics_are_bit_equal(root, out_rep, classes):
    cfg = _lift_cfg(root, out_rep, classes=classes)
    jtr, jva = jk.prepare_data(cfg)
    ttr, tva = tk.prepare_data(cfg)
    for j, t in ((jtr, ttr), (jva, tva)):
        _eq(t.input, j.input, "input")
        _eq(t.output, j.output, "output")
        _eq(t.roots, j.roots, "roots")
        assert len(t) == len(j) == len(j.input)
    _eq(ttr.statistics, jtr.statistics, "statistics")
    assert len(ttr.input) > 2 * len(tva.input) > 0     # augmented train


@pytest.mark.parametrize("exp_type", ["instanceto2d", "finetune"])
def test_training_records_are_bit_equal(root, exp_type):
    cfg = tcfg.train_igrs_config()
    cfg["dataset"]["root"] = root
    cfg["exp_type"] = exp_type
    for split in ("train", "valid"):
        j = jk.KITTIDataset(cfg, split)
        t = tk.KITTIDataset(cfg, split)
        assert len(t) == len(j) > 0
        _eq(t.records, j.records, f"{exp_type} {split}")


def test_instance_record_cache_round_trip(root, tmp_path):
    cfg = tcfg.train_igrs_config()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["pre-process"] = True
    first = tk.KITTIDataset(cfg, "train")
    cache = first._instance_record_cache_path()
    assert os.path.exists(cache)
    assert cache == jk.KITTIDataset(cfg, "train")._instance_record_cache_path()
    _eq(tk.KITTIDataset(cfg, "train").records, first.records)
    os.remove(cache)


@pytest.mark.parametrize("individual", [False, True])
def test_normalization_matches_jax(individual):
    rng = np.random.RandomState(1)
    data = rng.randn(20, 66) * 50 + 100
    jm, js = jn.get_statistics_1d(data)
    tm, ts = tn.get_statistics_1d(data)
    _eq(tm, jm)
    _eq(ts, js)
    _eq(tn.normalize_1d(data, tm, ts, individual),
        jn.normalize_1d(data, jm, js, individual))
    _eq(tn.unnormalize_1d(data, tm, ts), jn.unnormalize_1d(data, jm, js))


@pytest.mark.parametrize("n,index,count,epoch", [
    (10, 0, 1, 0), (10, 1, 3, 0), (10, 2, 3, 1), (10, 0, 4, 5),
    (3, 3, 5, 2), (7, 1, 2, 3)])
def test_host_shard_matches_jax(n, index, count, epoch):
    recs = list(range(n))
    assert tld.host_shard(recs, index, count, epoch) == \
        jld.host_shard(recs, index, count, epoch)


def test_host_shard_single_process_is_identity():
    assert tld.host_shard(list(range(5))) == list(range(5))
    with pytest.raises(ValueError):
        tld.host_shard(list(range(5)), 3, 3)


def test_jitter_bbox_matches_jax():
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for box in ([10.0, 20.0, 110.0, 80.0], [0.0, 0.0, 5.0, 300.0]):
        for _ in range(5):
            assert tld.jitter_bbox(box, (0.4, 0.3), a) == \
                jld.jitter_bbox(box, (0.4, 0.3), b)


@pytest.mark.parametrize("drop", [False, True])
def test_array_batch_loader_orders_match_jax(drop):
    rng = np.random.RandomState(2)
    x, y = rng.randn(23, 4).astype(np.float32), rng.randn(23, 3)
    jl = jld.ArrayBatchLoader(x, y, 8, seed=5, drop_remainder=drop)
    tl = tld.ArrayBatchLoader(x, y, 8, seed=5, drop_remainder=drop)
    assert tl.steps_per_epoch() == jl.steps_per_epoch()
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        _eq(list(tl.epoch()), list(jl.epoch()), f"epoch {epoch}")
    tl.reseed(9)
    jl.reseed(9)
    _eq(list(tl.epoch(shuffle=False)), list(jl.epoch(shuffle=False)))
    _eq(list(tl.epoch()), list(jl.epoch()))


def _igr_cfg(root, batch_size=2, jitter=True):
    cfg = tcfg.train_igrs_config()
    fixtures.shrink_hrnet(cfg)
    cfg["dataset"]["root"] = root
    cfg["heatmapModel"]["jitter_bbox"] = jitter
    cfg["training_settings"]["batch_size"] = batch_size
    return cfg


def _ss_record(root, tmp):
    """Unlabeled boxes over the fixture's train frames."""
    img_dir = os.path.join(root, "training", "image_2")
    names = sorted(os.listdir(img_dir))[:2]
    rng = np.random.RandomState(8)
    boxes = [np.array([[x, 100.0, x + 90.0, 190.0]
                       for x in rng.uniform(0, 900, 5)]) for _ in names]
    return {"paths": [os.path.join(img_dir, n) for n in names],
            "boxes": boxes}


@pytest.mark.parametrize("case", ["plain", "cap", "ss", "eval", "png"])
def test_igr_batch_loader_is_bit_equal(root, tmp_path, case, monkeypatch):
    """Two epochs of batches, meta included, from the same seed: random
    shuffle and box jitter; 'cap' subsamples above a cap of 5 and pads with
    duplicates; 'ss' appends unlabeled crops in one extra canvas slot;
    'eval' is the unshuffled, unjittered validation loader; 'png' decodes
    the frames with the port's PNG reader instead of cv2."""
    cfg = _igr_cfg(root, batch_size=3 if case == "cap" else 2)
    records = jk.KITTIDataset(cfg, "train").records
    kw = {"seed": 11}
    train = case != "eval"
    if case == "cap":
        kw["max_instances"] = 5
    if case == "ss":
        kw.update(ss_record=_ss_record(root, tmp_path), ss_max_per_img=4)
        kw["max_instances"] = 8
    if case == "png":
        from egonet_tpu_torch.data import image_store
        monkeypatch.setattr(image_store, "available_decoder", lambda: "png")
    jl = jld.IGRBatchLoader(records, cfg, train=train, **kw)
    tl = tld.IGRBatchLoader(records, cfg, train=train, **kw)
    assert len(tl) == len(jl)
    n_batches = 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl.epoch()), list(tl.epoch())
        _eq(tb, jb, f"{case} epoch {epoch}")
        n_batches += len(tb)
    assert n_batches == 2 * len(tl)
    if case == "cap":
        assert any(b["meta"]["count"] == 5 for b in tb)
    if case == "ss":
        assert any((b["sup_mask"] < b["mask"]).any() for b in tb)


def test_prefetched_epoch_yields_the_same_batches(root):
    cfg = _igr_cfg(root)
    records = jk.KITTIDataset(cfg, "train").records
    a = tld.IGRBatchLoader(records, cfg, train=True, seed=2)
    b = tld.IGRBatchLoader(records, cfg, train=True, seed=2)
    _eq(list(a.prefetched_epoch()), list(b.epoch()))
