"""The port's KITTI reader, PNG reader and decoded-image store
(egonet_tpu_torch/data/) against the JAX package's reader, cv2 and PIL.

Reader outputs must equal the JAX ones (arrays to 1e-12, the raw label
dicts exactly); the PNG reader must equal ``cv2.imread`` byte for byte,
on the fixture PNGs and on PNGs written here with each row filter."""

import os
import struct
import zlib

import numpy as np
import pytest

from egonet_tpu.config import default_demo_config
from egonet_tpu.data import kitti as jkitti
from egonet_tpu_torch.config import demo_config
from egonet_tpu_torch.data import kitti, png
from egonet_tpu_torch.data.image_store import ImageStore, decode_image
from tests import fixtures


# ---------------------------------------------------------------------------
# a PNG writer with a chosen row filter per row (cv2 chooses its own)
# ---------------------------------------------------------------------------

def _filter_row(raw, prev, kind, bpp):
    r, p = raw.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) >> 1
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) & 255).astype(np.uint8)


def _write_png(path, img, kinds, color_type=None):
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch] if color_type is None \
        else color_type
    flat = img.reshape(h, -1)
    data, prev = bytearray(), np.zeros(flat.shape[1], np.uint8)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        data.append(kind)
        data += _filter_row(flat[y], prev, kind, ch).tobytes()
        prev = flat[y]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(data)))
                + chunk(b"IEND", b""))


def _cv2_rgb(path):
    import cv2
    return cv2.cvtColor(cv2.imread(path, 1 | 128), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_matches_cv2_per_filter(tmp_path, kinds, channels):
    rng = np.random.RandomState(channels)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    img = rng.randint(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _write_png(path, img, kinds)
    got = png.decode(path)
    assert got.dtype == np.uint8 and got.shape == (23, 37, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_kitti")
    return fixtures.make_kitti_root(tmp, n_images=4, with_predictions=True)


def test_png_decode_and_size_match_cv2_and_pil_on_fixture(kitti_root):
    from PIL import Image
    root, _ = kitti_root
    img_dir = os.path.join(root, "training", "image_2")
    for name in sorted(os.listdir(img_dir))[:2]:
        path = os.path.join(img_dir, name)
        np.testing.assert_array_equal(png.decode(path), _cv2_rgb(path))
        with Image.open(path) as im:
            assert png.image_size(path) == im.size


def test_png_rejects_unsupported(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    path = str(tmp_path / "p.png")
    for color_type in (3, 4):                             # palette, gray+alpha
        _write_png(path, img[:, :, :1 + color_type // 4], [0],
                   color_type=color_type)
        with pytest.raises(ValueError, match=f"color type {color_type}"):
            png.decode(path)
    with open(str(tmp_path / "x.png"), "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError):
        png.decode(str(tmp_path / "x.png"))
    with pytest.raises(ValueError):
        png.image_size(str(tmp_path / "x.png"))


# ---------------------------------------------------------------------------
# reader parity
# ---------------------------------------------------------------------------

def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], (float, int))):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == np.shape(b), where
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   a.astype(np.float64), rtol=0,
                                   atol=1e-12, err_msg=where)
    else:
        assert a == b, where


def _cfgs(root, split_cfg):
    jc, tc = default_demo_config(), demo_config()
    for c in (jc, tc):
        c["dataset"]["root"] = root
        c["dataset"].update(split_cfg)
    return jc, tc


@pytest.mark.parametrize("split", ["valid", "trainvalid"])
def test_reader_matches_jax(kitti_root, split):
    root, pred_dir = kitti_root
    jc, tc = _cfgs(root, {})
    jd = jkitti.get_dataset(jc, None, split)
    td = kitti.get_dataset(tc, None, split)
    assert td.image_names == jd.image_names and len(td) == len(jd)
    _assert_same(jd.annot_dict, td.annot_dict, "annot_dict")
    _assert_same(jd.read_predictions(pred_dir),
                 td.read_predictions(pred_dir), "predictions")


def test_reader_score_column_empty_label_and_test_split(kitti_root,
                                                       tmp_path):
    root, pred_dir = kitti_root
    # an empty label file and a detector file without the score column
    lbl = os.path.join(root, "training", "label_2", "000003.txt")
    with open(lbl) as f:
        kept = f.read()
    preds = str(tmp_path / "preds")
    os.makedirs(preds)
    for name in sorted(os.listdir(pred_dir)):
        with open(os.path.join(pred_dir, name)) as f:
            lines = [" ".join(ln.split(" ")[:15]) for ln in
                     f.read().split("\n") if ln.strip()]
        with open(os.path.join(preds, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    try:
        with open(lbl, "w") as f:
            f.write("")
        jc, tc = _cfgs(root, {})
        jd = jkitti.get_dataset(jc, None, "valid")
        td = kitti.get_dataset(tc, None, "valid")
        assert "000003.png" not in td.annot_dict
        _assert_same(jd.annot_dict, td.annot_dict, "annot_dict")
        _assert_same(jd.read_predictions(preds), td.read_predictions(preds),
                     "predictions without score")
    finally:
        with open(lbl, "w") as f:
            f.write(kept)
    # the test split reads raw detector boxes and has no labels
    test_dir = os.path.join(root, "testing")
    for sub in ("image_2", "calib", "ImageSets"):
        os.makedirs(os.path.join(test_dir, sub), exist_ok=True)
    with open(os.path.join(test_dir, "ImageSets", "test.txt"), "w") as f:
        f.write("000000\n000001\n")
    for n in ("000000", "000001", "000002", "000003"):
        for sub, ext in (("image_2", ".png"), ("calib", ".txt")):
            src = os.path.join(root, "training", sub, n + ext)
            with open(src, "rb") as fi, open(
                    os.path.join(test_dir, sub, n + ext), "wb") as fo:
                fo.write(fi.read())
    jd = jkitti.get_dataset(jc, None, "test")
    td = kitti.get_dataset(tc, None, "test")
    _assert_same(jd.annot_dict, td.annot_dict, "test annot_dict")
    _assert_same(jd.read_predictions(pred_dir),
                 td.read_predictions(pred_dir), "test predictions")


def test_gather_dict_matches_jax(kitti_root):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_tools_inference",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "inference.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    from egonet_tpu_torch.tools import inference as tcli
    root, pred_dir = kitti_root
    jc, tc = _cfgs(root, {})
    jd = jkitti.get_dataset(jc, None, "valid")
    td = kitti.get_dataset(tc, None, "valid")
    paths = {"path": [td.paths.image_path(n) for n in td.image_names]}
    for thres in (0.0, 0.85):
        _assert_same(
            jcli.gather_dict(paths, jd.read_predictions(pred_dir), thres,
                             target_ar=1.0, enlarge=1.2),
            tcli.gather_dict(paths, td.read_predictions(pred_dir), thres,
                             target_ar=1.0, enlarge=1.2), "gather_dict")


def test_training_experiments_are_not_ported(kitti_root):
    _, tc = _cfgs(kitti_root[0], {})
    tc["exp_type"] = "2dto3d"
    with pytest.raises(NotImplementedError, match="queued"):
        kitti.get_dataset(tc, None, "train")


def test_generate_empty_files_matches_jax(tmp_path):
    from egonet_tpu.io import kitti_writer as jw
    from egonet_tpu_torch.io import kitti_writer as tw
    labels = tmp_path / "labels"
    labels.mkdir()
    for n in ("000000", "000001", "000002"):
        (labels / f"{n}.txt").write_text("x")
    counts = []
    for mod, out in ((jw, tmp_path / "j"), (tw, tmp_path / "t")):
        (out / "data").mkdir(parents=True)
        (out / "data" / "000001.txt").write_text("Car ...")
        counts.append(mod.generate_empty_files(str(out), str(labels)))
        assert sorted(os.listdir(out / "data")) == [
            "000000.txt", "000001.txt", "000002.txt"]
    assert counts == [2, 2]


# ---------------------------------------------------------------------------
# the decoded-image store (mirrors tests/test_image_store.py)
# ---------------------------------------------------------------------------

@pytest.fixture(params=["cv2", "png"])
def frame(request, tmp_path, monkeypatch):
    if request.param == "png":              # as on a host without cv2
        from egonet_tpu_torch.data import image_store
        monkeypatch.setattr(image_store, "available_decoder", lambda: "png")
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (24, 32, 3), dtype=np.uint8)
    path = str(tmp_path / "frame.png")
    _write_png(path, img, [0, 1, 2, 3, 4])
    return path, img, request.param


def test_ram_tier_hits(frame):
    path, img, decoder = frame
    store = ImageStore(max_bytes=1 << 20)
    np.testing.assert_array_equal(store.get(path), img)
    np.testing.assert_array_equal(store.get(path), img)
    stats = dict(store.stats)
    assert stats.pop("decode_s") >= 0.0
    assert stats == {"ram_hits": 1, "disk_hits": 0, "decodes": 1,
                     "decoder": decoder}


def test_disk_tier_survives_ram_clear(frame, tmp_path):
    path, img, decoder = frame
    store = ImageStore(max_bytes=1 << 20, disk_dir=str(tmp_path / "disk"))
    assert store.stats["decoder"] == decoder
    store.get(path)
    store.clear_ram()
    np.testing.assert_array_equal(store.get(path), img)
    assert store.stats["decodes"] == 1 and store.stats["disk_hits"] == 1
    files = os.listdir(str(tmp_path / "disk"))
    assert len(files) == 1 and files[0].endswith(".npy") \
        and ".tmp" not in files[0]


def test_disk_key_invalidates_on_rewrite(frame, tmp_path):
    path, img, _ = frame
    store = ImageStore(max_bytes=1 << 20, disk_dir=str(tmp_path / "disk"))
    store.get(path)
    new = (img // 2).astype(np.uint8)
    _write_png(path, new, [4])
    os.utime(path, ns=(1, 1))                    # force a new mtime key
    store.clear_ram()
    np.testing.assert_array_equal(store.get(path), new)
    assert store.stats["decodes"] == 2           # stale entry not served


def test_decoder_choice_and_missing_file(tmp_path, monkeypatch):
    import builtins
    from egonet_tpu_torch.data import image_store
    assert image_store.available_decoder() == "cv2"
    with pytest.raises(ValueError):
        decode_image(str(tmp_path / "nope.png"))
    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2 here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert image_store.available_decoder() == "png"
    assert ImageStore().stats["decoder"] == "png"
    with pytest.raises(ValueError):
        decode_image(str(tmp_path / "nope.png"))


def test_egonet_load_image_uses_store(tmp_path):
    """The facade decodes each frame once across repeated batches."""
    import torch
    from egonet_tpu_torch.models.egonet import EgoNet
    cfgs = fixtures.shrink_hrnet(demo_config())
    model = EgoNet(cfgs, dtype=torch.float32, device="cpu")
    assert model.image_store is not None
    rng = np.random.RandomState(1)
    path = str(tmp_path / "img.png")
    _write_png(path, rng.randint(0, 255, (128, 256, 3), dtype=np.uint8),
               [0, 4])
    annot = {"path": [path], "boxes": [np.array([[10.0, 10.0, 90.0, 90.0]])],
             "K": [np.eye(3)], "raw_txt_format": [[]]}
    for _ in range(3):
        model.forward_annot_dict(annot, canvas_hw=(128, 256))
    assert model.image_store.stats["decodes"] == 1
    assert model.image_store.stats["ram_hits"] == 2
