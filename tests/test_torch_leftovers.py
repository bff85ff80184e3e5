"""The last small pieces of the JAX package the port lacked, each held
against its JAX function on the same inputs: ``KITTIDataset.show_annot``,
``config.load_config(path, overrides)`` / ``merge_config`` / ``_DEFAULTS``,
``config.read_yaml_file`` / ``default_demo_config``,
``io/kitti_writer.apolloscape_str``, ``ImageStore.nbytes``,
``utils/logger.AverageMeter``, ``constants.compute_cr_indices`` and
``io/weights.check_conversion`` (``io/torch_convert.py``'s)."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from egonet_tpu import config as jcfg
from egonet_tpu import constants as jconst
from egonet_tpu.data import image_store as jstore
from egonet_tpu.data import kitti as jkitti
from egonet_tpu.io import kitti_writer as jwriter
from egonet_tpu.io import torch_convert as jconvert
from egonet_tpu.utils import logger as jlogger
from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch import constants as tconst
from egonet_tpu_torch.data import image_store as tstore
from egonet_tpu_torch.data import kitti as tkitti
from egonet_tpu_torch.data.png import decode as png_decode
from egonet_tpu_torch.io import kitti_writer as twriter
from egonet_tpu_torch.io import weights as tweights
from egonet_tpu_torch.utils import logger as tlogger
from tests import fixtures

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "egonet_tpu",
                       "configs")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    scenes = [fixtures.random_scene(np.random.RandomState(i), n_cars=2,
                                    n_peds=1) for i in range(2)]
    r, _ = fixtures.make_kitti_root(tmp_path_factory.mktemp("left"),
                                    n_images=2, classes_per_image=scenes)
    return r


def test_show_annot_draws_the_jax_figures(root, tmp_path):
    """Both figures of a frame, pixel for pixel the JAX package's."""
    pytest.importorskip("matplotlib")
    cfg = tcfg.demo_config()
    cfg["dataset"]["root"] = root
    cfg["dataset"]["detect_classes"] = ["Car", "Pedestrian"]
    name = "000001.png"
    got = tkitti.KITTIDataset(cfg, "valid").show_annot(
        name, str(tmp_path / "port"))
    ref = jkitti.KITTIDataset(cfg, "valid").show_annot(
        name, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == \
        ["000001.png_original.png", "000001.png_annotated.png"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(png_decode(g), png_decode(r))
    orig, annot = (png_decode(p) for p in got)
    # the cuboids drawn (and the tight bounding box they widen)
    assert orig.shape != annot.shape or (orig != annot).any()
    with pytest.raises(ValueError):
        empty = tmp_path / "empty.txt"
        empty.write_text("")
        tkitti.KITTIDataset(cfg, "valid").show_annot(
            name, str(tmp_path / "x"), label_path=str(empty))


@pytest.mark.parametrize("name", ["KITTI_inference_demo.yml",
                                  "KITTI_train_IGRs.yml"])
def test_load_config_with_overrides_equals_jax(name, tmp_path):
    """The shipped YAML with nested overrides (a new key, a replaced list,
    a dict over a scalar, a nested merge) and the defaults filled: the
    same dict as the JAX loader's; the base is not modified."""
    path = os.path.join(CONFIGS, name)
    overrides = {"dataset": {"root": "/data/kitti", "new_key": {"a": 1}},
                 "heatmapModel": {"input_size": [64, 64],
                                  "extra": {"final_conv_kernel": 3}},
                 "batch_to_show": 7, "name": {"replaced": True}}
    assert tcfg._DEFAULTS == jcfg._DEFAULTS
    got = tcfg.load_config(path, overrides=overrides)
    assert got == jcfg.load_config(path, overrides=overrides)
    assert got["dataset"]["root"] == "/data/kitti"
    assert got["visualize"] is False and got["batch_to_show"] == 7
    plain = tcfg.load_config(path)
    assert plain == jcfg.load_config(path)
    base = yaml.safe_load(open(path))
    merged = tcfg.merge_config(base, overrides)
    assert merged == jcfg.merge_config(base, overrides)
    assert base == yaml.safe_load(open(path))


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIGS)))
def test_read_yaml_file_equals_jax(name):
    path = os.path.join(CONFIGS, name)
    got = tcfg.read_yaml_file(path)
    assert got == jcfg.read_yaml_file(path)
    assert "config_path" not in got and got["dataset"]


def test_default_demo_config_equals_jax():
    """The JAX loader's dict of the demo YAML, without ``config_path`` (the
    port reads no file for it, and the inference CLI would copy the file
    that key names); a fresh dict each call."""
    got = tcfg.default_demo_config()
    ref = jcfg.default_demo_config()
    assert ref.pop("config_path").endswith("KITTI_inference_demo.yml")
    assert got == ref
    assert {k: got[k] for k in tcfg._DEFAULTS} == tcfg._DEFAULTS
    got["dataset"]["root"] = "elsewhere"
    assert tcfg.default_demo_config() == ref


def _lifter_variables():
    """The flax tree of a small lifter (numpy leaves)."""
    from egonet_tpu_torch.models.fc_lifter import FCModel
    model = FCModel(input_size=4, output_size=6, num_neurons=8,
                    num_blocks=1)
    return tweights.to_jax_variables(model.state_dict())


def _mutated(case):
    variables = _lifter_variables()
    converted = copy.deepcopy(variables)
    params = converted["params"]
    first = next(k for k in sorted(params) if "kernel" in params[k])
    if case == "missing":
        del params[first]["bias"]
        del converted["batch_stats"]
    elif case == "unexpected":
        params["extra_layer"] = {"kernel": np.zeros((2, 2), np.float32)}
        params[first]["extra_leaf"] = np.zeros(3, np.float32)
    elif case == "structure":
        params[first] = np.zeros(3, np.float32)
        converted["batch_stats"] = {"x": {"mean": {}}}
    elif case == "shape":
        params[first]["kernel"] = params[first]["kernel"][:, :-1]
        params[first]["bias"] = params[first]["bias"][None]
    return variables, converted


@pytest.mark.parametrize("case", ["match", "missing", "unexpected",
                                  "structure", "shape"])
def test_check_conversion_equals_jax(case):
    """The same mismatch strings, in the same order, from both packages;
    tensor leaves give the strings numpy leaves do."""
    variables, converted = _mutated(case)
    got = tweights.check_conversion(variables, converted)
    assert got == jconvert.check_conversion(variables, converted)
    assert bool(got) == (case != "match"), got
    as_tensors = copy.deepcopy(converted)

    def tensors(tree):
        for k, v in tree.items():
            tree[k] = tensors(v) if isinstance(v, dict) else \
                torch.from_numpy(np.asarray(v))
        return tree
    assert tweights.check_conversion(variables, tensors(as_tensors)) == got


def test_apolloscape_str_equals_jax():
    rng = np.random.RandomState(0)
    for row in rng.randn(20, 7) * [1, 1, 3, 10, 2, 40, 0.5]:
        assert twriter.apolloscape_str(*row) == jwriter.apolloscape_str(*row)
    assert twriter.apolloscape_str(0.1, -0.2, 3.14159, 1, 2, 30.25, .9) \
        == "-0.200 3.142 0.100 1.000 2.000 30.250 0.900"


def test_image_store_nbytes_equals_jax(root):
    """Bytes held in RAM after each get, and after eviction and a clear,
    as the JAX store counts them."""
    frames = [os.path.join(root, "training", "image_2", f"{i:06d}.png")
              for i in (0, 1, 0)]
    one = fixtures.IMG_H * fixtures.IMG_W * 3
    for limit in (4 * one, one + 1):
        ours, ref = tstore.ImageStore(limit), jstore.ImageStore(limit)
        seen = []
        for f in frames:
            ours.get(f)
            ref.get(f)
            assert ours.nbytes == ref.nbytes
            seen.append(ours.nbytes)
        assert seen == ([one, 2 * one, 2 * one] if limit > 2 * one
                        else [one, one, one])
        ours.clear_ram()
        assert ours.nbytes == 0


def test_average_meter_equals_jax():
    ours, ref = tlogger.AverageMeter(), jlogger.AverageMeter()
    rng = np.random.RandomState(1)
    assert vars(ours) == vars(ref)
    for val, n in zip(rng.rand(10), rng.randint(1, 5, 10)):
        ours.update(float(val), int(n))
        ref.update(float(val), int(n))
        assert vars(ours) == vars(ref)
    ours.reset()
    assert vars(ours) == vars(jlogger.AverageMeter())


def test_compute_cr_indices_equals_jax():
    got = tconst.compute_cr_indices()
    np.testing.assert_array_equal(got, jconst.compute_cr_indices())
    np.testing.assert_array_equal(got, tconst.CR_INDICES)
    assert got.shape == (12, 4)
