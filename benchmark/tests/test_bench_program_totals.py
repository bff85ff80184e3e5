"""The reader of the program's always-on span totals: the set-up's weight
draw from a built facade, and nothing from a program without totals or
without a draw."""

import pytest

from benchmark import run
from benchmark.tests import tiny


def test_init_weights_s_reads_the_draw():
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.utils import profiling
    read = run.reader("init_weights_s")
    profiling.reset_totals()
    assert read({}) is None
    cfg = tiny.shrink_config(demo_config())
    del cfg["limits"]
    EgoNet(cfg, device="cpu")
    count, wall, _ = profiling.totals()["init_weights"]
    assert count == 1 and read({}) == pytest.approx(wall) and wall > 0


def test_init_weights_s_without_totals(monkeypatch):
    from egonet_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "totals")
    assert run.reader("init_weights_s")({}) is None
