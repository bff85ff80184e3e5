"""The run's process settings: the environment ``run.main`` sets before
torch loads, and the cyclic collector handed back whole once a driver
returns (the offline driver freezes what is alive after each finished
dispatch)."""

import gc
import os

import pytest

from benchmark import run


def test_main_sets_the_process_env(monkeypatch):
    for var, _value in run.PROCESS_ENV:
        monkeypatch.delenv(var, raising=False)
    # no card here: main stops at its look for one, after the settings
    assert run.main(["--workload", "w32_ped_offline_batch128", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert [(v, os.environ.get(v)) for v, _ in run.PROCESS_ENV] == [
        ("OMP_NUM_THREADS", "1"), ("CUDA_SCALE_LAUNCH_QUEUES", "4x")]


@pytest.mark.parametrize("trace", [False, True])
def test_nothing_stays_frozen(tiny_root, trace):
    res = run.resolve(run.load_spec(tiny_root), "w32_ped_offline_batch128",
                      tiny_root)
    before = gc.get_freeze_count()      # what the interpreter holds there
    frozen = []
    freeze = gc.freeze

    def counting():
        freeze()
        frozen.append(gc.get_freeze_count())

    gc.freeze = counting
    try:
        line = run.execute(res, 5, 0.6, trace, "cpu")
    finally:
        gc.freeze = freeze
    assert line["correct"], line["compared"]
    assert frozen and max(frozen) > before
    assert gc.get_freeze_count() <= before
