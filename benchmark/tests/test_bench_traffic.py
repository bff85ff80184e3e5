"""The traffic generator: one seed gives the same inputs; two seeds give
the same work (box counts, sizes, dispatch totals) in another order and
with other pixels."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import run, traffic


def _mix(name, small=True):
    with open(os.path.join(run.ROOT, "benchmark", "traffic",
                           name + ".json")) as f:
        tr = json.load(f)
    if small:
        tr["frame_hw"] = [64, 160]
    return tr


@pytest.mark.parametrize("name", ["offline_batch64_car",
                                  "offline_batch128_ped"])
def test_seeded(name):
    tr = _mix(name)
    big = 2 ** 31 + 77
    a, b = traffic.make(tr, big, "cpu"), traffic.make(tr, big, "cpu")
    c = traffic.make(tr, 5, "cpu")
    assert torch.equal(a.frames, b.frames) and a.groups == b.groups
    assert not torch.equal(a.frames, c.frames)
    tot = [sorted(sum(len(w.boxes[s]) for s in g) for g in w.groups)
           for w in (a, c)]
    assert tot[0] == tot[1]
    assert all(np.array_equal(x, y) for x, y in zip(a.boxes, c.boxes))
    assert a.groups != c.groups


def test_boxes_follow_the_mix():
    tr = _mix("offline_batch64_car", small=False)
    boxes = traffic.box_sets(tr)
    n = np.array([len(b) for b in boxes])
    assert n.min() >= 1 and n.max() <= 20 and 5 < n.mean() < 7
    hs = np.concatenate([b[:, 3] - b[:, 1] for b in boxes])
    assert hs.min() >= 22.0 - 1e-9

