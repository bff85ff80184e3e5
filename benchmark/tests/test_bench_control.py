"""The comparison that decides ``correct``, driven through whole runs of
the tiny cells on the CPU (the harness's look for a card skipped): the
program passes; its int8 activation path (the control) and a timed path
broken underneath (an answer altered where it is produced; half of each
batch left out; one residual block of the trunk off by a quarter) do
not.  On the chip the same control runs at each
cell's own size (``--control``; PERF.md has the readings)."""

import pytest
import torch

from benchmark import run
from benchmark.reference import egonet_ref, keypoint_hrnet

SPEC = run.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
# the cells whose keypoint model is HRNet, whose BasicBlock a test breaks
HRNET_CELLS = [c for c in CELLS if egonet_ref.keypoint_model(
    run.resolve(SPEC, c)["cfg"]) is keypoint_hrnet]


def _run(root, cell, seed=11, **kw):
    res = run.resolve(run.load_spec(root), cell, root)
    return run.execute(res, seed, 0.6, False, "cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(tiny_root, cell):
    line = _run(tiny_root, cell)
    assert line["correct"], line["compared"]
    assert list(line)[-1] == "compared" and line["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not(tiny_root, cell):
    line = _run(tiny_root, cell, control=True)
    assert not line["correct"], line["compared"]


def _altered_alpha(tail):
    def broken(self, *args, **kwargs):
        out = tail(self, *args, **kwargs)
        out[:, -2] += 0.05                     # alpha, where it is made
        return out
    return broken


def _half_left_out(tail):
    def broken(self, patches, *args, **kwargs):
        out = tail(self, patches, *args, **kwargs)
        half = (len(out) + 1) // 2
        out[half:] = out[:len(out) - half]     # the rest copies the first
        return out
    return broken


@pytest.mark.parametrize("fault", [_altered_alpha, _half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not(tiny_root, cell, fault, monkeypatch):
    from egonet_tpu_torch.models.egonet import EgoNet
    monkeypatch.setattr(EgoNet, "_tail", fault(EgoNet._tail))
    line = _run(tiny_root, cell)
    assert not line["correct"], line["compared"]


def test_a_missing_answer_is_not(tiny_root, monkeypatch):
    from egonet_tpu_torch.models.egonet import EgoNet
    finalize = EgoNet._finalize

    def drop_one(self, pending):
        recs = finalize(self, pending)
        recs.pop(next(iter(recs)))
        return recs
    monkeypatch.setattr(EgoNet, "_finalize", drop_one)
    line = _run(tiny_root, "w32_ped_offline_batch128")
    assert not line["correct"] and line["compared"]["missing"]["value"] > 0


@pytest.mark.parametrize("cell", HRNET_CELLS)
def test_one_block_off_is_not(tiny_root, cell, monkeypatch):
    """One BasicBlock of the trunk (the first of the second branch's
    width to run) returns its output 25% too large: a kernel-level fault
    in one layer, whatever route (fused or not) the block takes."""
    from egonet_tpu_torch.models import hrnet
    block_run, hit = hrnet.BasicBlock.run, []

    def off(self, ops, x, folded=None):
        y = block_run(self, ops, x, folded)
        if self.conv2.out_channels == 16 and not hit:
            hit.append(self)
        return y * 1.25 if hit[:1] == [self] else y
    monkeypatch.setattr(hrnet.BasicBlock, "run", off)
    line = _run(tiny_root, cell)
    assert hit and not line["correct"], line["compared"]


def test_control_needs_the_int8_path(tiny_root, monkeypatch):
    """A keypoint model that does not take ``act_quant: int8`` stops a
    control run, which would otherwise read at full precision."""
    from egonet_tpu_torch.models import factory
    build = factory._REGISTRY["hrnet"]

    def ignoring(cfgs, dtype=torch.float32):
        net = build(cfgs, dtype=dtype)
        net.act_quant = "none"
        return net
    monkeypatch.setitem(factory._REGISTRY, "hrnet", ignoring)
    with pytest.raises(SystemExit, match="did not take act_quant 'int8'"):
        _run(tiny_root, "w32_ped_offline_batch128", control=True)


def test_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "w48_car_offline_batch64", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
