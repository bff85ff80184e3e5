"""The port's multi-card paths as far as this host reaches them:
``chip_smoke.py --cards N`` refuses a host without N cards before it
builds or loads anything; its mesh sizes come in turns; the rigid solve's
static gathers (``geometry/rigid._take``, which replaced Python-list
indexing, a host-to-device copy that waits for the card) equal list
indexing; and, marked ``cuda`` (it skips without a card), a W48 bf16
dispatch on one card and over a mesh makes no host synchronisation
(``torch.cuda.set_sync_debug_mode("error")``), the counterpart of the
check in ``chip_smoke.py``'s mesh phase."""

import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
from egonet_tpu_torch.geometry import rigid

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cards_flag_without_a_card_returns_before_any_kernel():
    """No visible card: ``main(["--cards", "4"])`` returns 2 and has
    imported nothing of the port (no build, no kernel wrapper)."""
    code = ("import sys, chip_smoke; rc = chip_smoke.main(['--cards', '4']);"
            " print(rc, [m for m in sys.modules"
            " if m.startswith('egonet_tpu_torch')])")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=HERE, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "[]"], out.stdout
    assert "no CUDA device" in out.stderr


def test_cards_flag_raises_when_fewer_cards_are_visible():
    """Two visible cards and ``--cards 4``: an error, never a smaller
    mesh."""
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        device_count=lambda: 2))
    with pytest.raises(RuntimeError, match="--cards 4: 2 CUDA device"):
        chip_smoke.multicard_only(fake, np, "card", 4)


@pytest.mark.parametrize("n,order", [(1, [1, 1]), (2, [1, 2, 2, 1]),
                                     (3, [1, 3, 2, 2, 3, 1]),
                                     (4, [1, 4, 2, 2, 4, 1])])
def test_mesh_sizes_come_in_turns(n, order):
    assert chip_smoke._mc_turns(n) == order


@pytest.mark.parametrize("seed", range(4))
def test_static_gathers_equal_list_indexing(seed):
    """Runs of a constant step as slices, gathered with ``torch.cat``:
    bit-equal to indexing with the list, for the cuboid's edge lists and
    random lists (repeats, descents, single entries)."""
    rng = random.Random(seed)
    x = torch.randn(3, 12, 4, generator=torch.Generator().manual_seed(seed))
    lists = [rigid._EDGE_P, rigid._EDGE_C] + [
        [rng.randrange(12) for _ in range(rng.randint(1, 16))]
        for _ in range(50)]
    for idx in lists:
        for dim in (1, 2):
            if max(idx) >= x.shape[dim]:
                continue
            want = x[:, idx] if dim == 1 else x[:, :, idx]
            assert torch.equal(rigid._take(x, dim, rigid._runs(idx)), want)
    assert len(rigid._EDGE_P_RUNS) == len(rigid._EDGE_C_RUNS) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_w48_dispatch_makes_no_host_sync_on_the_card(shards):
    """The W48 demo config (bf16, both fused kernels' widths) on cuda:0,
    alone and over a mesh of ``shards`` cards (cuda:0 repeated when fewer
    are visible): after a warm batch, a dispatch under
    ``set_sync_debug_mode("error")`` raises at any host synchronisation;
    its records equal the unchecked batch's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the sync check is the card's)")
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.parallel import mesh
    visible = torch.cuda.device_count()
    cards = [torch.device("cuda", i % visible) for i in range(shards)]
    model = EgoNet(demo_config(), mesh=mesh.DataMesh(cards))
    annot = chip_smoke._frames(np)
    want = model.finalize(model.dispatch_annot_dict(annot))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = model.dispatch_annot_dict(annot)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = model.finalize(pending)
    for path, rec in want.items():
        np.testing.assert_array_equal(got[path]["euler_angles"],
                                      rec["euler_angles"])
