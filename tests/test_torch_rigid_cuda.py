"""The rigid stage's CUDA kernel (``egonet::rigid_solve``,
csrc/rigid_solve.cu), marked ``cuda``: it skips without a card.  Against
the CPU kernel (the same routine of csrc/rigid_solve.cuh) at the bucket
sizes the facade runs and odd ones, one launch a call, and one launch per
shard of a facade dispatch.  No JAX here: the CPU kernel is the yardstick
(tests/test_torch_rigid.py holds it to the JAX package)."""

import numpy as np
import pytest
import torch

from egonet_tpu_torch.data import cuboid
from egonet_tpu_torch.ops.rigid_solve import rigid_solve


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _kpts(n, points, seed):
    """``n`` noisy rotated car cuboids [n, 32, 3], with a camera-frame root
    before them when ``points`` is 33."""
    rng = np.random.RandomState(seed)
    preds = []
    for _ in range(n):
        box = cuboid.construct_box_3d(3.9 + 0.2 * rng.randn(), 1.5, 1.7)
        rot = cuboid.rot_y_matrix(float(rng.uniform(-np.pi, np.pi)))
        preds.append((rot @ (box[:, 1:] - box[:, :1])).T
                     + 0.02 * rng.randn(32, 3))
    preds = np.stack(preds)
    if points == 33:
        root = rng.uniform([-20, -1, 2], [20, 2, 60], (n, 1, 3))
        preds = np.concatenate([root, preds], axis=1)
    return torch.from_numpy(preds.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("points", [32, 33])
@pytest.mark.parametrize("n", [1, 8, 384, 512, 513])
def test_cuda_kernel_matches_cpu_kernel(n, points):
    """One launch a call, angles within 1e-5 rad of the CPU kernel (the
    same routine; the card contracts multiply-adds), translations equal."""
    _needs_card()
    kpts = _kpts(n, points, seed=n + points)
    want = rigid_solve(kpts)
    before = rigid_solve.launches
    got = rigid_solve(kpts.cuda())
    torch.cuda.synchronize()
    assert rigid_solve.launches == before + 1
    assert got.shape == (n, 6) and got.is_cuda
    got = got.cpu()
    assert (got[:, :3] - want[:, :3]).abs().max().item() < 1e-5
    assert torch.equal(got[:, 3:], want[:, 3:])


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_facade_dispatch_is_one_rigid_launch_per_shard(shards):
    """A dispatch of the W48 facade, alone and over a mesh of two shards
    on cuda:0, launches the rigid kernel once per shard."""
    _needs_card()
    import chip_smoke
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.models.egonet import EgoNet
    from egonet_tpu_torch.parallel import mesh
    model = EgoNet(demo_config(), mesh=mesh.DataMesh(["cuda:0"] * shards))
    annot = chip_smoke._frames(np, n_frames=2, n_boxes=5)
    model.finalize(model.dispatch_annot_dict(annot))
    rigid_solve.launches = 0
    records = model.finalize(model.dispatch_annot_dict(annot))
    assert rigid_solve.launches == shards
    assert all(np.isfinite(r["euler_angles"]).all() for r in records.values())
