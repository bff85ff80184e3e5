"""The IGR train step at full W48 width (shipped KITTI_train_IGRs config:
48/96/192/384, 256x256 crops, 64x64 heatmaps, 'coordinates' head) held
against the JAX package's fp32 step in tests/data/torch_train_fixture.npz:
2 crops of the precision harness's frame, JAX's initial weights for seed
0, the JAX ``_loss_fn`` run eagerly (its jitted CPU warp rounds a few
pixels differently), cross-ratio off.  The fixture records the loss and
its components, the gradient norm of each top-level stage and the updated
running statistics of six BN layers (``precision.train_step_outputs``),
and the same quantities from the port's fp64 step, the yardstick of fp32
rounding.

Bars (relative, ``precision.train_gaps``), set from that yardstick: each
fp32 side lies within ROUNDING of fp64, so the port's fp32 step is held
to the JAX fp32 step at 2 x ROUNDING.  A planted fault (two conv1 output
channels swapped in one C=192 block, or a BN momentum of 0.2 for 0.1)
fails them.

Regenerate (JAX eager full-width backward on the CPU, several minutes):
    JAX_PLATFORMS=cpu python -m tests.test_torch_train_fixture
"""

import os

import numpy as np
import pytest
import torch

from egonet_tpu_torch import config as tcfg
from egonet_tpu_torch import precision

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_train_fixture.npz")
SEED = 0
N_CROPS = 2
STATS = [f"{n}.{s}" for n in precision.TRAIN_BN
         for s in ("running_mean", "running_var")]
SCALARS = ("loss", "hm", "coor")
# fp32 against fp64, either package.  Observed (CPU): JAX 2.5e-6 / 2.5e-6 /
# 4.3e-6 / 2.4e-3 / 2.5e-5 and the port 1.6e-7 / 2.0e-7 / 2.1e-6 / 4.4e-4 /
# 1.9e-5 (loss / hm / coor / grad norms / BN stats); the port against JAX
# 2.6e-6 / 2.7e-6 / 6.4e-6 / 2.8e-3 / 4.1e-5.  The gradient norms of the
# stem (bn2: 2.4e-3) are the least well conditioned.
ROUNDING = {"loss": 5e-6, "hm": 5e-6, "coor": 1e-5, "grad_norms": 5e-3,
            "bn_stats": 5e-5}
BARS = {k: 2 * v for k, v in ROUNDING.items()}
FAULT_BLOCK = "stage3.0.branches.2.0"


def _load(prefix=""):
    with np.load(FIXTURE) as f:
        out = {k: f[prefix + k] for k in (*SCALARS, "grad_norms", *STATS)}
    for k in SCALARS:
        out[k] = float(out[k])
    return out


def port_outputs(dtype, fault=None):
    """The port's step on the CPU at full width."""
    from egonet_tpu_torch.train.igrs import IGRTrainer
    cfg = tcfg.train_igrs_config()
    trainer = IGRTrainer(cfg, dtype=dtype, device="cpu")
    state = trainer.init_state(SEED)
    if fault is not None:
        FAULTS[fault](state.model)
    return precision.train_step_outputs(
        trainer, state, precision.train_fixture_batch(cfg, N_CROPS, SEED))


def _swap_channels(model):
    w = model.get_submodule(FAULT_BLOCK).conv1.weight
    with torch.no_grad():
        w[[0, 1]] = w[[1, 0]].clone()


def _momentum(model):
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.2


FAULTS = {"swap_c192_channels": _swap_channels, "bn_momentum": _momentum}


@pytest.fixture(scope="module")
def port_fp32():
    torch.set_num_threads(4)
    return port_outputs(torch.float32)


def test_fixture_holds_both_steps():
    assert os.path.getsize(FIXTURE) < 64 * 1024
    jax32, f64 = _load(), _load("f64/")
    gaps = precision.train_gaps(jax32, f64)
    print(f"JAX fp32 against fp64: {gaps}")
    for k, v in gaps.items():
        assert v <= ROUNDING[k], (k, v)
    assert len(jax32["grad_norms"]) == len(precision.TRAIN_STAGES)
    assert (jax32["grad_norms"] > 0).all()


def test_fp32_step_matches_the_jax_fixture(port_fp32):
    gaps = precision.train_gaps(port_fp32, _load())
    print(f"port fp32 against JAX fp32: {gaps}")
    for k, v in gaps.items():
        assert v <= BARS[k], (k, v)
    rounding = precision.train_gaps(port_fp32, _load("f64/"))
    print(f"port fp32 against fp64: {rounding}")
    for k, v in rounding.items():
        assert v <= ROUNDING[k], (k, v)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_bars(fault):
    torch.set_num_threads(4)
    gaps = precision.train_gaps(port_outputs(torch.float32, fault), _load())
    print(f"{fault}: {gaps}")
    assert any(v > BARS[k] for k, v in gaps.items()), gaps


def _jax_outputs(cfg, batch):
    """The JAX package's fp32 step, run eagerly."""
    import jax
    import jax.numpy as jnp
    from egonet_tpu.io import torch_convert as tc
    from egonet_tpu.models.initialization import numpy_init
    from egonet_tpu.train.igrs import IGRTrainer
    jt = IGRTrainer(cfg)
    w, h = cfg["heatmapModel"]["input_size"]
    var = numpy_init(jt.model, SEED, jnp.zeros((1, h, w, 3)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.disable_jit():
        (loss, (bs, comps)), grads = jax.value_and_grad(
            jt._loss_fn, has_aux=True)(var["params"], var["batch_stats"],
                                       jb, False)
    sq = dict.fromkeys(precision.TRAIN_STAGES, 0.0)
    for k, v in tc.flax_to_torch({"params": grads}).items():
        sq[k.split(".")[0]] += float(np.square(np.asarray(v, np.float64))
                                     .sum())
    out = {"loss": float(loss), **{k: float(v) for k, v in comps.items()},
           "grad_norms": np.sqrt([sq[s] for s in precision.TRAIN_STAGES])}
    for name in precision.TRAIN_BN:
        out[f"{name}.running_mean"] = np.asarray(bs[name]["mean"])
        out[f"{name}.running_var"] = np.asarray(bs[name]["var"])
    return out


def generate(path=FIXTURE):
    cfg = tcfg.train_igrs_config()
    batch = precision.train_fixture_batch(cfg, N_CROPS, SEED)
    jax32 = _jax_outputs(cfg, batch)
    f64 = port_outputs(torch.float64)
    arrays = {}
    for prefix, out in (("", jax32), ("f64/", f64)):
        for k in (*SCALARS, "grad_norms", *STATS):
            arrays[prefix + k] = np.asarray(
                out[k], np.float64 if prefix else np.float32)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {precision.train_gaps(jax32, f64)}")


@pytest.mark.slow
def test_regenerated_fixture_equals_the_committed_one(tmp_path):
    path = str(tmp_path / "fixture.npz")
    generate(path)
    with np.load(path) as new, np.load(FIXTURE) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            np.testing.assert_allclose(new[k], old[k], rtol=1e-6, atol=0)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    generate()
