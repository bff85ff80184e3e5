"""The port's optimizer (egonet_tpu_torch/train/optim.py) against the JAX
package's optax chains, in float64 on the same seeded parameters and
gradients: the per-step learning rate, three Adam / SGD steps with and
without weight decay across a milestone, and frozen parameters, within
1e-10 (relative to the largest entry)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egonet_tpu.train import optim as jo
from egonet_tpu_torch.train import optim as to

TOL = 1e-10


def _cfg(kind, weight_decay, milestones=(1, 2), gamma=0.5, lr=0.01):
    return {"optimizer": {"optim_type": kind, "lr": lr,
                          "weight_decay": weight_decay, "momentum": 0.9,
                          "milestones": list(milestones), "gamma": gamma}}


@pytest.mark.parametrize("milestones,spe", [((10, 20, 30, 40), 7),
                                            ((50, 100, 150, 250), 1),
                                            ((2, 2, 5), 3), ((), 4)])
def test_schedule_per_step_matches_optax(milestones, spe):
    js = jo.multistep_schedule(1e-3, milestones, 0.5, spe)
    ts = to.multistep_schedule(1e-3, milestones, 0.5, spe)
    top = (max(milestones) + 2) * spe if milestones else 10
    with jax.enable_x64(True):
        want = [float(js(s)) for s in range(top)]
    got = [ts(s) for s in range(top)]
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Linear(5, 4)
        self.layer1 = torch.nn.Linear(4, 3)
        self.head = torch.nn.Linear(3, 2)


def _params(seed):
    rng = np.random.RandomState(seed)
    net = _Net().double()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape)))
    grads = [{n: rng.randn(*p.shape) * 10.0 ** rng.randint(-3, 1)
              for n, p in net.named_parameters()} for _ in range(3)]
    return net, grads


@pytest.mark.parametrize("freeze", [(), ("conv1", "head.bias")])
@pytest.mark.parametrize("kind,wd", [("adam", 0.0), ("adam", 1e-2),
                                     ("sgd", 0.0), ("sgd", 1e-2)])
def test_three_steps_match_optax(kind, wd, freeze):
    """Three steps with given gradients; the rate halves at steps 2 and 4
    (milestones 1 and 2 at 2 steps per epoch).  Frozen parameters keep
    their values exactly and get no optimizer state."""
    cfg = _cfg(kind, wd)
    net, grads = _params(7)
    start = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    with jax.enable_x64(True):
        tx, _ = jo.prepare_optim(cfg, steps_per_epoch=2)
        params = {n: jnp.asarray(v) for n, v in start.items()}
        if freeze:
            tx = jo.apply_freezing(tx, params, freeze)
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, params)
            params = {n: params[n] + upd[n] for n in params}
        want = {n: np.asarray(v) for n, v in params.items()}

    trainable = to.apply_freezing(net, freeze)
    opt, sched = to.prepare_optim(cfg, trainable, steps_per_epoch=2)
    for step, g in enumerate(grads):
        opt.zero_grad(set_to_none=True)
        for n, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[n].copy())
        to.set_lr(opt, sched(step))
        opt.step()
    for n, p in net.named_parameters():
        got = p.detach().numpy()
        if to.is_frozen(n, freeze):
            np.testing.assert_array_equal(got, start[n])
            assert p not in opt.state
        scale = float(np.abs(want[n]).max())
        assert float(np.abs(got - want[n]).max()) <= TOL * scale, n


@pytest.mark.parametrize("freeze", [(), ("conv1",), ("layer1", "head.w"),
                                    ("conv1", "layer1", "head")])
def test_freeze_mask_matches_jax(freeze):
    net, _ = _params(0)
    params = {n: np.zeros(p.shape) for n, p in net.named_parameters()}
    jmask = jo.freeze_mask(params, freeze)
    assert to.freeze_mask(net, freeze) == {n: bool(v)
                                          for n, v in jmask.items()}


def test_unknown_optimizer_raises():
    net, _ = _params(0)
    with pytest.raises(NotImplementedError):
        to.prepare_optim(_cfg("rmsprop", 0.0), net.parameters())
