"""Optimizer construction (port of ``egonet_tpu/train/optim.py``): Adam or
SGD with momentum, a multi-step learning rate reckoned per step, and
prefix-based parameter freezing.

The schedule equals the JAX package's optax schedule: the rate is
``base_lr * gamma**k`` from step ``k``-th milestone x steps_per_epoch on
(step counted from 0, before its update).  Adam folds weight decay into
the gradient before the moments (``torch.optim.Adam``'s ``weight_decay``,
not AdamW), as optax's ``add_decayed_weights`` + ``adam`` does; SGD uses
momentum without dampening.  A frozen parameter gets
``requires_grad=False``: no gradient, no update, no moments and no weight
decay, as ``optax.masked`` gives.
"""

from __future__ import annotations

import torch


def multistep_schedule(base_lr: float, milestones, gamma: float,
                       steps_per_epoch: int):
    """MultiStepLR per step: lr *= gamma at each milestone epoch (a
    boundary repeated in ``milestones`` counts once, as a dict key does in
    optax)."""
    boundaries = sorted({int(m) * int(steps_per_epoch) for m in milestones})
    base_lr, gamma = float(base_lr), float(gamma)

    def schedule(step: int) -> float:
        lr = base_lr
        for b in boundaries:
            if step >= b:
                lr = lr * gamma
        return lr
    return schedule


def is_frozen(name: str, freeze_names) -> bool:
    return any(name.startswith(prefix) for prefix in freeze_names)


def freeze_mask(model: torch.nn.Module, freeze_names) -> dict:
    """{parameter name: trainable}.  The modules' names are the reference
    ``state_dict`` prefixes, so reference freeze lists apply directly."""
    return {name: not is_frozen(name, freeze_names)
            for name, _ in model.named_parameters()}


def apply_freezing(model: torch.nn.Module, freeze_names) -> list:
    """Set ``requires_grad=False`` on the frozen parameters; returns the
    trainable ones."""
    mask = freeze_mask(model, freeze_names or ())
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    return trainable


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def prepare_optim(cfgs: dict, params, steps_per_epoch: int = 1):
    """(optimizer over ``params``, schedule) from the reference config
    schema.  Call ``set_lr(optimizer, schedule(step))`` before each
    step."""
    opt_cfg = cfgs["optimizer"]
    schedule = multistep_schedule(
        float(opt_cfg["lr"]), opt_cfg.get("milestones", []),
        float(opt_cfg.get("gamma", 0.1)), steps_per_epoch)
    weight_decay = float(opt_cfg.get("weight_decay", 0.0))
    kind = opt_cfg.get("optim_type", "adam")
    params = list(params)
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=weight_decay)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=schedule(0),
                              momentum=float(opt_cfg.get("momentum", 0.9)),
                              dampening=0.0, weight_decay=weight_decay)
    else:
        raise NotImplementedError(kind)
    return opt, schedule
