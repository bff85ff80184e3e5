"""Checkpoints the system exchanges (port of the torch half of
``egonet_tpu/io/checkpoint.py``): ``HC.pth`` / ``L.pth`` as ``state_dict``s
under the reference key names (the port's modules carry them), ``LS.npy``,
and the layer-filtered warm start from a pretrained ``.pth``.

The JAX package's native flax ``.msgpack`` files are not written here
(queued in ROADMAP).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from egonet_tpu_torch.io.weights import load_torch_state_dict


def save_torch_state_dict(path: str, model_or_state) -> str:
    """Write a module's (or a ``state_dict``'s) tensors, on the CPU, as a
    ``.pth`` the reference implementation and the JAX package load."""
    state = (model_or_state.state_dict()
             if isinstance(model_or_state, torch.nn.Module)
             else model_or_state)
    state = {k: v.detach().cpu().clone() for k, v in state.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(state, path)
    return path


def save_lifter_stats(path: str, statistics: dict) -> str:
    """Save LS.npy-compatible normalization statistics."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, {k: np.asarray(v) for k, v in statistics.items()})
    return path


def warm_start_variables(cfgs: dict, model: torch.nn.Module, logger=None):
    """Layer-filtered warm start from ``heatmapModel.pretrained``: the
    pretrained ``state_dict`` keeps the keys whose first name is in
    ``extra.pretrained_layers`` (all for ``['*']``) and is laid over
    ``model``'s own state.  Returns the full ``state_dict``, or None when
    ``pretrained`` is unset or ``init_weights`` is false; a set path that
    does not exist raises.

    The keys left out keep ``model``'s values (the port's seeded NumPy
    initialization); the JAX package takes those from flax's own
    initializers, which the port does not reproduce."""
    hm = cfgs["heatmapModel"]
    pretrained = hm.get("pretrained")
    if not (hm.get("init_weights") and pretrained):
        return None
    if not os.path.exists(pretrained):
        raise ValueError(
            f"heatmapModel.pretrained is set but does not exist: "
            f"{pretrained!r}")
    if logger is not None:
        logger.info(f"loading pretrained start point {pretrained}")
    sd = load_torch_state_dict(pretrained)
    allowed = hm["extra"].get("pretrained_layers", ["*"])
    if allowed and allowed[0] != "*":
        sd = {k: v for k, v in sd.items() if k.split(".")[0] in allowed}
    base = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return merge_partial(base, sd)


def merge_partial(base: dict, partial: dict) -> dict:
    """Overlay a (possibly partial) checkpoint onto initialized state:
    keys present in ``partial`` override ``base`` (nested dicts merge);
    missing keys keep their initialization."""
    out = dict(base)
    for k, v in partial.items():
        out[k] = (merge_partial(out.get(k) or {}, v)
                  if isinstance(v, dict) else v)
    return out
