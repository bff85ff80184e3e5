"""Checkpoints the system exchanges (port of ``egonet_tpu/io/checkpoint.py``):
``HC.pth`` / ``L.pth`` as ``state_dict``s under the reference key names (the
port's modules carry them), ``LS.npy``, the layer-filtered warm start from a
pretrained ``.pth``, and the JAX package's flax ``.msgpack`` files.

The ``.msgpack`` codec is flax's (``flax.serialization.msgpack_serialize`` /
``msgpack_restore``), written here without flax: a tree of dicts with
string keys, sorted at every level (flax's tree map sorts them); each array
is msgpack ext type 1 holding the msgpack of (shape, dtype name, C-order
bytes), a numpy scalar ext type 3 the same of its 0-d array.  flax splits
an array over 2**30 bytes into chunks; no model here has one, and writing
one raises.  Only ``msgpack`` is needed, imported when a file is read or
written.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from egonet_tpu_torch.io.weights import (load_torch_state_dict,
                                         to_jax_variables)

_EXT_NDARRAY, _EXT_SCALAR = 1, 3
_MAX_LEAF_BYTES = 2 ** 30          # flax chunks larger arrays


def _msgpack():
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading or writing a flax .msgpack checkpoint "
                          "needs the 'msgpack' package") from e
    return msgpack


def _leaf_bytes(msgpack, leaf) -> bytes:
    """A numpy array or torch tensor as flax's (shape, dtype, bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else None
        leaf = (t.view(torch.int16) if name else t).numpy()
    else:
        name = None
        if leaf.dtype.hasobject or leaf.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be "
                             "written")
    if leaf.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"an array of {leaf.nbytes} bytes: flax would "
                         "chunk it, which is not written here")
    return msgpack.packb((leaf.shape, name or leaf.dtype.name,
                          leaf.tobytes("C")), use_bin_type=True)


def _sorted(tree):
    """The tree with its dict keys sorted at every level, as flax's tree
    map leaves them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree
    of dicts with numpy (or torch) array, numpy scalar and Python leaves
    (arrays of at most 2**30 bytes)."""
    msgpack = _msgpack()

    def ext(leaf):
        if isinstance(leaf, (np.ndarray, torch.Tensor)):
            return msgpack.ExtType(_EXT_NDARRAY, _leaf_bytes(msgpack, leaf))
        if isinstance(leaf, np.generic):
            return msgpack.ExtType(_EXT_SCALAR,
                                   _leaf_bytes(msgpack, np.asarray(leaf)))
        raise TypeError(f"cannot write a {type(leaf).__name__} leaf")

    return msgpack.packb(_sorted(tree), default=ext, strict_types=True)


def _leaf_from_bytes(msgpack, data: bytes):
    """flax's (shape, dtype, bytes) -> a numpy array (bfloat16: a torch
    tensor, numpy having no bfloat16)."""
    shape, name, raw = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name.decode())).reshape(shape)


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``
    (arrays read-only views of it, as flax's are)."""
    msgpack = _msgpack()

    def ext(code, payload):
        if code == _EXT_NDARRAY:
            return _leaf_from_bytes(msgpack, payload)
        if code == _EXT_SCALAR:
            return _leaf_from_bytes(msgpack, payload)[()]
        raise ValueError(f"unknown msgpack extension type {code}")

    return msgpack.unpackb(data, ext_hook=ext, raw=False)


def save_variables(path: str, state_or_tree) -> str:
    """Write a flax ``.msgpack`` the JAX package's ``load_variables``
    reads: a module or a torch ``state_dict`` goes through
    :func:`~egonet_tpu_torch.io.weights.to_jax_variables` first, a tree
    of dicts is written as it is."""
    if isinstance(state_or_tree, torch.nn.Module):
        state_or_tree = state_or_tree.state_dict()
    if state_or_tree and all(isinstance(v, torch.Tensor)
                             for v in state_or_tree.values()):
        state_or_tree = to_jax_variables(state_or_tree)
    data = msgpack_serialize(state_or_tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_variables(path: str) -> dict:
    """The tree of a flax ``.msgpack`` (``from_jax_variables`` makes the
    port's ``state_dict`` of it)."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


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
