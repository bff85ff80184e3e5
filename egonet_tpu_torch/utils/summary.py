"""Model summary: parameter counts and FLOPs (port of
``egonet_tpu/utils/summary.py``).

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` (2 per
multiply-add of convolutions, transposed convolutions and matrix
products) with every fused BasicBlock on its plain version: the fused
kernels are custom operators the counter cannot count, and the plain
version does the same work.  The
per-layer table is the reference's ``get_model_summary`` table
(``libs/common/utils.py:35-147``): the heatmap models run their layers
through ``F.conv2d`` / ``F.conv_transpose2d`` / ``F.linear`` on their
weights, not through the layers' ``forward``, so a row is kept for each
such call and named after the module that owns the weight.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode


def count_params(module: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


@contextlib.contextmanager
def plain_blocks(*modules):
    """Run every module with a ``fuse_blocks`` switch (the HRNet) with its
    BasicBlocks unfused for the duration."""
    found = [m for mod in modules for m in mod.modules()
             if hasattr(m, "fuse_blocks")]
    saved = [m.fuse_blocks for m in found]
    for m in found:
        m.fuse_blocks = False
    try:
        yield
    finally:
        for m, v in zip(found, saved):
            m.fuse_blocks = v


def count_flops(fn, *args, modules=(), **kwargs) -> int:
    """FLOPs of one ``fn(*args, **kwargs)`` call, with the fused blocks of
    ``modules`` on their plain version."""
    with plain_blocks(*modules), torch.inference_mode(), \
            FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def model_summary(model: torch.nn.Module, sample_input) -> dict:
    """{'params': n, 'flops': n (per forward of sample_input), 'text': str}."""
    n_params = count_params(model)
    flops = count_flops(model, sample_input, modules=(model,))
    text = (f"Total Parameters: {n_params:,}\n"
            f"Total FLOPs (per batch forward): {flops:,}")
    return {"params": n_params, "flops": flops, "text": text}


class _LayerRecorder(TorchFunctionMode):
    """One row per ``conv2d`` / ``conv_transpose2d`` / ``linear`` call: the
    module owning the weight, input and output shapes, and FLOPs (2 per
    multiply-add)."""

    def __init__(self, owners):
        super().__init__()
        self.owners = owners
        self.rows = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (F.conv2d, F.conv_transpose2d, F.linear):
            x, w = args[0], args[1] if len(args) > 1 else kwargs["weight"]
            # each output of a conv or dense layer sums w[0].numel() products
            # (C_in/groups x kh x kw); each input of a transposed conv feeds
            # w[0].numel() of them (C_out/groups x kh x kw)
            macs = (x if func is F.conv_transpose2d else out).numel() \
                * w[0].numel()
            self.rows.append({"name": self.owners.get(id(w), "?"),
                              "op": func.__name__,
                              "in": tuple(x.shape), "out": tuple(out.shape),
                              "flops": 2 * macs})
        return out


def layer_rows(model: torch.nn.Module, sample_input) -> list:
    """The per-layer rows of one plain forward, in call order; each row's
    'params' are its module's own."""
    owners, params = {}, {}
    for name, m in model.named_modules():
        w = getattr(m, "weight", None)
        if isinstance(w, torch.Tensor):
            owners[id(w)] = name
            params[name] = sum(p.numel() for p in m.parameters(recurse=False))
    # the bf16 inference copies of the conv weights (a tuple key: the
    # convs fuse_merge runs as one)
    names = {id(m): name for name, m in model.named_modules()}
    cache = getattr(model, "_inference_cache", None) or {}
    for m, w in cache.get("cast", {}).items():
        owners[id(w)] = "+".join(names[id(c)] for c in (
            m if isinstance(m, tuple) else (m,)))
    recorder = _LayerRecorder(owners)
    with plain_blocks(model), torch.inference_mode(), recorder:
        model(sample_input)
    for row in recorder.rows:
        row["params"] = params.get(row["name"], 0)
    return recorder.rows


def per_layer_summary(model: torch.nn.Module, sample_input,
                      depth: int | None = None) -> str:
    """The per-layer table: name, input and output shapes, parameters and
    FLOPs of every convolution and linear call (rows of modules nested
    deeper than ``depth`` dots are merged into their ancestor)."""
    merged = {}
    for row in layer_rows(model, sample_input):
        name = row["name"]
        if depth is not None and name != "?":
            name = ".".join(name.split(".")[:depth + 1])
        m = merged.setdefault(name, {"in": row["in"], "out": row["out"],
                                     "params": 0, "flops": 0, "seen": set()})
        m["out"] = row["out"]
        m["flops"] += row["flops"]
        if row["name"] not in m["seen"]:
            m["seen"].add(row["name"])
            m["params"] += row["params"]
    head = f"{'Name':44s} {'Input':22s} {'Output':22s} {'Params':>10s} " \
           f"{'FLOPs':>15s}"
    lines = [head, "-" * len(head)]
    for name, m in merged.items():
        lines.append(f"{name[:44]:44s} {str(list(m['in'])):22s} "
                     f"{str(list(m['out'])):22s} {m['params']:10,d} "
                     f"{m['flops']:15,d}")
    total_flops = sum(m["flops"] for m in merged.values())
    lines.append("-" * len(head))
    lines.append(f"Total Parameters: {count_params(model):,}")
    lines.append(f"Total FLOPs (conv + linear): {total_flops:,}")
    return "\n".join(lines)
