"""Ahead-of-time export of the fused inference program (``torch.export``).
Port of ``egonet_tpu/io/export.py``.

Deployment complement to the serving layer: the fused pipeline runs a
small, enumerable set of shapes (the instance buckets x one canvas), so
the whole set is traced once, at build time, into one ``torch.export``
program per bucket (a ``.pt2`` file) plus ``manifest.json``.  A serving
host loads them and runs the graph without tracing the model's Python.

Artifacts are weight-agnostic, as the JAX package's are: the graph takes
every tensor a checkpoint determines as an input — the HRNet and lifter
parameters and batch-norm statistics (``HC.pth`` / ``L.pth`` key names),
the lifter statistics (``LS.npy``) and the bf16 inference weights derived
from them (each conv weight cast once, each fused block's batch norm
folded; ``models/layers.CachedInference``).  The ``.pt2`` files hold the
graph only (their state is saved on the meta device); :func:`bind` lays a
checkpoint into a loaded program, deriving the inference weights by the
recipes the manifest lists, so one artifact serves every checkpoint of the
architecture.

The program is ``EgoNet._core`` in canvas mode, ``(images [n_img, H, W, 3]
uint8, meta [bucket, META_COLS] f32)``; each instance's frame index is read
from meta's column 8 on the device (as the JAX artifact reads it), so the
graph holds no request's indices.  Both fused BasicBlock kernels are
custom ops (``egonet::fused_basic_block``, ``egonet::fused_basic_block_
stencil``, registered by importing ``egonet_tpu_torch.ops``, which this
module does before ``torch.export.load``): each fusable HRNet block is one
node of the graph, and the program exported on the card launches the
kernel there.  AOTInductor is not used (it would need the kernels as C++
ops).
"""

from __future__ import annotations

import copy
import io
import json
import logging
import os

import numpy as np
import torch
import torch.nn as nn

import egonet_tpu_torch.ops  # noqa: F401  (registers both custom ops)
from egonet_tpu_torch.ops.fused_block import fold_conv_bn_tensors

LS_KEYS = ("mean_in", "std_in", "mean_out", "std_out")
FUSED_OPS = ("egonet.fused_basic_block", "egonet.fused_basic_block_stencil")


class ExportCore(nn.Module):
    """``EgoNet._core`` (canvas mode) of ``model`` as a module whose
    parameters and buffers are everything a checkpoint determines: the
    HRNet (``hrnet.*``), the lifter (``lifter.*``), the LS statistics
    (``ls.*``) and the inference weights the HRNet's cache derives from
    them (``derived.*``).  ``recipes`` says how each derived buffer is
    computed from the HRNet's state."""

    def __init__(self, model, alpha_mode: str = "proj"):
        super().__init__()
        self.alpha_mode = alpha_mode
        self.hrnet = model.hrnet
        self.lifter = model.lifter
        # a facade of its own: forward swaps its LS statistics
        object.__setattr__(self, "_facade", copy.copy(model))
        self.ls = nn.Module()
        for k in LS_KEYS:
            self.ls.register_buffer(k, model.ls_stats[k])
        self.derived = nn.Module()
        cache = model.hrnet.inference_cache()
        names = {m: n for n, m in model.hrnet.named_modules()}
        self._stencil = bool(cache["stencil"])
        self._cast, self._folded, self.recipes = [], [], []
        for i, (key, w) in enumerate(cache["cast"].items()):
            buf = f"cast_{i}"
            self.derived.register_buffer(buf, w)
            self._cast.append((key, buf))
            mods = key if isinstance(key, tuple) else (key,)
            self.recipes.append({"cast": [names[m] + ".weight" for m in mods],
                                 "into": ["derived." + buf]})
        for i, (blk, tensors) in enumerate(cache["folded"].items()):
            bufs = [f"fold_{i}_{t}" for t in ("w1", "b1", "w2", "b2")]
            for buf, t in zip(bufs, tensors):
                self.derived.register_buffer(buf, t)
            self._folded.append((blk, bufs))
            self.recipes.append({"fold": names[blk],
                                 "eps": [blk.bn1.eps, blk.bn2.eps],
                                 "into": ["derived." + b for b in bufs]})

    def forward(self, images, meta):
        d = self.derived
        cache = {"cast": {k: getattr(d, b) for k, b in self._cast},
                 "folded": {blk: tuple(getattr(d, b) for b in bufs)
                            for blk, bufs in self._folded},
                 "stencil": self._stencil}
        saved = self.hrnet._inference_cache
        self.hrnet._inference_cache = cache
        self._facade.ls_stats = {k: getattr(self.ls, k) for k in LS_KEYS}
        try:
            return self._facade._core(images, meta,
                                      alpha_mode=self.alpha_mode)
        finally:
            self.hrnet._inference_cache = saved


def example_inputs(model, bucket: int, n_img: int = 16,
                   canvas_hw=(384, 1280)):
    """(images, meta) of the program's shapes on the model's device: blank
    canvases and identity-affine rows (the values do not shape the
    graph)."""
    from egonet_tpu_torch.models.egonet import META_COLS
    images = torch.zeros((n_img,) + tuple(canvas_hw) + (3,), dtype=torch.uint8,
                         device=model.device)
    meta = torch.zeros((bucket, META_COLS), dtype=torch.float32,
                       device=model.device)
    meta[:, 0:6] = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    meta[:, 9:14] = 1.0
    return images, meta


def export_program(model, bucket: int, n_img: int = 16,
                   canvas_hw=(384, 1280), alpha_mode: str = "proj"):
    """(``torch.export.ExportedProgram`` of the canvas-mode program for one
    instance bucket, with the model's weights, and the :class:`ExportCore`
    it traced)."""
    core = ExportCore(model, alpha_mode).eval()
    with torch.no_grad():
        program = torch.export.export(
            core, example_inputs(model, bucket, n_img, canvas_hw),
            strict=False)
    return program, core


def export_bucket(model, bucket: int, n_img: int = 16,
                  canvas_hw=(384, 1280), alpha_mode: str = "proj") -> bytes:
    """Serialize the canvas-mode program for one instance bucket: the
    ``.pt2`` bytes of its graph for ``[n_img, *canvas_hw, 3] u8`` canvases
    and a ``[bucket, META_COLS] f32`` meta array, without weights."""
    program, _ = export_program(model, bucket, n_img, canvas_hw, alpha_mode)
    return _weightless_bytes(program)


def _weightless_bytes(program) -> bytes:
    """The program saved with its state (parameters and persistent
    buffers) on the meta device and without its example inputs: no weight
    or frame bytes in the artifact."""
    program = copy.copy(program)
    program._example_inputs = None
    program._state_dict = {
        k: (nn.Parameter(v.detach().to("meta"), requires_grad=False)
            if isinstance(v, nn.Parameter) else v.detach().to("meta"))
        for k, v in program.state_dict.items()}
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def fused_nodes(program) -> int:
    """How many nodes of the program's graph call a fused-block op."""
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and any(
                   str(n.target).startswith(op) for op in FUSED_OPS))


def export_shape_set(model, out_dir: str, buckets=(8, 16, 32, 64, 128),
                     n_img: int = 16, canvas_hw=(384, 1280),
                     alpha_mode: str = "proj") -> dict:
    """Export every bucket program + a manifest; returns the manifest."""
    from egonet_tpu_torch.models.egonet import META_COLS
    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "format": "torch.export/pt2",
        "alpha_mode": alpha_mode,
        "canvas_hw": list(canvas_hw),
        "n_img": n_img,
        "device": model.device.type,
        "dtype": str(model.dtype).replace("torch.", ""),
        "call_args": "(images, meta) after bind(program, manifest, "
                     "hrnet_state, lifter_state, ls_stats)",
        "meta_cols": META_COLS,
        "artifacts": {},
    }
    for b in buckets:
        program, core = export_program(model, b, n_img, canvas_hw,
                                       alpha_mode)
        blob = _weightless_bytes(program)
        name = f"egonet_core_b{b}.pt2"
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(blob)
        manifest["artifacts"][str(b)] = {"file": name, "bytes": len(blob),
                                         "fused_nodes": fused_nodes(program)}
        manifest["derived"] = core.recipes
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_exported(out_dir: str):
    """Deserialize an exported shape set -> ({bucket: ExportedProgram
    without weights}, manifest); :func:`bind` makes one runnable."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    programs = {}
    # the state saved on the meta device has no bytes: the loader warns
    # for each such tensor and fills zeros, which bind() replaces
    log = logging.getLogger("torch.export.pt2_archive._package")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        for bucket, entry in manifest["artifacts"].items():
            programs[int(bucket)] = torch.export.load(
                os.path.join(out_dir, entry["file"]))
    finally:
        log.setLevel(level)
    return programs, manifest


def weights_for(manifest: dict, hrnet_state: dict, lifter_state: dict,
                ls_stats: dict, device="cpu") -> dict:
    """The program's full state from a checkpoint: ``hrnet.*`` from
    ``hrnet_state`` (HC.pth keys), ``lifter.*`` from ``lifter_state``
    (L.pth), ``ls.*`` from ``ls_stats`` (LS.npy) and ``derived.*`` by the
    manifest's recipes (the conv weights cast to bf16 ``channels_last``,
    concatenated for a ``fuse_merge`` group; the fused blocks' batch norms
    folded), on ``device``."""
    hs = {k: torch.as_tensor(v).to(device) for k, v in hrnet_state.items()}
    state = {"hrnet." + k: v for k, v in hs.items()}
    state.update({"lifter." + k: torch.as_tensor(v).to(device)
                  for k, v in lifter_state.items()})
    state.update({"ls." + k: torch.as_tensor(np.asarray(ls_stats[k],
                                                        np.float32),
                                             device=device)
                  for k in LS_KEYS})
    with torch.no_grad():
        for r in manifest.get("derived", []):
            if "cast" in r:
                ws = [hs[k].to(torch.bfloat16,
                               memory_format=torch.channels_last)
                      for k in r["cast"]]
                w = ws[0] if len(ws) == 1 else torch.cat(ws).contiguous(
                    memory_format=torch.channels_last)
                state[r["into"][0]] = w
            else:
                blk = r["fold"]
                out = []
                for i, eps in zip((1, 2), r["eps"]):
                    bn = f"{blk}.bn{i}."
                    out += fold_conv_bn_tensors(
                        hs[f"{blk}.conv{i}.weight"], hs[bn + "weight"],
                        hs[bn + "bias"], hs[bn + "running_mean"],
                        hs[bn + "running_var"], eps)
                state.update(zip(r["into"], out))
    return state


def bind(program, manifest: dict, hrnet_state: dict, lifter_state: dict,
         ls_stats: dict, device=None) -> nn.Module:
    """A loaded program with a checkpoint's weights laid in: a module
    called as ``(images, meta) -> flat [bucket, D] f32``, on the device the
    program was exported for unless ``device`` says otherwise."""
    device = device or manifest["device"]
    module = program.module()
    module.load_state_dict(weights_for(manifest, hrnet_state, lifter_state,
                                       ls_stats, device),
                           strict=True, assign=True)
    return module
