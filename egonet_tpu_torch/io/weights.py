"""Weight carry-over: JAX/Flax variables and ``.pth`` / ``LS.npy`` files ->
the port's ``state_dict``s, and back (``to_jax_variables``).

The port's modules keep the reference ``state_dict`` key names, so
``from_jax_variables`` is the mechanical re-keying of
``egonet_tpu/io/torch_convert.py:flax_to_torch`` (HWIO -> OIHW, IO -> OI,
scale/bias/mean/var -> BN keys, plus ``num_batches_tracked``), and
``HC.pth`` / ``L.pth`` load natively with ``strict=True``.  The one 4-D
axis swap also carries a depthwise kernel ((3, 3, 1, C) -> [C, 1, 3, 3])
and a flax ``ConvTranspose`` kernel with ``transpose_kernel`` ((kh, kw,
out, in) -> torch's [in, out, kh, kw]); BatchNorm1d keys are a BN's.
``to_jax_variables`` is the inverse (a copy of ``torch_convert.py``'s
``torch_to_flax``): flax has no ``num_batches_tracked``, so a round trip
returns it as 0.  ``check_conversion`` lists where a converted tree's
structure or shapes differ from a model's.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(val) -> torch.Tensor:
    """A leaf as a CPU tensor of its own memory (a torch leaf, e.g. bf16,
    as it is)."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu()
    val = np.array(val, order="C")
    if val.dtype.name == "bfloat16":           # ml_dtypes' (JAX's) bf16
        return torch.from_numpy(val.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(val)


def from_jax_variables(variables: dict) -> dict:
    """{"params": ..., "batch_stats": ...} (numpy-convertible or torch
    leaves) -> a torch ``state_dict`` of CPU tensors."""
    state: dict = {}
    params = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})
    for prefix, leaves in params.items():
        for leaf, val in leaves.items():
            val = _tensor(val)
            if leaf == "kernel":
                val = val.permute((3, 2, 0, 1) if val.dim() == 4 else (1, 0))
                key = f"{prefix}.weight"
            elif leaf == "scale":
                key = f"{prefix}.weight"
            elif leaf == "bias":
                key = f"{prefix}.bias"
            else:
                raise ValueError(f"unmapped flax leaf: {prefix}/{leaf}")
            state[key] = val.contiguous()
        if prefix in batch_stats:
            for src, dst in (("mean", "running_mean"), ("var", "running_var")):
                state[f"{prefix}.{dst}"] = _tensor(
                    batch_stats[prefix][src]).contiguous()
            state[f"{prefix}.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
    return state


def to_jax_variables(state_dict: dict) -> dict:
    """A torch ``state_dict`` -> {"params": ..., "batch_stats": ...} with
    the flax layout (numpy leaves; a bf16 tensor stays a CPU torch tensor,
    numpy having no bfloat16).  A prefix with a ``running_mean`` is a batch
    norm: weight -> scale, running_mean / running_var -> batch_stats."""
    state = {k: v.detach().cpu() for k, v in state_dict.items()}
    bn = {k[:-len(".running_mean")] for k in state
          if k.endswith(".running_mean")}
    params: dict = {}
    batch_stats: dict = {}
    for key, val in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        prefix, _, leaf = key.rpartition(".")
        if prefix in bn:
            tree, name = {"weight": (params, "scale"),
                          "bias": (params, "bias"),
                          "running_mean": (batch_stats, "mean"),
                          "running_var": (batch_stats, "var")}.get(
                              leaf, (None, None))
            if tree is None:
                raise ValueError(f"unexpected bn leaf: {key}")
        elif leaf == "weight":
            if val.dim() not in (2, 4):
                raise ValueError(f"unexpected weight rank for {key}: "
                                 f"{tuple(val.shape)}")
            val = val.permute((2, 3, 1, 0) if val.dim() == 4 else (1, 0))
            tree, name = params, "kernel"
        elif leaf == "bias":
            tree, name = params, "bias"
        else:
            raise ValueError(f"unmapped torch key: {key}")
        val = val.contiguous()
        tree.setdefault(prefix, {})[name] = (
            val if val.dtype == torch.bfloat16 else val.numpy())
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def check_conversion(variables: dict, converted: dict) -> list:
    """Compare the tree structure and leaf shapes of ``converted`` (a
    converted checkpoint, nested dicts) against ``variables`` (a freshly
    initialised model's); returns the mismatches as strings, in the JAX
    package's words and order (``torch_convert.check_conversion``), empty
    when everything matches."""
    problems = []

    def walk(a, b, path):
        if isinstance(a, dict) != isinstance(b, dict):
            problems.append(f"{path}: structure mismatch")
            return
        if isinstance(a, dict):
            for k in a:
                if k not in b:
                    problems.append(f"{path}/{k}: missing in checkpoint")
                else:
                    walk(a[k], b[k], f"{path}/{k}")
            for k in b:
                if k not in a:
                    problems.append(f"{path}/{k}: unexpected in checkpoint")
        else:
            # tuples, so that a tensor's torch.Size prints as numpy's shape
            sa, sb = tuple(np.shape(a)), tuple(np.shape(b))
            if sa != sb:
                problems.append(f"{path}: shape {sb} != expected {sa}")

    walk(variables, converted, "")
    return problems


def load_torch_state_dict(path: str) -> dict:
    """Load a .pth state_dict (tensors on the CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return dict(state)


def load_lifter_stats(path: str) -> dict:
    """Load LS.npy: {'mean_in','std_in','mean_out','std_out'} float32."""
    stats = np.load(path, allow_pickle=True).item()
    return {k: np.asarray(v, dtype=np.float32) for k, v in stats.items()}


@torch.no_grad()
def bn_affine_tensors(gamma, beta, mean, var, eps: float):
    """An inference-mode batch norm as a per-channel affine, in fp32 on the
    tensors' device: (scale = gamma / sqrt(var + eps), shift = beta - mean
    * scale), each [C] contiguous: the operands of ``ops/bn_act.py`` and
    the fold of :func:`fold_conv_bn_tensors`; here so that an exported
    program binds a checkpoint without the kernels' modules."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    return scale.contiguous(), (beta.float() - mean.float() * scale).contiguous()


@torch.no_grad()
def fold_conv_bn_tensors(weight, gamma, beta, mean, var, eps: float):
    """Fold an inference-mode batch norm into the bias-free OIHW conv before
    it, in fp32 on the tensors' device: a ``state_dict``'s conv ``weight``
    and the batch norm's ``weight``, ``bias``, ``running_mean`` and
    ``running_var``.  Returns (w [C_out, 3, 3, C_in] bf16, b [C] fp32) in
    the fused BasicBlock kernels' layout (``ops/fused_block.py``): the
    weight scaled by :func:`bn_affine_tensors`' scale, its shift the
    bias."""
    inv, b = bn_affine_tensors(gamma, beta, mean, var, eps)
    w = weight.float() * inv[:, None, None, None]
    return w.permute(0, 2, 3, 1).contiguous().to(torch.bfloat16), b
