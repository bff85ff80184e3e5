"""Weight carry-over: JAX/Flax variables and ``.pth`` / ``LS.npy`` files ->
the port's ``state_dict``s.

The port's modules keep the reference ``state_dict`` key names, so
``from_jax_variables`` is the mechanical re-keying of
``egonet_tpu/io/torch_convert.py:flax_to_torch`` (HWIO -> OIHW, IO -> OI,
scale/bias/mean/var -> BN keys, plus ``num_batches_tracked``), and
``HC.pth`` / ``L.pth`` load natively with ``strict=True``.  The one 4-D
axis swap also carries a depthwise kernel ((3, 3, 1, C) -> [C, 1, 3, 3])
and a flax ``ConvTranspose`` kernel with ``transpose_kernel`` ((kh, kw,
out, in) -> torch's [in, out, kh, kw]); BatchNorm1d keys are a BN's.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_variables(variables: dict) -> dict:
    """{"params": ..., "batch_stats": ...} (numpy-convertible leaves) ->
    a torch ``state_dict`` of CPU tensors."""
    state: dict = {}
    params = variables.get("params", {})
    batch_stats = variables.get("batch_stats", {})
    for prefix, leaves in params.items():
        for leaf, val in leaves.items():
            val = np.asarray(val)
            if leaf == "kernel":
                val = (np.transpose(val, (3, 2, 0, 1)) if val.ndim == 4
                       else np.transpose(val, (1, 0)))
                key = f"{prefix}.weight"
            elif leaf == "scale":
                key = f"{prefix}.weight"
            elif leaf == "bias":
                key = f"{prefix}.bias"
            else:
                raise ValueError(f"unmapped flax leaf: {prefix}/{leaf}")
            state[key] = torch.from_numpy(np.array(val, order="C"))
        if prefix in batch_stats:
            for src, dst in (("mean", "running_mean"), ("var", "running_var")):
                state[f"{prefix}.{dst}"] = torch.from_numpy(
                    np.array(batch_stats[prefix][src], order="C"))
            state[f"{prefix}.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
    return state


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
