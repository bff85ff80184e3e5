"""Device resolution for the port's entry points.

The port is written for the GPU: ``None`` means CUDA, and a missing CUDA
device is an error, never a silent CPU fallback.  The CPU runs only when a
caller asks for it by name (the tests do, on machines without a card).
"""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` / ``"cuda"`` -> the current CUDA device (raises without one);
    ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "egonet_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_precision_fp32():
    """Keep fp32 matmuls and convolutions at full fp32 on the card.

    The JAX package runs its geometry and fp32 paths at
    ``Precision.HIGHEST``; cuDNN's default TF32 convolutions (and TF32
    matmuls, where enabled) would silently keep about 3 digits instead."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def deterministic(on: bool = True):
    """Inside: ``torch.use_deterministic_algorithms`` (warning, not
    raising, at an op that has no deterministic form) with cuBLAS's fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG``, unless the caller set it).
    Exact resume needs it on the card: cuDNN's default backward
    algorithms may accumulate with atomics, so two runs of one step can
    differ in the last bit.  Both settings are put back on leaving;
    ``on=False`` changes nothing."""
    if not on:
        yield
        return
    saved_mode = torch.are_deterministic_algorithms_enabled()
    saved_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved_mode, warn_only=saved_warn)
        if saved_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
