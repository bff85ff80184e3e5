"""Locating / rebuilding the native C++ KITTI evaluator (copy of
``egonet_tpu/eval/native.py``, pointing at the same ``tools/kitti-eval/``).

The binary is a build artifact (not committed): :func:`ensure_evaluator`
runs ``make``, which rebuilds it whenever ``kitti_eval.cpp`` is newer, so a
stale binary never scores a submission.
"""

import os
import subprocess

EVAL_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "tools",
                 "kitti-eval"))
BINARY = os.path.join(EVAL_DIR, "evaluate_object_3d_offline")


def ensure_evaluator(quiet: bool = True):
    """The path of an up-to-date evaluator binary, or None when it cannot
    be built (no toolchain) and none exists."""
    try:
        subprocess.check_call(
            ["make", "-C", EVAL_DIR],
            stdout=subprocess.DEVNULL if quiet else None,
            stderr=subprocess.DEVNULL if quiet else None)
    except (OSError, subprocess.CalledProcessError):
        pass
    return BINARY if os.path.exists(BINARY) else None
