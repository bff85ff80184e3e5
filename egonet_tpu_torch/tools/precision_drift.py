"""Measure the fp32 -> bf16 angle drift of the port's device program on the
card, through the default fused-block kernel (port of
``tools/precision_drift.py``).  Prints one JSON line.

    python -m egonet_tpu_torch.tools.precision_drift [n_instances]
"""

from __future__ import annotations

import json
import sys

import torch


def main(argv=None, device=None, cfgs=None) -> dict:
    from egonet_tpu_torch.precision import drift_harness
    from egonet_tpu_torch.device import full_precision_fp32
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    full_precision_fp32()
    stats = drift_harness(torch.float32, torch.bfloat16, n_instances=n,
                          device=device, cfgs=cfgs)
    line = {"pair": "fp32_vs_bf16", **stats}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
