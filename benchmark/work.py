"""The work of one crop, from a configuration's published shapes alone,
and the chips' published peaks.

FLOPs count 2 per multiply-add of every convolution and dense layer (the
convention of ``torch.utils.flop_counter``), walked over the reference's
architecture (the keypoint family's ``flops``, found by
``heatmapModel.name`` in ``reference/keypoint_<name>.py``, and
``reference/egonet_ref.py``'s lifter), so they follow the model and not
the kernels that run it.  The crop warp counts as bilinear sampling:
4 taps of one multiply-add each per output value and channel.  The rigid
solve and the elementwise layers (batch norm, ReLU, sums) are left out:
together they are under 0.1% of a crop's FLOPs.

Bytes, for the keypoint model's roofline: its weights once per dispatch
in bf16, and per crop its bf16 input and its fp32 outputs (the heatmaps
and the coordinates).
"""

from __future__ import annotations

import math

from benchmark.reference import egonet_ref as ref

# Published dense peaks (NVIDIA's data sheets): bf16 tensor-core FLOP/s
# and HBM bytes/s, by the name torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
    "NVIDIA H100 PCIe": {"bf16_flops": 756e12, "hbm_bytes": 2.0e12},
}


class _FlopSpec(ref._SpecLinear):
    """The reference's walk, adding up conv and dense FLOPs (a keypoint
    family with another primitive subclasses it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def conv(self, name, x, cout, k, stride=1, pad=None, bias=False):
        y = super().conv(name, x, cout, k, stride, pad, bias)
        kh, kw = (k, k) if isinstance(k, int) else k
        self.flops += 2 * math.prod(y) * x[1] * kh * kw
        return y

    def linear(self, name, x, cout):
        y = super().linear(name, x, cout)
        self.flops += 2 * x[0] * x[1] * cout
        return y


def crop_work(cfg: dict) -> dict:
    """Per crop: 'keypoint_flops' (trunk and head), 'lifter_flops',
    'warp_flops', 'flops' (their sum); 'weight_bytes' (the keypoint
    model's weights in bf16) and 'io_bytes' (one crop's input and
    outputs)."""
    hm = cfg["heatmapModel"]
    w, h = hm["input_size"]
    keypoints = ref.keypoint_model(cfg)
    kp_flops = keypoints.flops(cfg)
    weights = sum(math.prod(s) for k, s in keypoints.shapes(cfg).items()
                  if k.endswith(".weight") and len(s) == 4)
    lift = _FlopSpec()
    ref._lifter(lift, (1, int(cfg["FCModel"]["input_size"])),
                cfg["FCModel"])
    map_w, map_h = hm["heatmap_size"]
    k = int(hm["num_joints"])
    warp = 2 * 4 * w * h * 3
    return {"keypoint_flops": kp_flops, "lifter_flops": lift.flops,
            "warp_flops": warp, "flops": kp_flops + lift.flops + warp,
            "weight_bytes": 2 * weights,
            "io_bytes": 2 * 3 * w * h + 4 * k * (map_w * map_h + 2)}


def keypoint_bound_s(cfg: dict, crops: int, peaks: dict) -> float:
    """The least time the keypoint model needs for ``crops`` crops in one
    dispatch: the larger of its FLOPs at the bf16 peak and its bytes at
    the memory bandwidth."""
    work = crop_work(cfg)
    return max(crops * work["keypoint_flops"] / peaks["bf16_flops"],
               (work["weight_bytes"] + crops * work["io_bytes"])
               / peaks["hbm_bytes"])
