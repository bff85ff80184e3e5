"""backbone_roofline: the keypoint model's share of its roofline.

Over the traced dispatches: the least time the trunk and head need for
each dispatch's real crops (the larger of their FLOPs at the bf16 peak
and their weight, input and output bytes at the memory bandwidth,
``benchmark/work.py``), summed, over the device time of the kernels and
copies launched inside the facade's ``backbone`` span.  Nothing without
a traced dispatch or a peak for the card."""

from benchmark import work


def read(record):
    peaks = record["peaks"]
    ds = (record["trace"] or {}).get("dispatches") or []
    busy = sum(d["backbone_ms"] for d in ds) / 1e3
    if not peaks or not ds or busy <= 0:
        return None
    bound = sum(work.keypoint_bound_s(record["config"], d["crops"], peaks)
                for d in ds)
    return 100.0 * bound / busy
