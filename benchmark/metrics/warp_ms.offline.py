"""warp_ms.offline: device milliseconds of the kernels and copies that a
dispatch launched inside the facade's ``warp`` span (the crops' bilinear
sampling from the frames), the mean over the traced dispatches.
Nothing without a traced dispatch that launched work there."""


def read(record):
    ds = (record["trace"] or {}).get("dispatches") or []
    if not any("warp" in d["span_ms"] for d in ds):
        return None
    return sum(d["span_ms"].get("warp", 0.0) for d in ds) / len(ds)
