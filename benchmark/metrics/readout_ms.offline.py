"""readout_ms.offline: device milliseconds of the kernels and copies that a
dispatch launched inside the facade's ``readout`` span (a 'heatmap'
head's maps to keypoints: the soft-argmax), the mean over the traced
dispatches.  Nothing without a traced dispatch that launched work there
(a 'coordinates' head, or a program without the span)."""


def read(record):
    ds = (record["trace"] or {}).get("dispatches") or []
    if not any("readout" in d["span_ms"] for d in ds):
        return None
    return sum(d["span_ms"].get("readout", 0.0) for d in ds) / len(ds)
