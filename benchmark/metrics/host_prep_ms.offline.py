"""host_prep_ms.offline: host milliseconds of the facade's ``host_prep``
span (crop matrices, packing, meta) per dispatch, the mean over the
traced dispatches.  Nothing without a traced dispatch."""


def read(record):
    ds = (record["trace"] or {}).get("dispatches") or []
    if not ds:
        return None
    return sum(d["host_prep_ms"] for d in ds) / len(ds)
