"""launches_per_dispatch.offline: device kernels, copies and memsets
launched by one dispatch (from the runtime calls made inside its span
on its thread), the mean over the traced dispatches.  Nothing without
a traced dispatch."""


def read(record):
    ds = (record["trace"] or {}).get("dispatches") or []
    if not ds:
        return None
    return sum(d["launches"] for d in ds) / len(ds)
