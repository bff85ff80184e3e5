"""idle_share.offline: the share of the traced window in which no
kernel, copy or memset ran on the card.  Nothing without a trace."""


def read(record):
    tr = record["trace"] or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
