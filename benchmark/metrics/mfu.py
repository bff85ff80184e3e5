"""mfu: the whole step's share of the card's bf16 peak in the window.

The FLOPs of every real crop completed in the window (warp, keypoint
model, lifter: ``benchmark/work.py``, from the configuration's shapes)
over the window's seconds and the published dense bf16 peak of the card
the run used.  Nothing where the card has no entry in the peaks table or
no crop completed."""


def read(record):
    peaks = record["peaks"]
    if not peaks or not record["crops"]:
        return None
    flops = record["crops"] * record["work"]["flops"]
    return 100.0 * flops / record["window_s"] / peaks["bf16_flops"]
