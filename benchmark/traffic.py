"""The one generator of the benchmark's traffic: it reads a traffic mix's
parameters (``benchmark/traffic/<name>.json``) and a run's seed, and makes
the frames, the boxes and the dispatch groups.

What sets the amount of work is drawn from the mix's ``shape_seed`` and
is the same for every run seed: how many boxes each frame of the working
set holds and their sizes and places.  The run seed draws the frames'
pixels and the order: which frame slot comes when, within and between
dispatch groups.  So two seeds run the same work in another order and
with other pixels.

Frames are "natural-entropy" images: 1/8-size uniform noise upsampled
bicubically (as ``tools/bench_serve.make_frames`` draws them), made on
the run's device from a ``torch.Generator``.  Boxes: objects at depth z
uniform in ``depth_m``, ``focal * height_m / z`` pixels high (clipped to
``height_px``), ``aspect_wh`` times as wide, centred on row
``center_row``, at a uniform column; boxes per frame Poisson, truncated
to [min, max] (``tools/bench_serve.make_payloads``'s cars, generalised).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Workload:
    frames: torch.Tensor        # uint8 [n, H, W, 3] on the run's device
    boxes: list                 # per frame slot: float64 [n_i, 4]
    raw_txt: list               # per frame slot: the detector's lines
    groups: list                # dispatch groups of frame slots, in order
    K: np.ndarray               # [3, 3]

    def frames_host(self) -> list:
        """The frames as host uint8 arrays (what a perception stack hands
        over), one per slot."""
        host = self.frames.cpu().numpy()
        return [host[i] for i in range(len(host))]

    def items(self, slots) -> dict:
        """{'frame', 'box', 'K'} arrays over every box of ``slots``, in
        order."""
        frame, box = [], []
        for s in slots:
            frame += [s] * len(self.boxes[s])
            box.append(self.boxes[s])
        return {"frame": np.asarray(frame, np.int64),
                "box": np.concatenate(box),
                "K": np.repeat(self.K[None], len(frame), axis=0)}


def box_sets(traffic: dict) -> list:
    """Per frame slot, the boxes [n_i, 4] (float64) drawn from
    ``shape_seed``."""
    rng = np.random.default_rng(int(traffic["shape_seed"]))
    obj = traffic["objects"]
    bpf = traffic["boxes_per_frame"]
    img_h, img_w = traffic["frame_hw"]
    focal = float(traffic["K"][0][0])
    counts = np.clip(rng.poisson(float(bpf["poisson"]),
                                 int(traffic["working_set_frames"])),
                     int(bpf["min"]), int(bpf["max"]))
    out = []
    for n in counts:
        z = rng.uniform(*obj["depth_m"], n)
        h = np.clip(focal * float(obj["height_m"]) / z, *obj["height_px"])
        w = h * rng.uniform(*obj["aspect_wh"], n)
        y1 = np.clip(float(obj["center_row"]) - h / 2, 0, img_h - 1)
        x1 = rng.uniform(0, np.maximum(img_w - w, 1), n)
        out.append(np.stack([x1, y1, np.minimum(x1 + w, img_w - 1.0),
                             np.minimum(y1 + h, img_h - 1.0)], 1))
    return out


def make_frames(n: int, hw, gen: torch.Generator, device,
                chunk: int = 16) -> torch.Tensor:
    """``n`` natural-entropy frames, uint8 [n, H, W, 3] on ``device``."""
    h, w = hw
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        low = torch.randint(0, 255, (m, 3, h // 8, w // 8), generator=gen,
                            device=device).float()
        up = F.interpolate(low, size=(h, w), mode="bicubic",
                           align_corners=False)
        out[a:a + m] = up.round().clamp(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1)
    return out


def _raw_txt(obj: dict, boxes) -> list:
    """A detector's KITTI lines for ``boxes`` (what ``post_process``
    rewrites with the refined angles)."""
    h, w, l = obj["dims_hwl"]
    return [{"class": obj["class"], "truncation": 0.0, "occlusion": 0,
             "alpha": 0.0, "bbox": [float(v) for v in b],
             "dimensions": [h, w, l], "locations": [0.0, 1.6, 20.0],
             "rot_y": 0.0, "score": 0.9} for b in boxes]


def make(traffic: dict, seed: int, device) -> Workload:
    """The workload of mix ``traffic`` for run seed ``seed``."""
    boxes = box_sets(traffic)
    n = len(boxes)
    per = int(traffic.get("frames_per_dispatch", 1))
    rng = np.random.default_rng([int(seed), 1])
    groups = [list(range(a, min(n, a + per))) for a in range(0, n, per)]
    groups = [[g[i] for i in rng.permutation(len(g))] for g in groups]
    groups = [groups[i] for i in rng.permutation(len(groups))]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    frames = make_frames(n, traffic["frame_hw"], gen, device)
    return Workload(frames, boxes, [_raw_txt(traffic["objects"], b)
                                    for b in boxes],
                    groups, np.asarray(traffic["K"], np.float64))

