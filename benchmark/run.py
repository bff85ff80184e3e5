"""The benchmark of the PyTorch / CUDA port (``egonet_tpu_torch``).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Everything is found by name from ``BENCHMARK.json``: the cell in
``workloads``, its configuration in ``benchmark/configs/<config>.json``
(whose ``heatmapModel.name`` names the keypoint family: its reference,
seeded weights, FLOPs and CPU cut in
``benchmark/reference/keypoint_<name>.py``), its traffic mix in
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the driver,
``benchmark/<kind>.py``), and each per-layer metric's reader in
``benchmark/metrics/<name>.py``.  A new cell, configuration, keypoint
family, mix or metric is new files and new entries there.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the comparison with
the plain reference read, beside its limit.  Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits with another code
than 0.

``--control``, which the benchmark's checks never pass, runs the
program's int8 activation path: the comparison's control.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "egonet_tpu")


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own libraries into egonet_tpu_torch/_build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, ".bench_cache", sub)


# The run's process, set before torch loads: one intra-op thread, so that
# no pool of spinning threads competes with the facade's two host threads
# for the machine's shared cores; and CUDA's launch queues at four times
# their size (about 4,250 launches before a launch blocks, against about
# 1,250), so that the work the facade dispatches ahead of the card
# (``stream_depth``) fits in the queue and a pause of the host is covered
# by work already queued, not by an idle card.
PROCESS_ENV = (("OMP_NUM_THREADS", "1"), ("CUDA_SCALE_LAUNCH_QUEUES", "4x"))


def process_env() -> None:
    for var, value in PROCESS_ENV:
        os.environ[var] = value


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _one(entries, name, what):
    hits = [e for e in entries if e["name"] == name]
    if len(hits) != 1:
        raise SystemExit(f"{what} {name!r}: {len(hits)} entries in "
                         "BENCHMARK.json")
    return hits[0]


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic mix and
    metrics, each read from its file."""
    cell = _one(spec["workloads"], workload, "workload")
    conf = _one(spec["configs"], cell["config"], "config")
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _covers(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _covers(m, workload) and m["moves"] in moved]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "e2e": e2e,
            "per_layer": layer}


def reader(name: str, root: str = ROOT):
    """The ``read(record)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def driver(kind: str):
    """The ``run(ctx)`` of the driver ``benchmark/<kind>.py``."""
    return importlib.import_module(f"benchmark.{kind}").run


def power_line(device) -> None:
    """The card's name and power limit, on standard error."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    print(f"card: {out}", file=sys.stderr, flush=True)


def execute(res: dict, seed: int, seconds: float, trace: bool, device,
            control: bool = False) -> dict:
    """Run a resolved cell on ``device`` and return the result line's
    object (without the checks for a card)."""
    import numpy as np
    import torch
    from benchmark import compare, harness, work
    from benchmark.reference import egonet_ref
    ctx = harness.Context(res["cell"], res["cfg"], res["traffic"], int(seed),
                          float(seconds), bool(trace), torch.device(device),
                          T_START, control)
    out = driver(res["traffic"]["kind"])(ctx)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the plain reference over the sampled crops, their frames uploaded now
    gap = {"missing": out.missing}
    if len(out.items["frame"]):
        slots = sorted(set(out.items["frame"].tolist()))
        where = {s: i for i, s in enumerate(slots)}
        frames = torch.from_numpy(np.stack([out.frames[s] for s in slots]))
        items = dict(out.items, frame=np.asarray(
            [where[s] for s in out.items["frame"]], np.int64))
        hs, lst, ls_stats = out.weights
        hs = {k: v.to(ctx.device) for k, v in hs.items()}
        lst = {k: v.to(ctx.device) for k, v in lst.items()}
        ref = egonet_ref.run(frames.to(ctx.device), items, hs, lst, ls_stats,
                             res["cfg"])
        gap.update(compare.gaps(out.port, ref, out.missing))
    correct, compared = compare.judge(gap, res["cfg"].get("limits", {}))

    record = {"cell": res["cell"], "config": res["cfg"],
              "traffic": res["traffic"], "window_s": out.window_s,
              "crops": out.crops, "work": work.crop_work(res["cfg"]),
              "peaks": work.PEAKS.get(torch.cuda.get_device_name(ctx.device))
              if cuda else None,
              "trace": out.trace}
    metrics = {}
    if trace:
        for m in res["per_layer"]:
            v = reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        for m in res["e2e"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics,
            "device": {"platform": "gpu" if cuda else ctx.device.type,
                       "kind": torch.cuda.get_device_name(ctx.device)
                       if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and out.trace:
        line["device"]["busy_s"] = out.trace["busy_s"]
        line["device"]["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cache_dirs()
    process_env()
    res = resolve(load_spec(), args.workload)
    import torch
    chips = int(res["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    power_line(device)
    line = execute(res, args.seed, args.seconds, bool(args.trace), device,
                   args.control)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
