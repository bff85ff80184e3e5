"""Dry run of the port's data-parallel paths (counterpart of
``__graft_entry__.dryrun_multichip``), one process per card:

    torchrun --nproc_per_node=N -m egonet_tpu_torch.tools.dryrun_multigpu
    python -m egonet_tpu_torch.tools.dryrun_multigpu --nproc N \\
        [--backend gloo|nccl] [--device cuda|cuda:0|cpu] [--budget-s S]

``--nproc`` spawns the ranks itself (``parallel/mesh.run_ranks``; how the
tests run it on the CPU over gloo and the smoke run puts two ranks on one
card).  Runs on the card unless ``--device cpu``; raises without one.  The
legs, each ending in a ``[dryrun leg ok]`` line from rank 0:

1. sharded IGR training at the 140-instance cap (``MAX_INS_CNT``, which
   does not divide 3 or 8 ranks: the wrap padding is exercised), a shrunk
   HRNet, the real loader, 4 steps, the loss falling;
2. the data-parallel step against a single-process step (``mesh.solo``)
   on the same batch (2 instances a rank);
3. sharded inference (``EgoNet(mesh=...)`` over the ranks' devices, on
   rank 0) against the single-device facade;
4. exact resume under the group: 2 epochs, then resumed to 3, bit-equal
   to 3 straight epochs (every parameter, buffer, optimizer moment, step);
5. node shards (``data/loader.host_shard``) disjoint and covering, the
   ranks of a node reading the same records;
6. the lifter's data-parallel step against its single-process step;
7. the full-width W48: sharded inference against single (fp32), and one
   data-parallel train step of 12 real instances in 16 slots.

Each leg but the first is admitted only when its estimated seconds fit
in what is left of ``--budget-s`` (rank 0 decides for every rank); with
one rank the legs that hold the group against a single process
(``GROUP_LEGS``) have nothing to compare and are left out.  A skipped
leg prints ``[dryrun leg SKIP]`` with its reason.  ``--out`` names a
JSON file rank 0 writes: the legs run, with their seconds, and the legs
skipped, with their reasons.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from egonet_tpu_torch.parallel import mesh

CANVAS = (128, 416)
N_JOINTS = 33
# seconds each admitted leg is expected to take on the card, cold
LEG_ESTIMATES = {"train_parity": 30, "inference_parity": 30,
                 "mesh_resume": 60, "node_shards": 5, "lifter_parity": 10,
                 "w48": 240}
# legs that hold the group's run against a single process's
GROUP_LEGS = ("train_parity", "inference_parity", "mesh_resume",
              "lifter_parity", "w48")


def small_config(device) -> dict:
    """The demo config with a shrunk HRNet (widths 8-64, 64x64 crops), an
    Adam optimizer and 2 frames a batch."""
    from egonet_tpu_torch.config import demo_config
    cfgs = demo_config()
    extra = cfgs["heatmapModel"]["extra"]
    for stage, chans in (("stage2", [8, 16]), ("stage3", [8, 16, 32]),
                         ("stage4", [8, 16, 32, 64])):
        extra[stage].update({"num_channels": chans,
                             "num_blocks": [1] * len(chans),
                             "num_modules": 1})
    cfgs["heatmapModel"]["input_size"] = [64, 64]
    cfgs["heatmapModel"]["heatmap_size"] = [16, 16]
    return _trainable(cfgs, device, batch_size=2)


def _trainable(cfgs, device, batch_size):
    cfgs["training_settings"] = {"batch_size": batch_size,
                                 "total_epochs": 1}
    cfgs["optimizer"] = {"optim_type": "adam", "lr": 1e-3,
                         "weight_decay": 0.0, "momentum": 0.9,
                         "milestones": [10], "gamma": 0.5}
    cfgs["device"] = str(device)
    return cfgs


def write_records(directory, rng, n_images, per_img, canvas, box_wh):
    """``n_images`` random PNG frames of ``canvas`` with ``per_img`` boxes
    each (widths and heights in ``box_wh`` ranges) and random keypoints
    inside them: IGR training records."""
    from egonet_tpu_torch.data import png
    records = []
    (w0, w1), (h0, h1) = box_wh
    for i in range(n_images):
        path = os.path.join(directory, f"{i:06d}.png")
        with open(path, "wb") as f:
            f.write(png.encode(rng.randint(0, 255, canvas + (3,))
                               .astype(np.uint8)))
        x = rng.uniform(0, canvas[1] - w1, per_img)
        y = rng.uniform(0, canvas[0] - h1, per_img)
        boxes = np.stack([x, y, x + rng.uniform(w0, w1, per_img),
                          y + rng.uniform(h0, h1, per_img)], axis=1)
        kpts = np.stack([
            rng.uniform(boxes[:, 0, None], boxes[:, 2, None],
                        (per_img, N_JOINTS)),
            rng.uniform(boxes[:, 1, None], boxes[:, 3, None],
                        (per_img, N_JOINTS))], axis=-1)
        records.append({"path": path, "boxes": boxes, "kpts": kpts})
    return records


def _agree(value):
    """Rank 0's ``value`` on every rank."""
    if not mesh.active():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _gather(value) -> list:
    if not mesh.active():
        return [value]
    out = [None] * mesh.world()
    dist.all_gather_object(out, value)
    return out


def _state_tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt.{i}.{k}"] = v
    return out


def run_legs(device, budget_s: float, out: str | None = None,
             legs=tuple(LEG_ESTIMATES)) -> dict:
    """The first leg and those of ``legs`` admitted (see the module's
    docstring) on this rank (all ranks run the same legs in the same
    order); returns rank 0's summary."""
    from egonet_tpu_torch.constants import MAX_INS_CNT
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.train.igrs import IGRTrainer

    t_start = time.perf_counter()
    main = mesh.is_main()
    n = mesh.world()
    summary = {"ranks": n, "device": str(device), "backend":
               dist.get_backend() if dist.is_initialized() else None,
               "legs": {}, "skipped": {}}

    def say(text):
        if main:
            print(text, flush=True)

    def leg_done(name, t0, text):
        summary["legs"][name] = time.perf_counter() - t0
        say(f"[dryrun leg ok] {name}: {text} "
            f"(t={time.perf_counter() - t_start:.0f}s)")

    def admit(name):
        if name not in legs:
            return False
        elapsed = time.perf_counter() - t_start
        if n == 1 and name in GROUP_LEGS:
            reason = "one rank"
        elif not _agree(elapsed + LEG_ESTIMATES[name] <= budget_s):
            reason = (f"t={elapsed:.0f}s + est {LEG_ESTIMATES[name]}s > "
                      f"budget {budget_s:.0f}s")
        else:
            return True
        summary["skipped"][name] = reason
        say(f"[dryrun leg SKIP] {name} ({reason})")
        return False

    cfgs = small_config(device)
    tmp = tempfile.mkdtemp(prefix="egonet_dryrun_")
    shared = _agree(tmp)                  # rank 0's directory, for the resume
    try:
        rng = np.random.RandomState(0)
        per_img = (MAX_INS_CNT + 2) // 2        # 2 frames a batch: cap hit
        records = write_records(tmp, rng, 2, per_img, CANVAS,
                                ((30, 79), (20, 49)))

        # 1. sharded training at the instance cap --------------------------
        t0 = time.perf_counter()
        trainer = IGRTrainer(cfgs, device=device)
        state = trainer.init_state(0)
        batch = next(IGRBatchLoader(records, cfgs, train=True,
                                    canvas_hw=CANVAS, seed=0).epoch())
        if int(batch["mask"].sum()) != MAX_INS_CNT:
            raise AssertionError("the instance cap was not reached")
        shard = mesh.shard_batch(batch)
        padded = shard["shard"][2] if "shard" in shard else MAX_INS_CNT
        if MAX_INS_CNT % mesh.local_world() and padded == MAX_INS_CNT:
            raise AssertionError("the cap's padding was not exercised")
        losses = []
        for step in range(4):
            state, metrics = trainer.train_step(state, batch,
                                                apply_cr=step >= 1)
            losses.append(float(metrics["loss"]))
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"loss {losses[-1]} at step {step}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        leg_done("sharded_train", t0,
                 f"{n} ranks, {MAX_INS_CNT} instances padded to {padded}, "
                 f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")

        # 2. data-parallel step against the single-process step ------------
        if admit("train_parity"):
            t0 = time.perf_counter()
            k = 2 * mesh.local_world()
            boxes = np.stack([np.array([4.0 + 5 * i, 8.0, 40.0 + 5 * i, 44.0])
                              for i in range(k)])
            kpts = np.stack([
                rng.uniform(boxes[:, 0, None], boxes[:, 2, None],
                            (k, N_JOINTS)),
                rng.uniform(boxes[:, 1, None], boxes[:, 3, None],
                            (k, N_JOINTS))], axis=-1)
            rec = [{"path": records[0]["path"], "boxes": boxes,
                    "kpts": kpts}]
            pbatch = next(IGRBatchLoader(rec, cfgs, train=True,
                                         canvas_hw=CANVAS, max_instances=k,
                                         seed=0).epoch())
            dp = IGRTrainer(cfgs, device=device)
            dp_state, dp_m = dp.train_step(dp.init_state(0), pbatch,
                                           apply_cr=True)
            with mesh.solo():
                one = IGRTrainer(cfgs, device=device)
                one_state, one_m = one.train_step(one.init_state(0), pbatch,
                                                  apply_cr=True)
            a, b = float(dp_m["loss"]), float(one_m["loss"])
            if abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"loss {a} against single {b}")
            gap = max(float((dp_state.model.state_dict()[key].double()
                             - v.double()).abs().max())
                      for key, v in one_state.model.state_dict().items()
                      if key.endswith(("running_mean", "running_var")))
            if gap > 1e-4:
                raise AssertionError(f"BN statistics {gap} apart")
            leg_done("train_parity", t0,
                     f"{k} instances, loss {a:.6f} == {b:.6f}, BN "
                     f"statistics within {gap:.2e}")

        # 3. sharded inference against single ------------------------------
        devices = _gather(str(device))
        annot = {"path": [r["path"] for r in records],
                 "boxes": [r["boxes"] for r in records],
                 "K": [np.array([[320.0, 0, 208], [0, 320.0, 64],
                                 [0, 0, 1.0]]) for _ in records],
                 "raw_txt_format": [[] for _ in records]}
        if admit("inference_parity"):
            t0 = time.perf_counter()
            if main:
                msg = _inference_parity(cfgs, devices, annot, torch.float32,
                                        alpha_tol=1e-4, kpts_tol=1e-3)
            mesh.barrier()
            leg_done("inference_parity", t0, msg if main else "")

        # 4. exact resume under the group ----------------------------------
        if admit("mesh_resume"):
            t0 = time.perf_counter()
            msg = _mesh_resume(cfgs, device, records, shared)
            leg_done("mesh_resume", t0, msg)

        # 5. node shards ---------------------------------------------------
        if admit("node_shards"):
            t0 = time.perf_counter()
            msg = _node_shards()
            leg_done("node_shards", t0, msg)

        # 6. the lifter ----------------------------------------------------
        if admit("lifter_parity"):
            t0 = time.perf_counter()
            msg = _lifter_parity(device, rng, cfgs["optimizer"])
            leg_done("lifter_parity", t0, msg)

        # 7. full-width W48 ------------------------------------------------
        if admit("w48"):
            t0 = time.perf_counter()
            msg = _w48(device, devices, tmp)
            leg_done("w48", t0, msg)
        mesh.barrier()          # rank 0's directory outlives every rank's use
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_start
    say(f"dryrun_multigpu({n}): ok, {len(summary['legs'])} legs in "
        f"{summary['seconds']:.0f}s"
        + (" (skipped: " + ", ".join(f"{k}: {v}" for k, v in
                                     summary["skipped"].items()) + ")"
           if summary["skipped"] else ""))
    if main and out:
        with open(out, "w") as f:
            json.dump(summary, f)
    return summary


def _inference_parity(cfgs, devices, annot, dtype, alpha_tol, kpts_tol,
                      ls_stats=None, canvas=CANVAS):
    """EgoNet over a mesh of ``devices`` against the single-device facade
    on ``annot`` (rank 0 alone: no collective)."""
    from egonet_tpu_torch.models.egonet import EgoNet
    with mesh.solo():
        sharded = EgoNet(cfgs, dtype=dtype, mesh=mesh.DataMesh(devices))
        single = EgoNet(cfgs, dtype=dtype, device=devices[0])
        if ls_stats is not None:
            sharded.load_state(ls_stats=ls_stats)
            single.load_state(ls_stats=ls_stats)
        got = sharded.forward_annot_dict(annot, canvas_hw=canvas)
        want = single.forward_annot_dict(annot, canvas_hw=canvas)
    da = dk = 0.0
    for path in annot["path"]:
        da = max(da, float(np.abs(got[path]["alphas"]
                                  - want[path]["alphas"]).max()))
        dk = max(dk, float(np.abs(got[path]["kpts_3d_pred"]
                                  - want[path]["kpts_3d_pred"]).max()))
    if da > alpha_tol or dk > kpts_tol:
        raise AssertionError(f"sharded against single: alpha {da}, "
                             f"kpts_3d {dk}")
    n = sum(len(b) for b in annot["boxes"])
    return (f"{n} instances over {len(devices)} shards, |d alpha| {da:.2e} "
            f"rad, |d kpts_3d| {dk:.2e}")


def _mesh_resume(cfgs, device, records, directory):
    """Bit-equality needs deterministic kernels on the card (cuDNN's
    default backward algorithms may accumulate with atomics): the leg runs
    under ``device.deterministic``, as the training CLIs' exact resume
    does."""
    from egonet_tpu_torch.device import deterministic
    with deterministic():
        return _mesh_resume_runs(cfgs, device, records, directory)


def _mesh_resume_runs(cfgs, device, records, directory):
    from egonet_tpu_torch.io.train_ckpt import TrainCheckpointManager
    from egonet_tpu_torch.train.igrs import IGRTrainer
    kw = {"loader_kwargs": {"canvas_hw": CANVAS, "shard_hosts": False}}
    dir_a, dir_b = (os.path.join(directory, d) for d in ("ck_a", "ck_b"))
    with TrainCheckpointManager(dir_a, async_save=False) as mgr:
        state_a, _ = IGRTrainer(cfgs, device=device).fit(
            records, epochs=3, seed=5, ckpt_manager=mgr, **kw)
    with TrainCheckpointManager(dir_b, async_save=False) as mgr:
        IGRTrainer(cfgs, device=device).fit(records, epochs=2, seed=5,
                                            ckpt_manager=mgr, **kw)
    trainer = IGRTrainer(cfgs, device=device)    # a restarted process's
    with TrainCheckpointManager(dir_b, async_save=False) as mgr:
        if mgr.latest_step() != 2:
            raise AssertionError(f"latest step {mgr.latest_step()}")
        restored = mgr.restore(trainer.init_state(0), step=2)
        state_c, _ = trainer.fit(records, epochs=3, seed=5, state=restored,
                                 ckpt_manager=mgr, start_epoch=2, **kw)
    a, c = _state_tensors(state_a), _state_tensors(state_c)
    bad = [k for k in a if not torch.equal(a[k], c[k])]
    if bad or set(a) != set(c) or state_a.step != state_c.step:
        raise AssertionError(f"resumed state differs: {bad[:5]}")
    return f"{len(a)} tensors bit-equal at step {state_a.step}"


def _node_shards():
    from egonet_tpu_torch.data.loader import ArrayBatchLoader, host_shard
    recs = [f"rec{i}" for i in range(11)]        # uneven on purpose
    shards = [host_shard(recs, index=i, count=2) for i in range(2)]
    if [len(s) for s in shards] != [6, 6]:
        raise AssertionError([len(s) for s in shards])
    real = [set(s) for s in shards]
    if real[0] & real[1] or real[0] | real[1] != set(recs):
        raise AssertionError("node shards overlap or miss records")
    pads = {host_shard(recs, index=1, count=2, epoch=e)[-1]
            for e in range(5)}
    if len(pads) != 5:
        raise AssertionError(f"the padding does not rotate: {pads}")
    seen = set()
    xs = np.arange(22, dtype=np.float32).reshape(11, 2)
    ys = np.arange(11, dtype=np.float32).reshape(11, 1)
    for i in range(2):
        rows = host_shard(np.arange(11), index=i, count=2)
        ld = ArrayBatchLoader(xs[rows], ys[rows], batch_size=3, seed=0,
                              shard_hosts=False)
        for b in ld.epoch(shuffle=False):
            seen |= set(b["output"][b["mask"] > 0, 0].tolist())
    if seen != set(range(11)):
        raise AssertionError(f"the node batches miss rows: {seen}")
    # under the group: this node's ranks read the same records
    mine = host_shard(recs)
    node, nodes = mesh.node()
    same = [s for s, r in zip(_gather(mine), range(mesh.world()))
            if r // mesh.local_world() == node]
    if any(s != mine for s in same):
        raise AssertionError("ranks of one node read different records")
    return (f"2 nodes x 11 records disjoint and covering; {mesh.world()} "
            f"ranks on {nodes} node(s) read {len(mine)} records each")


def _lifter_parity(device, rng, optimizer):
    from egonet_tpu_torch.train.lifting import LiftingTrainer
    lcfg = {"FCModel": {"input_size": 8, "output_size": 6,
                        "num_neurons": 16, "num_blocks": 1, "dropout": 0.0},
            "optimizer": optimizer, "training_settings": {}}
    k = 2 * mesh.local_world()
    lbatch = {"input": rng.randn(k, 8).astype(np.float32),
              "output": rng.randn(k, 6).astype(np.float32),
              "mask": np.ones(k, np.float32)}
    lbatch = _agree(lbatch)
    dp = LiftingTrainer(lcfg, device=device)
    _, loss_dp = dp.train_step(dp.init_state(0), lbatch)
    with mesh.solo():
        one = LiftingTrainer(lcfg, device=device)
        _, loss_one = one.train_step(one.init_state(0), lbatch)
    a, b = float(loss_dp), float(loss_one)
    if abs(a - b) > 1e-5 * abs(b):
        raise AssertionError(f"lifter loss {a} against single {b}")
    return f"{k} rows, loss {a:.6f} == {b:.6f}"


def _w48(device, devices, tmp):
    from egonet_tpu_torch.config import demo_config
    from egonet_tpu_torch.data.loader import IGRBatchLoader
    from egonet_tpu_torch.precision import _plausible_ls_stats
    from egonet_tpu_torch.train.igrs import IGRTrainer
    w48 = _trainable(demo_config(), device, batch_size=1)
    rng = np.random.RandomState(1)
    canvas = (256, 832)
    n_real, n_slots = 12, 16
    os.makedirs(os.path.join(tmp, "w48"), exist_ok=True)
    [rec] = write_records(os.path.join(tmp, "w48"), rng, 1, n_slots, canvas,
                          ((90, 199), (70, 139)))
    annot = {"path": [rec["path"]], "boxes": [rec["boxes"][:n_real]],
             "K": [np.array([[707.0, 0, 416], [0, 707.0, 128],
                             [0, 0, 1.0]])],
             "raw_txt_format": [[]]}
    msg = ""
    if mesh.is_main():
        msg = _inference_parity(w48, devices, annot, torch.float32,
                                alpha_tol=3e-4, kpts_tol=2e-3,
                                ls_stats=_plausible_ls_stats(),
                                canvas=canvas)
    mesh.barrier()
    trainer = IGRTrainer(w48, device=device)
    batch = next(IGRBatchLoader(
        [{"path": rec["path"], "boxes": rec["boxes"][:n_real],
          "kpts": rec["kpts"][:n_real]}], w48, train=True,
        canvas_hw=canvas, max_instances=n_slots, seed=0).epoch())
    if len(batch["mask"]) != n_slots or int(batch["mask"].sum()) != n_real:
        raise AssertionError("the padding mask was not exercised")
    _, metrics = trainer.train_step(trainer.init_state(0), batch,
                                    apply_cr=True)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"W48 loss {loss}")
    return f"{msg}; train step {n_real} real in {n_slots} slots, loss " \
           f"{loss:.4f}"


def _rank(device, budget_s, out, legs=tuple(LEG_ESTIMATES)):
    """One spawned rank (``--nproc``): run the legs on its device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    run_legs(dev, budget_s, out, legs)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=0,
                        help="spawn this many ranks here (0: run as this "
                             "process's rank, under torchrun or alone)")
    parser.add_argument("--backend", default=None,
                        help="nccl on the card, gloo on the CPU by default")
    parser.add_argument("--device", default="cuda",
                        help="cuda (each rank its local card), cuda:N "
                             "(every rank that card) or cpu")
    parser.add_argument("--budget-s", type=float, default=1500.0,
                        help="admit a leg only if its estimate fits")
    parser.add_argument("--out", default=None,
                        help="JSON summary written by rank 0")
    parser.add_argument("--timeout-s", type=float, default=1800.0,
                        help="--nproc: stop the ranks after this long")
    args = parser.parse_args(argv)
    from egonet_tpu_torch.device import resolve_device
    resolve_device(args.device)                 # raises without a card
    if args.nproc:
        mesh.run_ranks(_rank, args.nproc,
                       args=(args.device, args.budget_s, args.out),
                       backend=args.backend, device=args.device,
                       timeout_s=args.timeout_s)
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = mesh.init_from_env(args.backend, args.device)
        try:
            return run_legs(device, args.budget_s, args.out)
        finally:
            dist.destroy_process_group()
    return run_legs(resolve_device(args.device), args.budget_s, args.out)


if __name__ == "__main__":
    main()
