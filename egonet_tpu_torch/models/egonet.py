"""EgoNet end-to-end inference facade in PyTorch: crop -> keypoints -> lift
-> 6DoF -> alpha.  Port of ``egonet_tpu/models/egonet.py``.

Per batch, the host takes decoded frames (``annot_dict["images"]``) or
decodes them through ``load_image`` and the decoded-image store, computes
the 2x3 crop matrices and packs the source pixels (ROI-packed canvas or
full canvases); the device runs

    separable affine warp + normalization            (ops/affine.py)
    keypoint model, 'coordinates' head -> local coords [N, 33, 2]
                                     (models/factory.py: the HRNet, 104
                                     branch blocks through the fused
                                     Hopper kernel in bf16 eval, or
                                     PoseNetTPU, cuDNN convs)
      or PoseResNet's 'heatmap' head -> maps [N, 33, Hm, Wm], then the
      soft-argmax readout to local coords (E[column] / Wm, E[row] / Hm)
                                     (models/resnet.py; ops/keypoints.py;
                                     no other family's 'heatmap' head)
    inverse affine to screen coords                  (batched fp32 matmul)
    LS-normalize -> FC lifter -> un-normalize        (models/fc_lifter.py)
    template fit + rigid solve + euler               (ops/rigid_solve.py:
                                     one hand-written kernel)
    alpha                                            (geometry/rigid.py)

and returns ONE flat [N, D] fp32 array, copied to pinned host memory
without blocking; ``finalize`` waits on a CUDA event and regroups it per
image; ``post_process`` writes byte-compatible KITTI txts.  Each stage runs
inside a named range (``utils/profiling.SPANS``; ``post_process`` and the
weight draw in ``__init__`` in their own), which a trace and the always-on
totals read.
Instance counts are padded to the JAX package's buckets so both packages
run identical batches.

With ``mesh`` (``parallel/mesh.DataMesh``) the instance rows are sharded:
the bucket is rounded up to a multiple of the mesh's size, every mesh
device holds a replica of the models and LS statistics and gets the
frames, and shard i (equal contiguous rows of ``meta``) runs the device
program on ``mesh.devices[i]``; the shards are launched one after another
without waiting, and their outputs copied into one host array in order.
The dispatch path (``dispatch_annot_dict`` -> ``_run`` -> ``_core`` /
``_core_packed`` -> ``_tail``) makes no host synchronisation: the only
host-to-device copies are the batch's, from pinned memory (the frames
pinned once and sent to each device), and every constant the program
reads is made once per device in ``to_device`` (:class:`Replica`), so
shard i+1 is enqueued while shard i runs.  The host waits in
``finalize`` only.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from os.path import join as pjoin
from typing import NamedTuple

import numpy as np
import torch

from egonet_tpu_torch.config import config_dtype
from egonet_tpu_torch.constants import norm_stats
from egonet_tpu_torch.device import full_precision_fp32, resolve_device
from egonet_tpu_torch.geometry import rigid
from egonet_tpu_torch.io import weights
from egonet_tpu_torch.models.factory import build_heatmap_model
from egonet_tpu_torch.models.fc_lifter import build_fc_model
from egonet_tpu_torch.models.init import numpy_init
from egonet_tpu_torch.models.resnet import PoseResNet
from egonet_tpu_torch.ops import affine, keypoints, packing
from egonet_tpu_torch.ops.rigid_solve import rigid_solve
from egonet_tpu_torch.parallel import mesh as pmesh
from egonet_tpu_torch.utils.profiling import span


def _on(device):
    """``device`` made current for the CUDA work launched under it."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class Replica(NamedTuple):
    """What one device runs the program with, all on that device: the
    models, the LS statistics, and the constants ``_tail`` reads (the
    crop's [width, height] scale and the crop normalisation's (mean,
    std)), made once in ``to_device`` so that a dispatch copies nothing
    from the host but the batch."""
    hrnet: torch.nn.Module
    lifter: torch.nn.Module
    ls_stats: dict
    scale: torch.Tensor
    norm: tuple


def _round_up_bucket(n: int, minimum: int = 8) -> int:
    """Instance-count bucket: powers of two up to 128, then multiples of
    128.  Kept from the JAX package for parity (its 384/128 rule was
    measured on a TPU; the H100 policy is still to be measured)."""
    b = minimum
    while b < n and b < 128:
        b *= 2
    if n <= b:
        return b
    return ((n + 127) // 128) * 128


# Per-instance inputs ride in ONE [N, META_COLS] f32 array.  Columns:
#   0:6   inv_mats, row-major 2x3 (the ORIGINAL source-frame affine)
#   6:8   ROI-packing offsets (x, y); zero in canvas mode
#   8     img_idx (canvas mode) / window start row win_y (packed mode)
#   9     validity mask
#   10    K focal length f
#   11    K principal point x
#   12:14 source image (width, height) — add_xy coordinate maps
#   14:18 packed-mode valid-read bounds (x0, x1, y0, y1)
META_COLS = 18


def pack_meta(inv_mats, idx, valid, K_f, K_cx, img_wh, offsets=None):
    """Build a [N, META_COLS] meta array (``img_wh`` always required:
    add_xy models normalize their coordinate channels by it)."""
    n = len(inv_mats)
    meta = np.zeros((n, META_COLS), np.float32)
    meta[:, 0:6] = np.asarray(inv_mats, np.float32).reshape(n, 6)
    if offsets is not None:
        meta[:, 6:8] = offsets
    meta[:, 8] = idx
    meta[:, 9] = valid
    meta[:, 10] = K_f
    meta[:, 11] = K_cx
    meta[:, 12:14] = img_wh
    return meta


def _unpack_meta(meta):
    """meta [N, META_COLS] -> (inv_mats, offsets, idx, valid, K_f, K_cx,
    img_wh, bounds)."""
    inv_mats = meta[:, 0:6].reshape(-1, 2, 3)
    return (inv_mats, meta[:, 6:8], meta[:, 8], meta[:, 9], meta[:, 10],
            meta[:, 11], meta[:, 12:14], meta[:, 14:18])


class EgoNet:
    """End-to-end monocular pose estimator (inference facade).

    ``device=None`` means CUDA and raises without it; ``dtype=None`` means
    the config's (bf16 unless ``bf16: false``).  ``mesh`` (a
    ``parallel/mesh.DataMesh``) shards each batch's instances over its
    devices; the facade's own device is then the mesh's first."""

    def __init__(self, cfgs: dict, pre_trained: bool = False, dtype=None,
                 rng_seed: int = 0, device=None, mesh=None):
        self.cfgs = cfgs
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh or pmesh.DataMesh([self.device])
        self.dtype = config_dtype(cfgs) if dtype is None else dtype
        hm = cfgs["heatmapModel"]
        self.resolution = tuple(hm["input_size"])           # (width, height)
        self.pack_mode = cfgs.get("roi_packing", "auto")
        if self.pack_mode not in ("auto", "never", "always"):
            raise ValueError(f"roi_packing must be auto/never/always, "
                             f"got {self.pack_mode!r}")
        hrnet = build_heatmap_model(cfgs, dtype=self.dtype)
        head = getattr(hrnet, "head_type", None)
        # PoseResNet's heatmaps are read out by a soft-argmax (``_tail``);
        # no other family's 'heatmap' head is held to a reference
        self.readout = isinstance(hrnet, PoseResNet)
        if head != ("heatmap" if self.readout else "coordinates"):
            raise ValueError("the facade reads keypoints from a "
                             "'coordinates' head, or from PoseResNet's "
                             "'heatmap' head; heatmapModel "
                             f"{hm.get('name', 'hrnet')!r} has the head "
                             f"{head!r}")
        lifter = build_fc_model(cfgs, dtype=self.dtype)
        with span("init_weights"):
            self.hrnet = numpy_init(hrnet, rng_seed).eval()
            self.lifter = numpy_init(lifter, rng_seed + 1).eval()
        fc = cfgs["FCModel"]
        self.ls_stats = {
            "mean_in": np.zeros((1, fc["input_size"]), np.float32),
            "std_in": np.ones((1, fc["input_size"]), np.float32),
            "mean_out": np.zeros((1, fc["output_size"]), np.float32),
            "std_out": np.ones((1, fc["output_size"]), np.float32),
        }
        if pre_trained:
            self.load_checkpoints(cfgs["dirs"]["ckpt"])
        self.to_device()
        self.transport_stats = {"packed_batches": 0, "canvas_batches": 0,
                                "packed_bytes": 0, "canvas_bytes": 0,
                                "h2d_bytes": 0}
        # decoded-image store (cfg: cache_images, default on;
        # image_cache_bytes; image_disk_cache, a directory for the raw
        # uint8 disk tier)
        self.image_store = None
        if cfgs.get("cache_images", True):
            from egonet_tpu_torch.data.image_store import ImageStore
            disk = cfgs.get("image_disk_cache") or None
            self.image_store = ImageStore(
                int(cfgs.get("image_cache_bytes", 2 << 30)),
                disk_dir=disk if isinstance(disk, str) else None)

    def to_device(self):
        """Move parameters and LS statistics to the device ONCE (HRNet in
        ``channels_last``), keep fp32 convs and matmuls at full fp32, and
        fold BN / pre-cast the HRNet conv weights for bf16 inference; with
        a mesh, copy them to each of its other devices.  Every device's
        :class:`Replica` also gets its own copy of the program's
        constants."""
        full_precision_fp32()
        self.hrnet.to(self.device, memory_format=torch.channels_last)
        self.lifter.to(self.device)
        self.hrnet.prepare_inference()
        self.ls_stats = {k: torch.as_tensor(np.asarray(v, np.float32),
                                            device=self.device)
                         for k, v in self.ls_stats.items()}
        self.replicas = {self.device: self._replica(
            self.device, self.hrnet, self.lifter, self.ls_stats)}
        for dev in self.mesh.distinct():
            if dev in self.replicas:
                continue
            hrnet = copy.deepcopy(self.hrnet).to(
                dev, memory_format=torch.channels_last)
            hrnet.prepare_inference()
            self.replicas[dev] = self._replica(
                dev, hrnet, copy.deepcopy(self.lifter).to(dev),
                {k: v.to(dev) for k, v in self.ls_stats.items()})

    def _replica(self, dev, hrnet, lifter, ls_stats) -> Replica:
        width, height = self.resolution
        mean, std = norm_stats(self.cfgs)
        return Replica(hrnet, lifter, ls_stats,
                       torch.tensor([width, height], dtype=torch.float32,
                                    device=dev),
                       (torch.as_tensor(mean, device=dev),
                        torch.as_tensor(std, device=dev)))

    def prepare_inference(self, **kwargs):
        """``prepare_inference(**kwargs)`` of every replica's keypoint
        model (e.g. ``stencil="1"``, which selects the stencil kernel)."""
        for replica in self.replicas.values():
            replica.hrnet.prepare_inference(**kwargs)

    def load_state(self, hrnet_state=None, lifter_state=None, ls_stats=None):
        """Load state_dicts (strict) and/or LS statistics, then refresh the
        device copies."""
        if hrnet_state is not None:
            self.hrnet.load_state_dict(hrnet_state, strict=True)
        if lifter_state is not None:
            self.lifter.load_state_dict(lifter_state, strict=True)
        if ls_stats is not None:
            self.ls_stats = {k: np.asarray(v, np.float32)
                             for k, v in ls_stats.items()}
        self.to_device()

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def load_checkpoints(self, ckpt_dir: str):
        """Load HC.pth / L.pth / LS.npy (whichever exist); after
        construction, the device copies (every mesh replica) follow."""
        import os
        hc, lf, ls = (pjoin(ckpt_dir, f) for f in ("HC.pth", "L.pth", "LS.npy"))
        if os.path.exists(hc):
            self.hrnet.load_state_dict(weights.load_torch_state_dict(hc),
                                       strict=True)
        if os.path.exists(lf):
            self.lifter.load_state_dict(weights.load_torch_state_dict(lf),
                                        strict=True)
        if os.path.exists(ls):
            self.ls_stats = weights.load_lifter_stats(ls)
        if hasattr(self, "replicas"):
            self.to_device()

    # ------------------------------------------------------------------
    # the device program
    # ------------------------------------------------------------------

    def _core(self, images, meta, img_idx=None, *, alpha_mode: str,
              replica=None):
        """Canvas mode: images [B, Hc, Wc, 3] uint8; meta [N, META_COLS];
        img_idx [N] host ints (each instance's frame, read as a view), or
        None: the frame indices are read from meta's column 8 on the
        device and the frames gathered (the exported program's form, whose
        graph takes no host ints; ``io/export.py``).  ``replica``: the
        :class:`Replica` to run, by default the facade's device's with the
        facade's LS statistics (which ``io/export.py`` swaps)."""
        width, height = self.resolution
        inv_mats, _o, idx, valid, K_f, K_cx, img_wh, _b = _unpack_meta(meta)
        if img_idx is None:
            img_idx = idx.long()
        with span("warp"):
            patches = affine.warp_affine_separable(
                images, inv_mats, img_idx, (height, width), dtype=self.dtype)
        return self._tail(patches, inv_mats, valid, K_f, K_cx, img_wh,
                          alpha_mode, replica)

    def _core_packed(self, canvas, meta, win_y, *, alpha_mode: str,
                     window_h: int, replica=None):
        """ROI-packed mode: canvas [Hp, Wp, 3] uint8; win_y [N] host ints."""
        width, height = self.resolution
        inv_mats, offsets, _w, valid, K_f, K_cx, img_wh, bounds = \
            _unpack_meta(meta)
        with span("warp"):
            patches = affine.warp_affine_separable_windowed(
                canvas, inv_mats, offsets, win_y, (height, width),
                window_h=window_h, dtype=self.dtype, bounds=bounds)
        return self._tail(patches, inv_mats, valid, K_f, K_cx, img_wh,
                          alpha_mode, replica)

    def _tail(self, patches, inv_mats, valid, K_f, K_cx, img_wh,
              alpha_mode: str, replica=None):
        """Post-warp body shared by both transports -> flat [N, D] fp32:
        screen kpts, lifter output, angles, translation, alpha, valid."""
        width, height = self.resolution
        if replica is None:
            replica = self.replicas[self.device]._replace(
                ls_stats=self.ls_stats)
        hrnet, lifter, ls = replica.hrnet, replica.lifter, replica.ls_stats
        with span("normalize"):
            crops = affine.normalize_crop_patches(
                self.cfgs, patches, inv_mats, img_wh, (height, width),
                stats=replica.norm)
        with span("backbone"):
            out = hrnet(crops.permute(0, 3, 1, 2))
        if self.readout:
            with span("readout"):
                coords = keypoints.soft_argmax_coords(out, unit=True)
        else:
            _maps, coords = out
        with span("inverse_affine"):
            local = coords * replica.scale
            screen = affine.batched_affine_transform(local, inv_mats)

        n = screen.shape[0]
        with span("lifter"):
            flat = screen.reshape(n, -1)
            norm_in = (flat - ls["mean_in"]) / ls["std_in"]
            pred = lifter(norm_in)
            pred = pred * ls["std_out"] + ls["mean_out"]
            kpts_3d = pred.reshape(n, -1, 3)

        with span("rigid"):
            # one launch: (rx, ry, rz) of the cuboid and the translation,
            # slot 0 (with the 33 points of 'R3d+T', the predicted
            # camera-frame root before the center-relative cuboid)
            six = rigid_solve(kpts_3d.float())
            angles, translations = six[:, 0:3], six[:, 3:6]
        with span("alpha"):
            ry = angles[:, 1]
            if alpha_mode == "trans":
                alphas = rigid.observation_angle_trans(ry, translations)
            else:
                alphas = rigid.observation_angle_proj(ry, screen[:, 0, 0],
                                                      K_f, K_cx)
            return torch.cat([flat, pred.float(), angles, translations,
                              alphas[:, None], valid[:, None]], dim=1)

    # ------------------------------------------------------------------
    # host-side batch assembly
    # ------------------------------------------------------------------

    def load_image(self, path: str) -> np.ndarray:
        """Image file -> RGB uint8, through the decoded-image store when
        there is one (cv2 where it imports, else the stdlib PNG reader)."""
        if self.image_store is not None:
            return self.image_store.get(path)
        from egonet_tpu_torch.data.image_store import decode_image
        return decode_image(path)

    def forward_annot_dict(self, annot_dict: dict, enlarge: float = 1.1,
                           alpha_mode: str = "proj",
                           canvas_hw=(384, 1280)) -> dict:
        """Process one batch: annot_dict has 'path' (image paths) and 'boxes'
        (per-image [Ni, 4]); optionally decoded 'images', 'K',
        'raw_txt_format', ...  Returns per-image records keyed by path."""
        return self.finalize(self.dispatch_annot_dict(
            annot_dict, enlarge, alpha_mode, canvas_hw))

    def dispatch_annot_dict(self, annot_dict: dict, enlarge: float = 1.1,
                            alpha_mode: str = "proj",
                            canvas_hw=(384, 1280),
                            pack_profile: str = "transport",
                            bucket_floor: int | None = None):
        """Host-prep one batch and enqueue the device program without
        waiting for it; returns a pending handle for :meth:`finalize` (None
        for an empty batch)."""
        with span("host_prep"):
            width, height = self.resolution
            target_ar = height / width
            paths = annot_dict["path"]
            n_img = len(paths)
            if "images" in annot_dict:
                decoded = annot_dict["images"]
            else:
                decoded = [self.load_image(p) for p in paths]

            boxes = [np.asarray(b, dtype=np.float64)
                     for b in annot_dict["boxes"]]
            per_image_counts = [len(b) for b in boxes]
            n_total = int(sum(per_image_counts))
            if n_total == 0:
                return None
            img_idx = np.repeat(np.arange(n_img, dtype=np.int32),
                                per_image_counts)
            whs = np.asarray([im.shape[1::-1] for im in decoded],
                             np.float64)[img_idx]
            # one call over the batch's boxes: each box's matrices are
            # elementwise in its own coordinates
            mats = affine.crop_matrices_for_boxes(
                np.concatenate([b.reshape(-1, 4) for b in boxes]),
                (height, width), target_ar, enlarge)
            inv_f64 = mats["inv"]
            inv_mats = inv_f64.astype(np.float32)
            centers, scales = mats["center"], mats["scale"]
            rbs = mats["bbox_resize"]

            # transport: the ROI-packed canvas when it moves fewer bytes than
            # the zero-padded full canvases, or when a frame exceeds the canvas
            plan = None
            if self.pack_mode != "never":
                plan = packing.plan(inv_f64, (height, width), whs,
                                    profile=pack_profile)
            use_pack = False
            if plan is not None:
                if self.pack_mode == "always" or pack_profile == "serving":
                    use_pack = True
                else:
                    oversize = any(im.shape[0] > canvas_hw[0]
                                   or im.shape[1] > canvas_hw[1]
                                   for im in decoded)
                    use_pack = oversize or (plan.canvas_bytes <
                                            n_img * canvas_hw[0]
                                            * canvas_hw[1] * 3)
            if use_pack:
                images = packing.assemble(plan, decoded, img_idx)
                self.transport_stats["packed_batches"] += 1
                self.transport_stats["packed_bytes"] += images.nbytes
            else:
                self.transport_stats["canvas_batches"] += 1
                self.transport_stats["canvas_bytes"] += (
                    n_img * canvas_hw[0] * canvas_hw[1] * 3)
                images = np.zeros((n_img, canvas_hw[0], canvas_hw[1], 3),
                                  np.uint8)
                for i, im in enumerate(decoded):
                    h, w = im.shape[:2]
                    if h > canvas_hw[0] or w > canvas_hw[1]:
                        raise ValueError(f"image {paths[i]} ({h}x{w}) exceeds "
                                         f"canvas {canvas_hw}")
                    images[i, :h, :w] = im

            Ks = [np.asarray(annot_dict["K"][i]) if "K" in annot_dict
                  else np.eye(3) for i in range(n_img)]
            K_f = np.array([k[0, 0] for k in Ks])[img_idx].astype(np.float32)
            K_cx = np.array([k[0, 2] for k in Ks])[img_idx].astype(np.float32)

            bucket = _round_up_bucket(n_total)
            if pack_profile == "serving":
                bucket = max(bucket, 128 if bucket_floor is None
                             else int(bucket_floor))
            bucket = pmesh.pad_to_multiple(bucket, len(self.mesh))
            pad = bucket - n_total
            valid = np.concatenate([np.ones(n_total, np.float32),
                                    np.zeros(pad, np.float32)])
            # padding rows: identity affines, benign K/img_wh (masked by valid)
            meta = np.zeros((bucket, META_COLS), np.float32)
            meta[:, 0:6] = np.eye(2, 3).reshape(6)
            meta[:n_total, 0:6] = inv_mats.reshape(n_total, 6)
            src_idx = np.zeros(bucket, np.int64)
            if use_pack:
                meta[:n_total, 6:8] = plan.offsets
                meta[:n_total, 8] = plan.win_y
                meta[:n_total, 14:18] = plan.bounds
                src_idx[:n_total] = plan.win_y
            else:
                meta[:n_total, 8] = img_idx
                src_idx[:n_total] = img_idx
            meta[:, 9] = valid
            meta[:, 10] = 1.0
            meta[:n_total, 10] = K_f
            meta[:n_total, 11] = K_cx
            meta[:, 12:14] = 1.0
            meta[:n_total, 12:14] = whs

        run = (functools.partial(self._core_packed, window_h=plan.window_h)
               if use_pack else self._core)
        host, ready = self._run(run, images, meta, src_idx, alpha_mode)
        ctx = dict(annot_dict=annot_dict, paths=paths,
                   per_image_counts=per_image_counts, centers=centers,
                   scales=scales, rbs=rbs)
        return host, ready, ctx

    def _run(self, run, images, meta, src_idx, alpha_mode):
        """Enqueue the device program ``run`` (``_core`` or a
        ``_core_packed``) on the batch, shard by shard over the mesh (one
        shard without one), and the copy of its output to the host;
        returns (host tensor, CUDA events to wait on).  The frames and
        meta are pinned once; the frames go to each device once."""
        frames, outs = {}, []
        with torch.inference_mode():
            with span("h2d"):
                images, meta = self._host(images), self._host(meta)
            for dev, (a, b) in zip(self.mesh, pmesh.shard_bounds(
                    len(meta), len(self.mesh))):
                with _on(dev):
                    if dev not in frames:
                        frames[dev] = self._upload(images, dev)
                    outs.append(run(frames[dev], self._upload(meta[a:b], dev),
                                    src_idx[a:b], alpha_mode=alpha_mode,
                                    replica=self.replicas[dev]))
            return self._download(outs)

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` as a host tensor, in pinned memory when the facade runs
        on the card (so that its copies to the card do not block)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t if self.device.type == "cpu" else t.pin_memory()

    def _upload(self, arr, device=None) -> torch.Tensor:
        """A numpy array or a :meth:`_host` tensor on ``device`` (by
        default the facade's), copied to a card without blocking (its bytes
        count in ``transport_stats["h2d_bytes"]``)."""
        device = self.device if device is None else device
        with span("h2d"):
            t = arr if isinstance(arr, torch.Tensor) else self._host(arr)
            if device.type == "cpu":
                return t
            self.transport_stats["h2d_bytes"] += t.nbytes
            return t.to(device, non_blocking=True)

    def _download(self, outs: list):
        """Start the device->host copy of the fused outputs (one per shard,
        in order) into one pinned host array; returns (host tensor, the
        CUDA events to wait on: one per shard)."""
        with span("d2h"):
            if self.device.type == "cpu":
                return (outs[0] if len(outs) == 1 else torch.cat(outs)), []
            n = sum(len(o) for o in outs)
            host = torch.empty((n,) + tuple(outs[0].shape[1:]),
                               dtype=outs[0].dtype, pin_memory=True)
            ready, start = [], 0
            for out in outs:
                with torch.cuda.device(out.device):
                    host[start:start + len(out)].copy_(out, non_blocking=True)
                    ready.append(torch.cuda.Event())
                    ready[-1].record()
                start += len(out)
            return host, ready

    def finalize(self, pending) -> dict:
        """Wait for a dispatched batch's outputs and regroup them per
        image."""
        if pending is None:
            return {}
        with span("finalize"):
            return self._finalize(pending)

    def _finalize(self, pending) -> dict:
        host, ready, ctx = pending
        for event in ready:
            event.synchronize()
        flat = host.numpy()
        annot_dict = ctx["annot_dict"]
        per_image_counts = ctx["per_image_counts"]
        centers, scales, rbs = ctx["centers"], ctx["scales"], ctx["rbs"]
        k2 = int(self.cfgs["heatmapModel"]["num_joints"]) * 2
        od = int(self.cfgs["FCModel"]["output_size"])
        out = {
            "kpts_2d": flat[:, :k2].reshape(-1, k2 // 2, 2),
            "kpts_3d": flat[:, k2:k2 + od].reshape(-1, od // 3, 3),
            "euler_angles": flat[:, k2 + od:k2 + od + 3],
            "translation": flat[:, k2 + od + 3:k2 + od + 6],
            "alphas": flat[:, k2 + od + 6],
            "valid": flat[:, k2 + od + 7],
        }
        records = {}
        start = 0
        for i, path in enumerate(ctx["paths"]):
            cnt = per_image_counts[i]
            if cnt == 0:
                continue
            sl = slice(start, start + cnt)
            rec = {
                "kpts_2d_pred": [out["kpts_2d"][j].reshape(1, -1)
                                 for j in range(start, start + cnt)],
                "kpts_3d_pred": out["kpts_3d"][sl],
                "euler_angles": out["euler_angles"][sl],
                "translation": out["translation"][sl],
                "alphas": out["alphas"][sl],
                "center": list(centers[sl]),
                "scale": list(scales[sl]),
                "bbox_resize": list(rbs[sl]),
                "boxes": np.asarray(annot_dict["boxes"][i]),
            }
            for key in ("K", "raw_txt_format", "scores", "kpts_3d_before",
                        "kpts", "kpts_3d_gt", "pose_vecs_gt",
                        "kpts_3d_SMOKE"):
                if key in annot_dict:
                    rec[key] = annot_dict[key][i]
            records[path] = rec
            start += cnt
        return records

    # ------------------------------------------------------------------
    # post-processing: KITTI txt emission
    # ------------------------------------------------------------------

    def post_process(self, records: dict, save_dict=None, alpha_mode=None,
                     visualize: bool = False, color_dict=None,
                     vis_dir: str | None = None, refine: bool = False):
        """Write KITTI txts (and optional visualizations) for each image
        record.

        With ``kpts_3d_SMOKE`` in a record (external 3D detector), the
        SMOKE center is prepended to the predicted cuboid and, for
        ``alpha_mode='trans'``, alpha is recomputed from that location.
        ``refine`` adds each record's PnP-refined cuboids
        (``kpts_3d_refined``, ``eval/refinement.py``; needs cv2) before the
        txts are written; ``visualize`` writes ``<stem>_2d.png`` and
        ``<stem>_3d.png`` into ``vis_dir`` (default: the txts' directory;
        needs matplotlib)."""
        with span("post_process"):
            return self._post_process(records, save_dict, alpha_mode,
                                      visualize, color_dict, vis_dir, refine)

    def _post_process(self, records, save_dict, alpha_mode, visualize,
                      color_dict, vis_dir, refine):
        import os
        from egonet_tpu_torch.io import kitti_writer
        for img_path, rec in records.items():
            if "kpts_3d_SMOKE" in rec and len(rec.get("kpts_3d_pred", [])):
                smoke = np.asarray(rec["kpts_3d_SMOKE"], np.float64)
                smoke = smoke.reshape(len(rec["kpts_3d_pred"]), -1, 3)
                centers = smoke[:, :1, :]
                rec["kpts_3d_abs"] = np.concatenate(
                    [centers, np.asarray(rec["kpts_3d_pred"])], axis=1)
                if alpha_mode == "trans":
                    ry = np.asarray(rec["euler_angles"])[:, 1]
                    x3, z3 = centers[:, 0, 0], centers[:, 0, 2]
                    alphas = ry - np.arctan2(-z3, x3) - 0.5 * np.pi
                    rec["translation"] = centers[:, 0, :]
                    rec["alphas"] = np.mod(alphas + np.pi,
                                           2.0 * np.pi) - np.pi
            if refine:
                from egonet_tpu_torch.eval.refinement import refine_record
                refine_record(rec)
            if "raw_txt_format" in rec:
                pred_str = kitti_writer.prediction_str(
                    rec["raw_txt_format"], rec["euler_angles"], rec["alphas"])
                rec["pred_str"] = pred_str
                if save_dict and save_dict.get("flag"):
                    kitti_writer.save_txt_file(img_path, pred_str,
                                               save_dict["save_dir"])
            if visualize:
                from egonet_tpu_torch.visualization import overlays
                out_dir = vis_dir or (save_dict or {}).get("save_dir", ".")
                stem = os.path.basename(img_path)[:-4]
                if rec.get("kpts_3d_gt") is not None and "K" in rec:
                    rec["arrow"] = overlays.add_orientation_arrow(
                        {"kpts_3d_pred": rec["kpts_3d_pred"],
                         "kpts_3d_gt": rec["kpts_3d_gt"], "K": rec["K"]})
                overlays.plot_2d_objects(
                    self.load_image(img_path), rec, color_dict,
                    save_path=os.path.join(out_dir, f"{stem}_2d.png"))
                overlays.plot_3d_objects(
                    rec, save_path=os.path.join(out_dir, f"{stem}_3d.png"))
        return records

    def stream_annot_dicts(self, annot_iter, depth: int = 2, **kwargs):
        """Pipelined inference over an iterable of annotation dicts: a
        producer thread runs host prep and enqueues device work up to
        ``depth`` batches ahead; a producer-side error re-raises here."""
        from egonet_tpu_torch.utils.pipeline import prefetch_map
        for pending in prefetch_map(
                lambda annot: self.dispatch_annot_dict(annot, **kwargs),
                annot_iter, depth):
            yield self.finalize(pending)

    def __call__(self, annot_dict: dict, **kwargs) -> dict:
        return self.forward_annot_dict(annot_dict, **kwargs)
