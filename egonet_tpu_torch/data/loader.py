"""Host-side input pipeline (port of ``egonet_tpu/data/loader.py``):
fixed-shape padded training batches for the IGR model
(:class:`IGRBatchLoader`) and the lifter (:class:`ArrayBatchLoader`), the
per-node record shard, box jitter, and the byte-capped LRU of decoded
images.

The host only decodes frames and reckons 2x3 crop matrices; the crop warp
and the Gaussian targets run on the device inside the train step.  Every
batch has the same shapes (images padded to a canvas, instances padded to
``MAX_INS_CNT`` by duplicating real ones), as in the JAX package, where
the static shapes let the step compile once; here the duplicates also
keep the train-mode batch statistics the same.  Frames are decoded by
``data/image_store.decode_image`` (cv2 where it imports, else the port's
PNG reader).  Box jitter: scale ~ U[1, 1+s], shift ~ 0.5*(scale-1)*dim*
U[-1, 1].
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from egonet_tpu_torch.constants import MAX_INS_CNT
from egonet_tpu_torch.ops import affine
from egonet_tpu_torch.parallel import mesh


class LRUImageCache:
    """Byte-capped LRU cache of decoded images.

    An unbounded memo of full-KITTI RGB (~10+ GB for 7,481 frames) would
    exhaust the host, so eviction is capped by total decoded bytes.
    Thread-safe."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._data = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            img = self._data.get(key)
            if img is not None:
                self._data.move_to_end(key)
            return img

    def put(self, key, img: np.ndarray):
        nb = img.nbytes
        if nb > self.max_bytes:
            return
        with self._lock:
            if key in self._data:
                return
            while self._bytes + nb > self.max_bytes and self._data:
                _, old = self._data.popitem(last=False)
                self._bytes -= old.nbytes
            self._data[key] = img
            self._bytes += nb

    def __len__(self):
        return len(self._data)

    @property
    def nbytes(self):
        return self._bytes


def host_shard(records, index: int | None = None, count: int | None = None,
               epoch: int = 0):
    """Disjoint per-node record shard for data parallelism: each node
    reads its strided slice, wrap-padded to the longest shard's length
    (every node must run the same number of steps).  ``index`` / ``count``
    default to this process's node and the number of nodes
    (``parallel/mesh.node``: rank // LOCAL_WORLD_SIZE and WORLD_SIZE //
    LOCAL_WORLD_SIZE under torchrun, (0, 1) without a process group): the
    ranks of one node read the same records and split each batch's rows
    between them, as the JAX package's hosts do over their chips.
    ``epoch`` rotates which records fill the padding slots; with more
    nodes than records every node gets one (epoch-rotated) record."""
    records = list(records)
    if count is None or index is None:
        index, count = mesh.node()
    if count <= 1 or not records:
        return records
    if not 0 <= index < count:
        raise ValueError(f"host index {index} outside [0, {count})")
    shard = records[index::count]
    want = -(-len(records) // count)            # ceil: max shard length
    if not shard:                                # more hosts than records
        shard = [records[(index + epoch) % len(records)]]
    base = list(shard)
    while len(shard) < want:                     # wrap-pad from own shard
        shard.append(base[(epoch + len(shard) - len(base)) % len(base)])
    return shard


def jitter_bbox(bbox, scaling_params, rng: np.random.RandomState):
    """Randomly rescale / shift a box without occluding keypoints."""
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    cx = 0.5 * (bbox[0] + bbox[2])
    cy = 0.5 * (bbox[1] + bbox[3])
    sx = scaling_params[0] * rng.rand() + 1
    sy = scaling_params[1] * rng.rand() + 1
    dx = 0.5 * (sx - 1) * w * (rng.rand() * 2 - 1)
    dy = 0.5 * (sy - 1) * h * (rng.rand() * 2 - 1)
    nw, nh = w * sx, h * sy
    return [cx + dx - 0.5 * nw, cy + dy - 0.5 * nh,
            cx + dx + 0.5 * nw, cy + dy + 0.5 * nh]


class IGRBatchLoader:
    """Batches for IGR (keypoint) training: dicts of fixed-shape numpy
    arrays

      images   [B, Hc, Wc, 3] uint8 (one more slot with ss)
      inv_mats [M, 2, 3] float32   patch -> source affines
      img_idx  [M] int32
      joints   [M, K, 3] float32   crop-frame keypoints + visibility
      mask     [M] float32         1 for real instances
      sup_mask [M] float32         1 for labelled real instances
      img_wh   [M, 2] float32      source (width, height)

    plus ``meta`` (host-side: centers, scales, original joints, instance
    ids, count) for the metrics.  M = ``max_instances``."""

    def __init__(self, records, cfgs: dict, train: bool,
                 canvas_hw=(384, 1280), max_instances: int = MAX_INS_CNT,
                 seed: int = 0, ss_record=None, ss_img_root: str = "",
                 ss_max_per_img: int = 6, shard_hosts: bool = True):
        self._all_records = list(records)
        self._shard_hosts = bool(shard_hosts)
        self._epoch_idx = 0
        self.records = host_shard(self._all_records) if shard_hosts \
            else self._all_records
        self.cfgs = cfgs
        self.train = train
        # weak self-supervision source (unlabeled boxes)
        self.ss_record = ss_record if train else None
        self.ss_img_root = ss_img_root
        self.ss_max_per_img = int(ss_max_per_img)
        self.canvas_hw = canvas_hw
        self.max_instances = int(max_instances)
        hm = cfgs["heatmapModel"]
        self.input_size = tuple(hm["input_size"])           # (w, h)
        self.target_ar = self.input_size[1] / self.input_size[0]
        self.jitter = bool(hm.get("jitter_bbox", False)) and train
        self.jitter_params = hm.get("jitter_params",
                                    {"scaling": [0.4, 0.4],
                                     "shift": [0.1, 0.1]})
        settings = cfgs["training_settings" if train else "testing_settings"]
        self.batch_images = int(settings.get("batch_size", 4))
        self.rng = np.random.RandomState(seed)
        self.cache_images = bool(cfgs.get("cache_images", True))
        self._image_cache = LRUImageCache(
            int(cfgs.get("image_cache_bytes", 2 << 30)))

    def __len__(self):
        return (len(self.records) + self.batch_images - 1) \
            // self.batch_images

    def steps_per_epoch(self):
        return len(self)

    def _load(self, path):
        if self.cache_images:
            cached = self._image_cache.get(path)
            if cached is not None:
                return cached
        from egonet_tpu_torch.data.image_store import decode_image
        img = decode_image(path)
        if self.cache_images:
            self._image_cache.put(path, img)
        return img

    def _decode_chunk(self, paths):
        """Decode a batch's frames on a thread pool (cv2 and zlib release
        the GIL)."""
        from concurrent.futures import ThreadPoolExecutor
        if len(paths) <= 1:
            return [self._load(p) for p in paths]
        if not hasattr(self, "_pool"):
            self._pool = ThreadPoolExecutor(max_workers=8)
        return list(self._pool.map(self._load, paths))

    def _assemble(self, chunk):
        width, height = self.input_size
        hc, wc = self.canvas_hw
        b = len(chunk)
        images = np.zeros((b, hc, wc, 3), np.uint8)
        inv_mats, img_idx, joints_local = [], [], []
        centers, scales, orig_joints, ids, whs = [], [], [], [], []
        decoded = self._decode_chunk([rec["path"] for rec in chunk])
        for i, rec in enumerate(chunk):
            img = decoded[i]
            h, w = img.shape[:2]
            images[i, :min(h, hc), :min(w, wc)] = img[:hc, :wc]
            for j in range(len(rec["boxes"])):
                bbox = rec["boxes"][j].astype(np.float64)
                kpts = rec["kpts"][j]                       # [K, 2]
                if self.jitter:
                    bbox = jitter_bbox(bbox, self.jitter_params["scaling"],
                                       self.rng)
                ret = affine.resize_bbox(bbox[0], bbox[1], bbox[2], bbox[3],
                                         target_ar=self.target_ar)
                c, s = ret["c"], ret["s"]
                fwd = affine.get_affine_transform(c, s, 0.0, (height, width))
                inv = affine.get_affine_transform(c, s, 0.0, (height, width),
                                                  inv=True)
                local = affine.affine_transform_pts(kpts[:, :2], fwd)
                vis = np.ones((len(local), 1))
                joints_local.append(np.hstack([local, vis])[None])
                inv_mats.append(inv[None])
                img_idx.append(i)
                centers.append(c)
                scales.append(s)
                orig_joints.append(kpts[:, :2][None])
                ids.append((i, j))
                whs.append((w, h))          # source size for add_xy maps

        m = len(img_idx)
        cap = self.max_instances
        if m > cap:                      # random subset of the instances
            chosen = list(self.rng.choice(m, cap, replace=False))
            inv_mats = [inv_mats[c] for c in chosen]
            joints_local = [joints_local[c] for c in chosen]
            img_idx = [img_idx[c] for c in chosen]
            centers = [centers[c] for c in chosen]
            scales = [scales[c] for c in chosen]
            orig_joints = [orig_joints[c] for c in chosen]
            ids = [ids[c] for c in chosen]
            whs = [whs[c] for c in chosen]
            m = cap
        pad = cap - m
        k = joints_local[0].shape[1] if joints_local else 33
        # padding slots duplicate real instances (cyclically): the forward
        # runs in train mode over every slot, so batch norm's statistics
        # see them; the loss mask zeroes them
        if m:
            pad_src = [i % m for i in range(pad)]
            inv_mats = inv_mats + [inv_mats[s] for s in pad_src]
            joints_pad = joints_local + [joints_local[s] for s in pad_src]
            img_idx_pad = img_idx + [img_idx[s] for s in pad_src]
            whs = whs + [whs[s] for s in pad_src]
        batch = {
            "images": images,
            "inv_mats": np.concatenate(inv_mats).astype(np.float32) if m else
            np.tile(np.eye(2, 3, dtype=np.float32)[None], (cap, 1, 1)),
            "img_idx": np.asarray(
                img_idx_pad if m else [0] * cap, np.int32),
            "joints": np.concatenate(joints_pad).astype(np.float32)
            if m else np.zeros((cap, k, 3), np.float32),
            "mask": np.concatenate(
                [np.ones(m, np.float32), np.zeros(pad, np.float32)]),
            "img_wh": (np.asarray(whs, np.float32) if m
                       else np.ones((cap, 2), np.float32)),
        }
        batch["meta"] = {
            "center": np.array(centers) if m else np.zeros((0, 2)),
            "scale": np.array(scales) if m else np.zeros((0, 2)),
            "original_joints": (np.concatenate(orig_joints)
                                if m else np.zeros((0, k, 2))),
            # (chunk index, box index) per kept instance, in batch order
            "instance_ids": (np.asarray(ids, np.int64)
                             if m else np.zeros((0, 2), np.int64)),
            "count": m,
        }
        batch["sup_mask"] = batch["mask"].copy()
        if self.ss_record is not None:
            batch = self._append_ss_instances(batch, chunk)
        return batch

    def _append_ss_instances(self, batch, chunk):
        """Fill padding slots with unlabeled crops from ONE extra canvas
        image (its slot exists whenever ss is on).  They train only the
        self-supervised cross-ratio term (mask 1, sup_mask 0)."""
        width, height = self.input_size
        hc, wc = batch["images"].shape[1:3]
        batch["images"] = np.concatenate(
            [batch["images"], np.zeros((1, hc, wc, 3), np.uint8)])
        img_slot = len(batch["images"]) - 1

        m = int(batch["mask"].sum())
        budget = max(0, self.ss_max_per_img * len(chunk) - m)
        take = min(budget, len(batch["mask"]) - m)
        if take <= 0:
            return batch
        paths = self.ss_record["paths"]
        i = self.rng.randint(0, len(paths))
        img_path = os.path.join(self.ss_img_root,
                                os.path.basename(paths[i])) \
            if self.ss_img_root else paths[i]
        try:
            img = self._load(img_path)
        except (ValueError, FileNotFoundError):
            return batch
        h, w = img.shape[:2]
        batch["images"][img_slot, :min(h, hc), :min(w, wc)] = img[:hc, :wc]
        for n, bbox in enumerate(self.ss_record["boxes"][i][:take]):
            ret = affine.resize_bbox(bbox[0], bbox[1], bbox[2], bbox[3],
                                     target_ar=self.target_ar)
            inv = affine.get_affine_transform(
                ret["c"], ret["s"], 0.0, (height, width), inv=True)
            idx = m + n
            batch["inv_mats"][idx] = inv.astype(np.float32)
            batch["img_idx"][idx] = img_slot
            batch["img_wh"][idx] = (w, h)
            batch["mask"][idx] = 1.0
            batch["sup_mask"][idx] = 0.0
        return batch

    def reseed(self, seed: int) -> None:
        """Re-key the shuffle RNG (a run that resumes derives it from
        (seed, epoch) to replay the same batch order)."""
        self.rng = np.random.RandomState(seed & 0x7FFFFFFF)

    def set_epoch(self, epoch: int) -> None:
        """Rotate the per-process wrap-padding (DistributedSampler's
        ``set_epoch`` idiom); a no-op for unsharded loaders."""
        self._epoch_idx = int(epoch)
        if self._shard_hosts:
            self.records = host_shard(self._all_records, epoch=epoch)

    def epoch(self, shuffle: bool | None = None):
        order = np.arange(len(self.records))
        if shuffle if shuffle is not None else self.train:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_images):
            chunk = [self.records[i]
                     for i in order[start:start + self.batch_images]]
            batch = self._assemble(chunk)
            # an all-padding batch carries no gradient but would still move
            # the batch-norm statistics (keyed on the mask: ss crops count)
            if float(batch["mask"].sum()) == 0.0:
                continue
            yield batch

    def prefetched_epoch(self, depth: int = 2, device_fn=None, **kwargs):
        """:meth:`epoch` assembled ``depth`` batches ahead on a producer
        thread, with ``device_fn`` (the trainer's host->device copy)
        applied there, so the copy of batch i+1 overlaps the step of batch
        i.  Producer exceptions re-raise in the consumer."""
        from egonet_tpu_torch.utils.pipeline import prefetch_map
        yield from prefetch_map(device_fn, self.epoch(**kwargs), depth)


class ArrayBatchLoader:
    """Shuffling batcher over in-RAM arrays (lifter training).  The last
    batch is wrap-padded with duplicates of real rows (mask 0)."""

    def __init__(self, inputs, outputs, batch_size: int, seed: int = 0,
                 drop_remainder: bool = False, shard_hosts: bool = True):
        self._full_inputs = np.asarray(inputs)
        self._full_outputs = np.asarray(outputs)
        self._shard_hosts = bool(shard_hosts)
        self.batch_size = int(batch_size)
        self.rng = np.random.RandomState(seed)
        self.drop_remainder = drop_remainder
        self.set_epoch(0)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.RandomState(seed & 0x7FFFFFFF)

    def set_epoch(self, epoch: int) -> None:
        """Rotate the per-process wrap-padding (see :func:`host_shard`)."""
        inputs, outputs = self._full_inputs, self._full_outputs
        if self._shard_hosts:
            rows = host_shard(np.arange(len(inputs)), epoch=int(epoch))
            if len(rows) != len(inputs) or not np.array_equal(
                    rows, np.arange(len(inputs))):
                inputs, outputs = inputs[rows], outputs[rows]
        self.inputs = inputs
        self.outputs = outputs

    def steps_per_epoch(self):
        n = len(self.inputs)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, shuffle: bool = True):
        n = len(self.inputs)
        order = np.arange(n)
        if shuffle:
            self.rng.shuffle(order)
        stop = (n // self.batch_size * self.batch_size
                if self.drop_remainder else n)
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            x = self.inputs[idx]
            y = self.outputs[idx]
            mask = np.ones(len(idx), np.float32)
            if len(idx) < self.batch_size:      # pad to static shape
                # duplicates of real rows, not zeros: train-mode batch norm
                # sees the whole padded batch
                pad = self.batch_size - len(idx)
                src = np.arange(pad) % len(idx)
                x = np.concatenate([x, x[src]])
                y = np.concatenate([y, y[src]])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield {"input": x, "output": y, "mask": mask}
