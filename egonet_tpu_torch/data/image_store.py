"""Decoded-image store: RAM LRU + optional raw uint8 disk cache (port of
``egonet_tpu/data/image_store.py``).

Repeated passes over the same frames (validation re-runs, serving replays,
benchmarks) skip the PNG decode: the store keeps a byte-capped in-RAM LRU
of decoded RGB frames and, optionally, a disk cache of the decoded pixels
(.npy), keyed by (absolute path, mtime, size) so that an edited source
image misses the cache.

Decoding uses cv2 where it can be imported and the port's own stdlib PNG
reader (:mod:`egonet_tpu_torch.data.png`) where it cannot, as on GPU
hosts without OpenCV; ``ImageStore.stats["decoder"]`` says which.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from egonet_tpu_torch.data import png
from egonet_tpu_torch.data.loader import LRUImageCache


def available_decoder() -> str:
    """'cv2' when OpenCV imports, else 'png' (the stdlib reader)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "png"
    return "cv2"


def decode_image(path: str) -> np.ndarray:
    """Image file -> RGB uint8 [H, W, 3] (cv2.imread + BGR2RGB semantics),
    by the :func:`available_decoder`.  Raises ValueError for a file it
    cannot read."""
    if available_decoder() == "png":
        if not os.path.exists(path):
            raise ValueError(f"Fail to read {path}")
        return png.decode(path)
    import cv2
    img = cv2.imread(path, 1 | 128)
    if img is None:
        raise ValueError(f"Fail to read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class ImageStore:
    """get(path) -> decoded RGB uint8, memoized in RAM and (optionally) as
    raw .npy on disk.  ``stats`` counts RAM hits, disk hits and decodes,
    the seconds spent decoding, and names the decoder."""

    def __init__(self, max_bytes: int = 2 << 30,
                 disk_dir: str | None = None):
        self._lru = LRUImageCache(int(max_bytes))
        self.disk_dir = disk_dir
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
        self.stats = {"ram_hits": 0, "disk_hits": 0, "decodes": 0,
                      "decode_s": 0.0, "decoder": available_decoder()}

    def _disk_path(self, path: str) -> str:
        st = os.stat(path)
        key = f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}"
        h = hashlib.sha1(key.encode()).hexdigest()[:24]
        return os.path.join(self.disk_dir, h + ".npy")

    def get(self, path: str) -> np.ndarray:
        img = self._lru.get(path)
        if img is not None:
            self.stats["ram_hits"] += 1
            return img
        if self.disk_dir:
            dp = self._disk_path(path)
            if os.path.exists(dp):
                try:
                    img = np.load(dp)
                    self.stats["disk_hits"] += 1
                    self._lru.put(path, img)
                    return img
                except (ValueError, OSError):
                    pass                      # corrupt entry: decode again
        t0 = time.perf_counter()
        img = decode_image(path)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decodes"] += 1
        self._lru.put(path, img)
        if self.disk_dir:
            dp = self._disk_path(path)
            # name ends in .npy so np.save writes exactly this file
            tmp = dp[:-4] + f".{os.getpid()}.tmp.npy"
            try:                              # atomic publish
                np.save(tmp, img)
                os.replace(tmp, dp)
            except OSError:
                pass
        return img

    def clear_ram(self) -> None:
        """Drop the RAM tier (cold-cache measurements)."""
        self._lru = LRUImageCache(self._lru.max_bytes)
