"""Byte-capped LRU cache of decoded images (copy of ``LRUImageCache`` from
``egonet_tpu/data/loader.py``; the training loader around it is not ported
yet)."""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


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
