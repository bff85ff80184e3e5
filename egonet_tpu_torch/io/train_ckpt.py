"""Exact-resume checkpoints of the full training state (counterpart of
``egonet_tpu/io/orbax_ckpt.py``, the JAX package's Orbax
``CheckpointManager``).

``HC.pth`` / ``L.pth`` carry the model's ``state_dict`` only: enough to
warm-start or to run, not to resume training exactly, since the optimizer's
moments and the step (the schedule's position) are lost.
:class:`TrainCheckpointManager` keeps the full state of a trainer's
``TrainState``: the model's ``state_dict`` (parameters, batch-norm buffers,
``num_batches_tracked``), the optimizer's ``state_dict`` (Adam's moments and
step, SGD's momentum), ``TrainState.step`` and the epoch, under
``<directory>/<step>``:

* retention: the ``max_to_keep`` newest steps are kept;
* atomic finalisation: each step is written to ``<step>.tmp``, fsynced and
  renamed, so a crash leaves no half-written step (``latest_step`` ignores
  ``.tmp`` files);
* asynchronous saves: the tensors are copied to host memory before
  ``save`` returns, and written by a background thread, so the next
  in-place optimizer step cannot reach the file; ``wait_until_finished`` /
  ``close`` drain the write;
* restore into a template (a fresh ``trainer.init_state(...)``): the
  values land on the template's devices and dtypes;
* in a process group, rank 0 writes, the ranks meet at a barrier once the
  write is finished, and every rank restores (the directory must be one
  that every rank reads).
"""

from __future__ import annotations

import os
import threading
import time

import torch

from egonet_tpu_torch.parallel import mesh


def _to_host(obj):
    """A copy of a (nested) state dict with every tensor copied to host
    memory now (a blocking copy: done when this returns)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state, epoch: int) -> dict:
    """The full state of a ``TrainState`` on the host."""
    return {"model": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "step": int(state.step), "epoch": int(epoch)}


class TrainCheckpointManager:
    """Full train-state save / restore keyed by epoch (or any integer
    step)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.async_save = bool(async_save)
        self._thread = None
        self._error = None
        # per save: {"step", "copy_s" (host copy, before save returns),
        # "write_s" (the file, on the writer), "bytes", "wait_s" (how long
        # the next save or the drain waited for the write: the part of
        # write_s that the training after the save did not hide)}
        self.saves = []

    # -- write ----------------------------------------------------------
    def save(self, step: int, state, wait: bool = False) -> None:
        """Save ``state`` (a ``TrainState``) at ``step``: the host copy is
        taken now, the file written in the background unless ``wait`` or
        ``async_save=False``."""
        self._join()
        if mesh.is_main():
            t0 = time.perf_counter()
            payload = state_payload(state, step)
            self.saves.append({"step": int(step),
                               "copy_s": time.perf_counter() - t0})
            if self.async_save and not wait:
                self._thread = threading.Thread(
                    target=self._write_caught, args=(int(step), payload),
                    name=f"ckpt-save-{step}", daemon=True)
                self._thread.start()
            else:
                self._write(int(step), payload)
        if wait or not self.async_save:
            mesh.barrier()

    def _write_caught(self, step: int, payload: dict) -> None:
        try:
            self._write(step, payload)
        except Exception as exc:  # noqa: BLE001  (re-raised on join)
            self._error = exc

    def _write(self, step: int, payload: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, str(old)))
        self.saves[-1].update(write_s=time.perf_counter() - t0,
                              bytes=os.path.getsize(final))

    def _join(self) -> None:
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self.saves[-1]["wait_s"] = time.perf_counter() - t0
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint save failed") \
                from exc

    # -- read -----------------------------------------------------------
    def all_steps(self) -> list:
        """The finalised steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None):
        """Load ``step`` (default: the latest) into ``template`` (a
        ``TrainState``: its model, optimizer and step) and return it.
        Raises FileNotFoundError when there is no step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {self.directory}")
        payload = torch.load(os.path.join(self.directory, str(int(step))),
                             map_location="cpu", weights_only=True)
        template.model.load_state_dict(payload["model"], strict=True)
        template.optimizer.load_state_dict(payload["optimizer"])
        template.step = int(payload["step"])
        return template

    # -- lifecycle ------------------------------------------------------
    def wait_until_finished(self) -> None:
        """Drain the write in flight; in a process group the ranks then
        meet, so every rank sees the step."""
        self._join()
        mesh.barrier()

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:                       # no barrier: another rank may be gone
            self._join()
        return False
