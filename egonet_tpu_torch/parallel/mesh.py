"""Data parallelism over several cards (port of
``egonet_tpu/parallel/mesh.py``).

The workload's one parallel axis is the instance-crop batch.  The JAX
package shards it over a 1-D ``data`` mesh and lets XLA insert the
collectives; the port has two counterparts:

* :class:`DataMesh`, an ordered list of devices that ONE process shards a
  batch's instance rows over (sharded inference and serving,
  ``EgoNet(mesh=...)``).  It may name a device more than once: that runs
  the sharded path on one card, shard after shard.
* ``torch.distributed``, one process per card (``torchrun``), for the
  data-parallel trainers: :func:`init_from_env` joins the group; the
  trainers split each node's batch over its ranks, batch norm and the loss
  normalisers reduce over every rank (``models/layers.batch_norm``,
  ``train/losses``), and gradients are summed.

``pad_instance_batch`` is the JAX package's: the instance axis padded to a
multiple of the shard count by wrapping real rows (train-mode batch norm
sees every slot), ``mask`` / ``sup_mask`` padded with zeros.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_instance_batch(batch: dict, multiple: int,
                       replicated_keys=("images",),
                       mask_keys=("mask", "sup_mask")) -> dict:
    """Pad the leading (instance) axis of every sharded batch array to a
    multiple of ``multiple``.  Content rows wrap real rows; ``mask_keys``
    rows are zeros, so the duplicates stay out of the loss and metrics.
    ``replicated_keys`` and ``meta`` are kept as they are."""
    sizes = {v.shape[0] for k, v in batch.items()
             if k not in replicated_keys and k != "meta"}
    if not sizes:
        return batch
    if len(sizes) != 1:
        raise ValueError(f"inconsistent instance axes: {sizes}")
    n = sizes.pop()
    target = pad_to_multiple(n, multiple)
    if target == n:
        return batch
    wrap = np.arange(n, target) % n
    out = {}
    for k, v in batch.items():
        if k in replicated_keys or k == "meta":
            out[k] = v
        elif k in mask_keys:
            pad_width = [(0, target - n)] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(v, pad_width)
        else:
            out[k] = np.concatenate([v, v[wrap]])
    return out


def shard_bounds(n: int, shards: int) -> list:
    """Equal contiguous row ranges [(start, stop), ...] of ``n`` rows
    (``n`` a multiple of ``shards``)."""
    if n % shards:
        raise ValueError(f"{n} rows do not split into {shards} equal shards")
    k = n // shards
    return [(i * k, (i + 1) * k) for i in range(shards)]


class DataMesh:
    """The devices one process shards a batch's instance rows over, in
    order.  Shard ``i`` runs on ``devices[i]``; a device named twice runs
    two shards."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh takes one device type: {self.devices}")

    def __len__(self):
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def distinct(self) -> list:
        """The mesh's devices without repeats, in first-use order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"DataMesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None) -> DataMesh:
    """The first ``n_devices`` cards (all visible cards by default); raises
    when fewer are visible.  Never repeats a card and never falls back to
    the CPU."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if n_devices is None else int(n_devices)
    if n < 1 or n > avail:
        raise ValueError(f"a mesh of {n} card(s) was asked for and "
                         f"{avail} CUDA device(s) are visible")
    return DataMesh([torch.device("cuda", i) for i in range(n)])


# ---------------------------------------------------------------------------
# the process group (one process per card, torchrun)
# ---------------------------------------------------------------------------

def init_from_env(backend: str | None = None, device: str | None = None):
    """Join the default process group from torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` (and
    ``MASTER_ADDR`` / ``MASTER_PORT``).  On CUDA the process's card is
    ``cuda:LOCAL_RANK``, made current before anything resolves the default
    device.  The backend is nccl on CUDA and gloo on the CPU unless
    ``backend`` names one.  Returns the process's device."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the data-parallel run; "
                               "pass device='cpu' to run it on the CPU")
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dev


_SOLO = [0]


@contextlib.contextmanager
def solo():
    """Run this process as if it were alone (no collective, no sharding):
    how a rank computes a single-process reference of a step inside a
    data-parallel run.  Process-wide, threads included."""
    _SOLO[0] += 1
    try:
        yield
    finally:
        _SOLO[0] -= 1


def active() -> bool:
    """True when a process group of more than one rank is in use (and not
    inside :func:`solo`)."""
    return not _SOLO[0] and dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def local_world() -> int:
    """Ranks on this node (``LOCAL_WORLD_SIZE``; every rank without it)."""
    if not active():
        return 1
    n = int(os.environ.get("LOCAL_WORLD_SIZE", world()))
    if n < 1 or world() % n:
        raise ValueError(f"LOCAL_WORLD_SIZE {n} does not divide the world "
                         f"size {world()}")
    return n


def local_rank() -> int:
    return rank() % local_world()


def node() -> tuple:
    """(this node's index, the number of nodes): (0, 1) without a group."""
    return rank() // local_world(), world() // local_world()


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if active():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' output gradients
    (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, differentiable (the gradient of
    each rank's input is the sum of the ranks' output gradients); ``t``
    itself without a group."""
    if not active():
        return t
    return _AllReduceSum.apply(t)


def all_reduce_count(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, outside autograd (a count)."""
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def shard_batch(batch: dict, replicated_keys=("images",)) -> dict:
    """This rank's part of its node's host batch: the batch padded to a
    multiple of the node's ranks (:func:`pad_instance_batch`) and this
    rank's contiguous rows of the instance axis (the JAX mesh's
    ``P('data')`` split), with ``replicated_keys`` and ``meta`` whole and
    ``shard`` = (start, stop, rows of the padded node batch).  Without a
    group, or for a batch already on a device, the batch itself."""
    if not active() or isinstance(batch.get("mask"), torch.Tensor):
        return batch
    lw = local_world()
    padded = pad_instance_batch(batch, lw, replicated_keys=replicated_keys)
    n = len(padded["mask"])
    start, stop = shard_bounds(n, lw)[local_rank()]
    out = {k: (v if k in replicated_keys or k == "meta" else v[start:stop])
           for k, v in padded.items()}
    out["shard"] = (start, stop, n)
    return out


def global_rows(shard) -> tuple:
    """(first row, rows) of a :func:`shard_batch` shard in the global batch,
    every node's padded batch in node order: ranks are numbered node-major,
    so the shard of rank r starts at r x its rows."""
    start, stop, _ = shard
    k = stop - start
    return rank() * k, world() * k


def all_reduce_values(values: dict) -> dict:
    """{name: detached scalar}, each summed over the ranks in one
    collective: the global batch's loss and components from the ranks'
    shares.  Without a group, the values detached."""
    values = {k: v.detach() for k, v in values.items()}
    if not active():
        return values
    total = all_reduce_count(torch.stack(list(values.values())))
    return dict(zip(values, total.unbind()))


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer with rank ``src``'s."""
    if not active():
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)


def all_reduce_grads(params) -> None:
    """Sum the gradients of ``params`` over every rank, in one collective
    per dtype (parameters without a gradient are left out on every rank
    alike: they are the frozen ones)."""
    if not active():
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()


# ---------------------------------------------------------------------------
# local ranks without torchrun (the tests and the smoke run)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(fn, args, rank_, world_, local_world_, port, backend,
               device, threads):
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world_),
                      LOCAL_RANK=str(rank_ % local_world_),
                      LOCAL_WORLD_SIZE=str(local_world_),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    init_from_env(backend, device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, args=(), backend: str = "gloo",
              device: str = "cpu", local_world_size: int | None = None,
              timeout_s: float = 600.0) -> None:
    """Run ``fn(*args)`` in ``nprocs`` spawned processes joined in one
    process group (ranks 0..nprocs-1 on this host, ``local_world_size``
    ranks to a node: all of them by default), each on ``device``
    (``"cuda"``: the card of its local rank; ``"cuda:0"``: that card for
    every rank).  ``fn`` must be importable by its module path.  The
    caller's intra-op threads are shared out between the ranks.  Raises
    if a rank fails or the run outlasts ``timeout_s`` (every process is
    stopped first)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    lw = nprocs if local_world_size is None else int(local_world_size)
    threads = max(1, torch.get_num_threads() // nprocs)
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(fn, args, r, nprocs, lw, port, backend,
                               device, threads))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        late = time.monotonic() > deadline
        raise RuntimeError(f"ranks exited with codes {codes}"
                           + (f" after the {timeout_s:.0f} s limit"
                              if late else ""))
