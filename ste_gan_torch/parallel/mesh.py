"""The process group of a multi-rank run, batch slicing, and the
collectives of data parallelism.

Counterpart of ``ste_gan_tpu/parallel/mesh.py``. JAX runs one process over
a mesh of devices and lets XLA insert the collectives; PyTorch runs one
process per rank, and the port calls the collectives itself:

* :func:`init_distributed` joins the group named by the environment that
  ``python -m ste_gan_torch.parallel.launch`` and ``torchrun`` both set
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), with an explicit timeout, so a hung collective fails
  instead of waiting for ever. On ``cuda`` the rank takes card
  ``LOCAL_RANK % device_count`` and the backend defaults to ``nccl``; on
  the CPU to ``gloo``. ``backend="gloo"`` on ``cuda`` runs several ranks on
  one card (NCCL refuses more ranks than cards, and so does this module);
* :func:`shard_batch` and :func:`constrain_batch` give a rank its rows of
  a global batch (host arrays, or tensors built on the card);
* :func:`allreduce_grads_` averages a network's gradients with one
  coalesced f32 all-reduce (gloo has no ``AVG``: a sum, then a divide);
* :func:`gather_rows` and :func:`all_reduce_sum` are collectives with a
  gradient, for losses that must see the global batch;
* :func:`init_ranks` is the trainer CLIs' join (their rank-count rule is
  ``tensor_parallel.mesh_shape``), :func:`round_robin` their validation
  split (whole batches over the ranks).

Where the JAX trainer shrinks the data axis to a divisor of the global
batch (``largest_divisor_mesh_size``), the port raises: a mesh can leave a
device idle, but a launched process cannot be dropped, so a rank count
that does not divide the global batch is an error.

The train steps compute gradients with ``torch.autograd.grad`` on explicit
parameter lists, which ``DistributedDataParallel`` never sees (its reducer
hooks fire when ``.grad`` accumulates), so the gradients are all-reduced
here, explicitly, just before each AdamW launch.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ste_gan_torch.device import resolve_device
from ste_gan_torch.ops.fused_adamw import AdamWState, fused_adamw_

#: Seconds a collective may wait before the group fails (CLI default).
DEFAULT_TIMEOUT_S = 600.0

ProcessGroup = Optional["dist.ProcessGroup"]


def init_distributed(backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S, device=None,
                     init_method: Optional[str] = None
                     ) -> Tuple[int, int, ProcessGroup]:
    """Join the process group of ``RANK`` / ``WORLD_SIZE`` (defaults 0 / 1)
    and return :func:`world`. ``init_method`` defaults to ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``); ``file://<path>`` rendezvouses
    through a file. On ``cuda`` (the default device) the rank's card
    becomes the current device, so ``"cuda"`` names it from then on."""
    if dist.is_initialized():
        return world()
    rank = int(os.environ.get("RANK", "0"))
    size = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
        if backend == "nccl" and local_size > cards:
            raise ValueError(
                f"{local_size} ranks on a host with {cards} card(s): NCCL "
                f"takes one rank per card; pass backend='gloo' "
                f"(--dist_backend gloo) to share a card")
        torch.cuda.set_device(local % cards)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs device cuda")
    elif "OMP_NUM_THREADS" not in os.environ:
        # CPU ranks share the host: each takes its share of the cores
        # (all of them each makes the ranks' thread pools fight).
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_size))
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return world()


def world() -> Tuple[int, int, ProcessGroup]:
    """``(rank, size, group)`` of the default process group, or
    ``(0, 1, None)`` outside one: None means no collective at all."""
    if not dist.is_initialized():
        return 0, 1, None
    return dist.get_rank(), dist.get_world_size(), dist.group.WORLD


def init_ranks(backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device=None,
               init_method: Optional[str] = None
               ) -> Tuple[int, ProcessGroup, bool]:
    """The CLIs' join: :func:`init_distributed` when the environment names
    a group (``WORLD_SIZE``, as ``torchrun`` and the launcher set it) or
    ``init_method`` is given, else one rank without a group. Returns
    ``(rank, group, created)``; ``created`` is False when the caller had
    joined a group already (it then leaves it to the caller to destroy)."""
    created = not dist.is_initialized()
    if not created or "WORLD_SIZE" in os.environ or init_method:
        rank, _, group = init_distributed(backend, timeout_s, device,
                                          init_method)
        return rank, group, created
    return 0, None, False


def rank_and_size(group: ProcessGroup) -> Tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def barrier(group: ProcessGroup) -> None:
    if group is not None:
        dist.barrier(group=group)


def largest_divisor_mesh_size(batch_size: int, requested: int) -> int:
    """Largest mesh size <= requested that divides the global batch (the
    JAX trainer's clamp). The port does not clamp: :func:`check_divides`
    raises and names this size as the rank count to launch instead."""
    n = max(1, min(requested, batch_size))
    while batch_size % n:
        n -= 1
    return n


def check_divides(total: int, size: int, what: str) -> int:
    """``total // size``, or ValueError when ``size`` ranks cannot take
    equal shares of ``total``."""
    if total % size:
        raise ValueError(
            f"{size} ranks do not divide the {what} of {total}: every rank "
            f"takes an equal share, and a launched rank cannot be dropped "
            f"(launch a rank count that divides it, e.g. "
            f"{largest_divisor_mesh_size(total, size)})")
    return total // size


def round_robin(count: int, group: ProcessGroup) -> range:
    """The indices of ``count`` whole batches this rank evaluates: batch
    ``b`` on rank ``b % ranks``. Each batch is scored as one device scores
    it, and a sum over the ranks gives every rank the single-device
    result."""
    rank, size = rank_and_size(group)
    return range(rank, count, size)


def local_rows(total: int, rank: int, size: int) -> slice:
    """This rank's contiguous rows of ``total`` (equal shares)."""
    n = check_divides(total, size, "global batch")
    return slice(rank * n, (rank + 1) * n)


def shard_batch(batch: Dict[str, np.ndarray], rank: int, size: int,
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host batch, as tensors on ``device``
    (the CPU when None). Every leaf is sliced on its leading axis."""
    from ste_gan_torch.data.loader import to_device

    local = {k: np.asarray(v)[local_rows(len(v), rank, size)]
             for k, v in batch.items()}
    return to_device(local, resolve_device(device) if device is not None
                     else torch.device("cpu"))


def constrain_batch(batch: Dict[str, torch.Tensor], rank: int, size: int
                    ) -> Dict[str, torch.Tensor]:
    """This rank's rows (views) of a global batch already on its device,
    e.g. one the device-resident fold built."""
    return {k: v[local_rows(v.shape[0], rank, size)]
            for k, v in batch.items()}


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _views(flat: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """``flat`` cut into views shaped like ``like``, in order."""
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def replicate(tensors: Sequence[torch.Tensor], group: ProcessGroup) -> None:
    """Broadcast ``tensors`` from rank 0 in place (one coalesced call per
    dtype): every rank then holds rank 0's values."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group_tensors])
        dist.broadcast(flat, src=0, group=group)
        with torch.no_grad():
            torch._foreach_copy_(group_tensors, _views(flat, group_tensors))


def replicate_module(module: torch.nn.Module, group: ProcessGroup) -> None:
    """:func:`replicate` of a module's parameters and buffers."""
    replicate(list(module.parameters()) + list(module.buffers()), group)


def allreduce_grads_(grads: Sequence[torch.Tensor], group: ProcessGroup,
                     average: bool = True) -> List[torch.Tensor]:
    """Sum ``grads`` over the ranks in place with one f32 all-reduce of a
    flat buffer, then divide by the rank count when ``average``. Returns
    ``grads``."""
    grads = list(grads)
    if group is None:
        return grads
    flat = _flat(grads)
    dist.all_reduce(flat, group=group)
    if average:
        flat.div_(dist.get_world_size(group))
    with torch.no_grad():
        torch._foreach_copy_(grads, _views(flat, grads))
    return grads


def allreduce_metrics(metrics: Dict[str, torch.Tensor], group: ProcessGroup
                      ) -> Dict[str, torch.Tensor]:
    """One f64 all-reduce of a step's scalar metrics: ``count/*`` summed,
    every other key averaged over the ranks (each rank's loss is a mean
    over an equal share of the batch), each back in its dtype."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].double() for k in keys])
    dist.all_reduce(vec, group=group)
    size = dist.get_world_size(group)
    return {k: (vec[i] if k.startswith("count/") else vec[i] / size)
            .to(metrics[k].dtype) for i, k in enumerate(keys)}


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis; the backward returns this
    rank's rows of the incoming gradient (every rank computes the same loss
    of the gathered tensor, so no sum is needed)."""

    @staticmethod
    def forward(ctx, x, group):
        rank, size = rank_and_size(group)
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        ctx.rows = slice(rank * x.shape[0], (rank + 1) * x.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's input is the sum
    of the ranks' incoming gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Every rank's ``x`` stacked on the leading axis, in rank order, with
    a gradient to this rank's rows."""
    return x if group is None else _GatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The sum of every rank's ``x``, with a gradient."""
    return x if group is None else _AllReduceSum.apply(x, group)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GradientAllReduce:
    """The data-parallel update of a network (``update`` of
    ``train.gan.make_train_step``): gradients averaged over the ranks by
    :func:`allreduce_grads_`, then the AdamW kernel on the full tensors,
    the same on every rank. Without a group, AdamW alone.

    ``timed``: :attr:`comm_s` accumulates the all-reduces' wall time
    between two device synchronisations (off by default: the waits cost
    the host its run-ahead)."""

    def __init__(self, group: ProcessGroup, timed: bool = False):
        self.group = group
        self.timed = timed
        self.comm_s = 0.0

    def __call__(self, name: str, opt: AdamWState,
                 grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.group is not None:
            if self.timed:
                _synchronize(grads[0].device)
                t0 = time.perf_counter()
            allreduce_grads_(grads, self.group)
            if self.timed:
                _synchronize(grads[0].device)
                self.comm_s += time.perf_counter() - t0
        fused_adamw_(opt, grads)
