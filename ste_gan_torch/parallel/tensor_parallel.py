"""Tensor parallelism: a 2-D ``(data, model)`` layout of the ranks, with
every large parameter split into output-channel slabs over ``model``.

Counterpart of ``ste_gan_tpu/parallel/tensor_parallel.py``. JAX shards the
state leaves and lets GSPMD partition the unchanged step; PyTorch runs one
process per rank, so the port writes the partitioning out:

* :func:`create_mesh_2d` splits the ranks row-major, ``rank = d * model +
  m`` (model ranks adjacent, as in the JAX mesh), and returns this rank's
  data group (the ranks with its ``m``: gradients, batch rows, metrics)
  and model group (the ranks with its ``d``: slabs and activations);
* :func:`leaf_partition_spec` is the JAX rule (split the trailing axis
  when the model size divides it and it holds at least two elements per
  rank), applied to the axis of the port's layout that is JAX's trailing
  one (:func:`layout_axes`): output channels for convs, linears, biases,
  weight-norm ``g`` and norms; ``dim`` for embeddings; ``Dh`` (or ``D``
  for ``w_o``) for the attention tensors and the relative-position table.
  So the port splits the same leaves as JAX and holds the same bytes per
  rank. The spectral-norm ``u``/``v`` stay replicated (JAX's rule would
  split ``u`` where it divides; every rank here needs all of it). A
  mixture-of-experts block splits its experts over the model ranks
  instead (``expert_parallel.is_expert_param``; JAX's rule would split
  each expert's trailing axis);
* :func:`shard_module_` keeps rank ``m``'s slab of each split leaf and
  gives its layer a :class:`ModelShard`: the layer then computes only its
  output slab and :func:`gather_from_model` rebuilds the full activation,
  so every model rank runs the rest of the network, and the losses, on
  the same full tensors. :func:`shard_state` does this to both
  networks and slices both AdamW moment sets and the EMA alike;
  :func:`unshard_state` gathers a state tree back to the full,
  single-device layout (checkpoints resume at any ``(data, model)``).

The three collectives of the partitioning, each for one case:

* :func:`copy_to_model`: identity forward, sum over the model group
  backward. Before a split layer: its input is replicated, each rank's
  slab gives only part of the input's gradient;
* :func:`gather_from_model`: all-gather forward, this rank's slice of the
  gradient backward. After a split layer, and for split parameters used
  whole (LayerNorm, the relative-position table): the downstream is
  replicated, so every rank holds the whole gradient already;
* :func:`replicated_sum`: sum over the model group forward, identity
  backward. For a result every rank then uses identically (spectral
  sigma): the incoming gradient is already the same on every rank, and
  summing it again (``mesh.all_reduce_sum``, whose backward all-reduces
  because each rank's downstream differs there) would scale it by the
  model size.

Each :class:`Mesh2D` carries a :class:`CommStats` that its layers'
collectives count in (calls, bytes, and when ``timed`` their wall time
between device synchronisations).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ste_gan_torch.parallel.mesh import ProcessGroup, rank_and_size, world

__all__ = ["Mesh2D", "ModelShard", "CommStats",
           "create_mesh_2d", "mesh_shape", "leaf_partition_spec",
           "layout_axes", "state_shardings", "sharding_summary",
           "shard_module_", "shard_state", "gan_state_axes",
           "unshard_state", "gather_state_dict", "shard_batch_2d",
           "tp_state_bytes", "copy_to_model", "gather_from_model",
           "replicated_sum"]

# ---------------------------------------------------------------------------
# The 2-D layout of the ranks, and its collectives' counters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommStats:
    """The tensor-parallel collectives one layout ran: calls, bytes and,
    with ``timed``, their wall time between device synchronisations (off
    by default: the waits cost the host its run-ahead)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def run(self, fn, tensor: torch.Tensor) -> None:
        """``fn()``, a collective on ``tensor``, counted."""
        self.calls += 1
        self.bytes += tensor.numel() * tensor.element_size()
        if not self.timed:
            fn()
            return
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        t0 = time.perf_counter()
        fn()
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        self.seconds += time.perf_counter() - t0


def _run(fn, tensor: torch.Tensor, comm: Optional[CommStats]) -> None:
    if comm is None:
        fn()
    else:
        comm.run(fn, tensor)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in a ``(data, model)`` layout. A model group of
    one rank is None (no collective at all); without a model axis the data
    group is the whole group given, even of one rank."""

    world: ProcessGroup
    data: ProcessGroup
    model: ProcessGroup
    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    #: What the layers split over this layout run in collectives.
    comm: CommStats = dataclasses.field(default_factory=CommStats,
                                        compare=False)


def mesh_shape(world_size: int, data_parallel: int, model_parallel: int
               ) -> Tuple[int, int]:
    """``(data, model)`` for ``world_size`` ranks; ``data_parallel <= 0``
    takes what the model axis leaves. Raises unless data x model is the
    world: every launched rank has its place."""
    model = int(model_parallel)
    if model <= 0:
        raise ValueError("model_parallel must be positive")
    data = int(data_parallel) if int(data_parallel) > 0 else max(
        1, world_size // model)
    if data * model != world_size:
        raise ValueError(
            f"data_parallel {data} x model_parallel {model} needs "
            f"{data * model} ranks, but {world_size} rank(s) were launched "
            f"(parallel/tensor_parallel.py): launch data x model ranks "
            f"(torchrun --nproc_per_node {data * model})")
    return data, model


def create_mesh_2d(data_parallel: int, model_parallel: int,
                   group: ProcessGroup = None) -> Mesh2D:
    """This rank's :class:`Mesh2D` over ``group`` (the default group when
    None). Every rank creates every sub-group, in the same order (model
    groups, then data groups), as ``dist.new_group`` requires."""
    if group is None:
        _, _, group = world()
    rank, size = rank_and_size(group)
    data, model = mesh_shape(size, data_parallel, model_parallel)
    d, m = divmod(rank, model)
    members = (dist.get_process_group_ranks(group) if group is not None
               else [0])
    if model == 1:
        # Pure data parallelism: the group itself (even of one rank: the
        # data-parallel wrappers then still run their collectives).
        return Mesh2D(group, group, None, d, data, 0, 1)
    model_group = data_group = None
    for dd in range(data):
        g = dist.new_group([members[dd * model + i] for i in range(model)])
        if dd == d:
            model_group = g
    if data > 1:
        for mm in range(model):
            g = dist.new_group([members[i * model + mm] for i in range(data)])
            if mm == m:
                data_group = g
    return Mesh2D(group, data_group, model_group, d, data, m, model)


def shard_batch_2d(batch: Dict[str, np.ndarray], mesh: Mesh2D,
                   device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host batch: split over ``data`` only,
    every model rank of a data rank sees the same rows."""
    from ste_gan_torch.parallel.mesh import shard_batch

    return shard_batch(batch, mesh.data_rank, mesh.data_size, device)


# ---------------------------------------------------------------------------
# Collectives of the partitioning
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group, comm=None) -> torch.Tensor:
    _run(lambda: dist.all_reduce(x, group=group), x, comm)
    return x


def _all_gather(x: torch.Tensor, dim: int, group, comm=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim``, in rank order."""
    _, size = rank_and_size(group)
    x = x.contiguous()
    flat = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _run(lambda: dist.all_gather_into_tensor(flat, x, group=group), flat,
         comm)
    if dim == 0:
        return flat
    parts = flat.view((size,) + tuple(x.shape))
    return parts.movedim(0, dim).flatten(dim, dim + 1).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, x, group, comm):
        ctx.group, ctx.comm = group, comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (_all_reduce(grad.contiguous().clone(), ctx.group, ctx.comm),
                None, None)


class _GatherFromModel(torch.autograd.Function):
    """All-gather on ``dim`` forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, dim, group, comm):
        rank, _ = rank_and_size(group)
        dim = dim % x.dim()
        ctx.slab = (dim, rank * x.shape[dim], x.shape[dim])
        return _all_gather(x, dim, group, comm)

    @staticmethod
    def backward(ctx, grad):
        dim, start, n = ctx.slab
        return grad.narrow(dim, start, n).contiguous(), None, None, None


class _ReplicatedSum(torch.autograd.Function):
    """Sum over the model ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group, comm):
        return _all_reduce(x.clone(), group, comm)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_model(x: torch.Tensor, group: ProcessGroup,
                  comm: Optional[CommStats] = None) -> torch.Tensor:
    """``x`` as the input of a split layer: the forward is the identity,
    the backward sums the ranks' partial input gradients (each rank's
    slab of outputs contributes part of it). ``comm`` counts it."""
    return x if group is None else _CopyToModel.apply(x, group, comm)


def gather_from_model(x: torch.Tensor, dim: int, group: ProcessGroup,
                      comm: Optional[CommStats] = None) -> torch.Tensor:
    """Every model rank's slab of ``x`` concatenated on ``dim``. The
    backward keeps this rank's slice of the gradient: for a replicated
    downstream, whose gradient every rank holds whole. ``comm`` counts
    it."""
    return x if group is None else _GatherFromModel.apply(x, dim, group,
                                                          comm)


def replicated_sum(x: torch.Tensor, group: ProcessGroup,
                   comm: Optional[CommStats] = None) -> torch.Tensor:
    """The sum of the model ranks' ``x`` for a result every rank then uses
    identically (a spectral sigma, a norm): the backward is the identity,
    since the incoming gradient is already the same on every rank.
    ``comm`` counts it."""
    return x if group is None else _ReplicatedSum.apply(x, group, comm)


# ---------------------------------------------------------------------------
# The partition rule
# ---------------------------------------------------------------------------


def leaf_partition_spec(shape: Sequence[int], axis: Optional[int],
                        model_size: int) -> Optional[int]:
    """The JAX rule on one leaf: split its trailing axis, which is
    ``axis`` in the port's layout, when ``model_size`` divides it and it
    holds at least two elements per rank; else replicate (None). Leaves
    with no such axis (scalars, the spectral vectors) replicate."""
    if axis is None or not len(shape):
        return None
    n = int(shape[axis])
    if n % model_size or n < 2 * model_size:
        return None
    return axis


def _direct_axes(sub: nn.Module) -> Dict[str, Optional[int]]:
    """For the leaves a module holds itself, the axis of the port's layout
    that is the JAX leaf's trailing one (None: no JAX counterpart, or
    replicated by design)."""
    from ste_gan_torch.models.moe import MoEFeedForward
    from ste_gan_torch.models.transformer import (
        MultiHeadAttention, RelativePositionalLogits)
    from ste_gan_torch.ops.conv import SNConv, _ConvBase

    out: Dict[str, Optional[int]] = {}
    leaves = list(sub.named_parameters(recurse=False)) + list(
        sub.named_buffers(recurse=False))
    for name, t in leaves:
        if isinstance(sub, SNConv) and name in ("weight_u", "weight_v"):
            axis = None
        elif isinstance(sub, (_ConvBase, nn.Linear, nn.LayerNorm,
                              nn.BatchNorm1d)):
            axis = None if name == "num_batches_tracked" else 0
        elif isinstance(sub, nn.Embedding):
            axis = 1
        elif isinstance(sub, (MultiHeadAttention, RelativePositionalLogits)):
            axis = 2
        elif isinstance(sub, MoEFeedForward):
            axis = 0  # the expert axis (``state_shardings``)
        else:
            raise ValueError(f"no tensor-parallel layout for "
                             f"{type(sub).__name__}.{name}")
        out[name] = axis
    return out


def layout_axes(module: nn.Module) -> Dict[str, Optional[int]]:
    """For every ``state_dict`` key of ``module``, the axis that is JAX's
    trailing one (see :func:`_direct_axes`)."""
    out: Dict[str, Optional[int]] = {}
    for prefix, sub in module.named_modules():
        for name, axis in _direct_axes(sub).items():
            out[f"{prefix}.{name}" if prefix else name] = axis
    return out


def state_shardings(module: nn.Module, model_size: int
                    ) -> Dict[str, Optional[int]]:
    """``state_dict`` key -> split axis (None: replicated) of a module
    holding its FULL tensors, under :func:`leaf_partition_spec`; the leaves
    of a mixture-of-experts block under the expert rule instead
    (``expert_parallel.is_expert_param``: its experts split over the model
    ranks, the router whole)."""
    from ste_gan_torch.parallel.expert_parallel import is_expert_param

    sd = module.state_dict()
    out = {}
    for k, axis in layout_axes(module).items():
        if "moe_ffn" in k.split("."):
            out[k] = 0 if is_expert_param(k, sd[k], model_size) else None
        else:
            out[k] = leaf_partition_spec(sd[k].shape, axis, model_size)
    return out


def sharding_summary(module: nn.Module, model_size: int
                     ) -> Tuple[int, int, int]:
    """``(sharded, replicated, leaves)`` parameter counts of a full module
    under the rule, as JAX's ``sharding_summary`` counts its parameter
    tree."""
    specs = state_shardings(module, model_size)
    sharded = replicated = leaves = 0
    for name, p in module.named_parameters():
        leaves += 1
        if specs[name] is None:
            replicated += p.numel()
        else:
            sharded += p.numel()
    return sharded, replicated, leaves


def _slab(t: torch.Tensor, axis: Optional[int], rank: int, size: int
          ) -> torch.Tensor:
    if axis is None:
        return t
    n = t.shape[axis] // size
    return t.narrow(axis, rank * n, n)


@dataclasses.dataclass
class ModelShard:
    """The tensor-parallel context of one layer whose leaves are split:
    the model group and this rank's place in it; for a conv, the input
    channels its slab reads (None: all) and its group count."""

    group: ProcessGroup
    rank: int
    size: int
    in_slice: Optional[slice] = None
    groups: int = 1
    #: Names of the layer's own leaves that are split.
    split: frozenset = frozenset()
    #: The layout's counters (``Mesh2D.comm``).
    comm: Optional[CommStats] = None


def _conv_shard(conv, mesh: Mesh2D, split: frozenset) -> ModelShard:
    """A conv's slab geometry: ``groups % size == 0`` keeps
    ``groups / size`` whole groups and their input channels; a slab inside
    one group (``size % groups == 0``) reads that group's inputs at
    ``groups == 1``."""
    g, cin = conv.groups, conv.in_channels
    rank, size = mesh.model_rank, mesh.model_size

    def shard(in_slice, groups):
        return ModelShard(mesh.model, rank, size, in_slice, groups, split,
                          mesh.comm)

    if g == 1:
        return shard(None, 1)
    if g % size == 0:
        n = cin // size
        return shard(slice(rank * n, (rank + 1) * n), g // size)
    if size % g == 0:
        gi = rank // (size // g)
        n = cin // g
        return shard(slice(gi * n, (gi + 1) * n), 1)
    raise NotImplementedError(
        f"a conv of {g} groups over {size} model ranks: slabs that cut "
        f"groups unevenly are not supported")


def shard_module_(module: nn.Module, mesh: Mesh2D
                  ) -> Dict[str, Optional[int]]:
    """Keep rank ``mesh.model_rank``'s slab of every leaf the rule splits,
    in place (new contiguous tensors behind the same ``Parameter``s), and
    give each layer that holds one its :class:`ModelShard` (``layer.tp``).
    Returns the rule's axes by ``state_dict`` key (also kept as
    ``module.tp_axes``). A model size of 1 changes nothing."""
    if mesh.model_size == 1:
        axes = {k: None for k in module.state_dict()}
        module.tp_axes = axes
        return axes
    from ste_gan_torch.ops.conv import _ConvBase

    axes = state_shardings(module, mesh.model_size)
    rank, size = mesh.model_rank, mesh.model_size
    for prefix, sub in module.named_modules():
        split = set()
        leaves = list(sub.named_parameters(recurse=False)) + list(
            sub.named_buffers(recurse=False))
        for name, t in leaves:
            axis = axes[f"{prefix}.{name}" if prefix else name]
            if axis is None:
                continue
            split.add(name)
            with torch.no_grad():
                t.data = _slab(t.data, axis, rank, size).clone()
        if split:
            split = frozenset(split)
            sub.tp = (_conv_shard(sub, mesh, split)
                      if isinstance(sub, _ConvBase)
                      else ModelShard(mesh.model, rank, size, split=split,
                                      comm=mesh.comm))
    module.tp_axes = axes
    return axes


def _param_axes(module: nn.Module) -> List[Optional[int]]:
    axes = getattr(module, "tp_axes", None) or {}
    return [axes.get(n) for n, _ in module.named_parameters()]


def shard_state(models, state, mesh: Mesh2D) -> None:
    """Slice the generator and the discriminator (:func:`shard_module_`),
    both AdamW moment sets and the EMA to this model rank's slabs, in
    place, from the full (single-device) state. The optimizer states are
    rebuilt over the sliced parameters (the kernel's tables hold their
    addresses); the frozen encoder stays replicated. Call after any
    restore of a full checkpoint."""
    from ste_gan_torch.ops.fused_adamw import adamw_state

    rank, size = mesh.model_rank, mesh.model_size
    for net, name in ((models.generator, "opt_g"),
                      (models.discriminator, "opt_d")):
        opt = getattr(state, name)
        shard_module_(net, mesh)
        axes = _param_axes(net)

        def cut(ts):
            return [_slab(t, a, rank, size).clone() for t, a in zip(ts, axes)]

        setattr(state, name, adamw_state(list(net.parameters()),
                                         cut(opt.exp_avg),
                                         cut(opt.exp_avg_sq), opt.hyper,
                                         opt.count))
        if name == "opt_g" and state.gen_ema is not None:
            state.gen_ema = cut(state.gen_ema)


def gan_state_axes(models) -> Dict[str, Any]:
    """The split axis of every leaf of ``train.gan.state_tree`` (the same
    structure; None: replicated), after :func:`shard_state`."""
    g = _param_axes(models.generator)
    d = _param_axes(models.discriminator)
    return {"step": None,
            "generator": dict(getattr(models.generator, "tp_axes", {})),
            "discriminator": dict(getattr(models.discriminator, "tp_axes",
                                          {})),
            "opt_g": {"exp_avg": g, "exp_avg_sq": g, "count": None,
                      "hyper": None},
            "opt_d": {"exp_avg": d, "exp_avg_sq": d, "count": None,
                      "hyper": None},
            "gen_ema": g}


def _gather_leaf(t, axis, mesh: Mesh2D):
    if axis is None or mesh.model is None or not isinstance(t, torch.Tensor):
        return t
    with torch.no_grad():
        return _all_gather(t.detach(), axis, mesh.model)


def unshard_state(tree: Any, axes: Any, mesh: Mesh2D) -> Any:
    """``tree`` (this rank's slabs) with every split leaf gathered over the
    model group: the full, single-device layout. A collective: every rank
    calls it, in the same order."""
    if isinstance(tree, dict):
        return {k: unshard_state(v, (axes or {}).get(k), mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        axes = axes if isinstance(axes, (list, tuple)) else [axes] * len(tree)
        return [unshard_state(v, a, mesh) for v, a in zip(tree, axes)]
    return _gather_leaf(tree, axes, mesh)


def gather_state_dict(module: nn.Module, mesh: Mesh2D,
                      state_dict: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict of a module split by :func:`shard_module_`
    (``state_dict``: one laid out like it, e.g. a snapshot), gathered over
    the model group. A collective."""
    sd = module.state_dict() if state_dict is None else state_dict
    axes = getattr(module, "tp_axes", None) or {}
    return {k: _gather_leaf(v, axes.get(k), mesh).detach().clone()
            for k, v in sd.items()}


def tp_state_bytes(models, state) -> int:
    """Bytes of GAN train state this rank holds between steps: its slabs
    of parameters, both moment sets and the EMA, and the buffers."""
    tensors = list(models.generator.parameters()) + list(
        models.discriminator.parameters())
    for opt in (state.opt_g, state.opt_d):
        tensors += list(opt.exp_avg) + list(opt.exp_avg_sq)
    tensors += list(state.gen_ema or [])
    tensors += list(models.generator.buffers()) + list(
        models.discriminator.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)
