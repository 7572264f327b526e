"""Expert parallelism: the experts of every mixture-of-experts block split
over an ``expert`` axis of the ranks.

Counterpart of ``ste_gan_tpu/parallel/expert_parallel.py``. JAX shards the
expert-stacked leaves ``[E, ...]`` of the ``moe_ffn`` blocks on their
leading axis and lets GSPMD partition the unchanged program. PyTorch runs
one process per rank, so the port writes the partitioning out:

* :func:`create_expert_mesh` lays the ranks out as ``(data, expert)``,
  expert ranks adjacent (``rank = d * expert + p``), as JAX's
  ``reshape(data, expert)`` does; it is ``tensor_parallel.create_mesh_2d``
  with the expert axis in the model axis' place (``Mesh2D.model`` is the
  expert group);
* :func:`is_expert_param` is JAX's ``_is_expert_leaf`` on the port's
  module paths: a leaf under ``moe_ffn`` with two or more dimensions whose
  leading (expert) dimension the expert axis divides, never the router;
* :func:`shard_moe_module_` keeps expert rank ``p``'s ``E / P`` experts of
  ``w1``, ``b1``, ``w2`` and ``b2`` (an indivisible leaf stays whole, as
  in JAX) and gives the block its shard (``block.tp``). The AdamW moments
  follow, since the optimizer is built over the kept slabs, as
  ``moe_state_shardings`` gives JAX's moments the parameters' shardings.

The forward of a split block (``models/moe.py``) is what GSPMD makes of the
JAX program here: the tokens stay sharded over ``data`` and replicated over
``expert``; each rank routes its data shard's tokens with the capacity and
token dropping of the whole batch, runs its own experts on the picks
routed to them, and the combine is summed over the expert group. An
all-to-all dispatch would move only the routed tokens; it is queued
(``ROADMAP.md``), not written.

Under ``--model_parallel`` the encoder trainer splits an MoE block's
experts over the model axis by the same rule (``tensor_parallel``'s
``state_shardings``), and the dense layers by the tensor-parallel rule.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ste_gan_torch.parallel.mesh import ProcessGroup
from ste_gan_torch.parallel.tensor_parallel import (
    Mesh2D, ModelShard, create_mesh_2d)

__all__ = ["EXPERT_AXIS", "create_expert_mesh", "is_expert_param",
           "moe_state_shardings", "shard_moe_module_"]

EXPERT_AXIS = "expert"
#: The module name of an MoE block (``models/transformer.py``); the rule
#: keys on it, so an unrelated leaf with a matching leading dimension is
#: never split by accident.
_MOE_SCOPE = "moe_ffn"


def create_expert_mesh(data_parallel: int, expert_parallel: int,
                       group: ProcessGroup = None) -> Mesh2D:
    """This rank's ``(data, expert)`` layout over ``group`` (the default
    group when None). ``data_parallel <= 0`` takes what the expert axis
    leaves; data x expert must be the ranks of ``group`` (a launched rank
    cannot be left out). ``Mesh2D.model`` is the expert group."""
    if int(expert_parallel) <= 0:
        raise ValueError("expert_parallel must be positive")
    return create_mesh_2d(data_parallel, expert_parallel, group)


def is_expert_param(name: str, tensor: torch.Tensor, expert_size: int
                    ) -> bool:
    """JAX's rule on one leaf of the port's state dict: under a
    ``moe_ffn`` module, two or more dimensions, the leading one divisible
    by ``expert_size``, and not the router (``[D, E]``: token-side, its
    leading dimension is ``D``)."""
    shape = tuple(tensor.shape)
    if len(shape) < 2 or shape[0] % expert_size:
        return False
    parts = name.split(".")
    if parts[-1] == "router":
        return False
    return any(_MOE_SCOPE in p for p in parts)


def moe_state_shardings(module: nn.Module, expert_size: int
                        ) -> Dict[str, Optional[int]]:
    """``state_dict`` key -> split axis (0) or None (replicated) of a
    module holding its full tensors. The AdamW moments of a parameter
    follow it."""
    return {k: (0 if is_expert_param(k, v, expert_size) else None)
            for k, v in module.state_dict().items()}


def shard_moe_module_(module: nn.Module, layout: Mesh2D
                      ) -> Dict[str, Optional[int]]:
    """Keep expert rank ``layout.model_rank``'s experts of every leaf
    :func:`is_expert_param` selects, in place (new contiguous tensors
    behind the same ``Parameter``s), and give each block with a split leaf
    its shard (``block.tp``, whose group is the expert group). Returns the
    axes by ``state_dict`` key, also kept as ``module.tp_axes``, so
    ``tensor_parallel.gather_state_dict`` rebuilds the full state dict. An
    expert size of 1 changes nothing."""
    from ste_gan_torch.models.moe import MoEFeedForward

    size, rank = layout.model_size, layout.model_rank
    axes = (moe_state_shardings(module, size) if size > 1
            else {k: None for k in module.state_dict()})
    for prefix, sub in module.named_modules():
        if size == 1 or not isinstance(sub, MoEFeedForward):
            continue
        split = set()
        for name, p in sub.named_parameters(recurse=False):
            if axes[f"{prefix}.{name}" if prefix else name] is None:
                continue
            n = p.shape[0] // size
            with torch.no_grad():
                p.data = p.data[rank * n:(rank + 1) * n].clone()
            split.add(name)
        if split:
            sub.tp = ModelShard(layout.model, rank, size,
                                split=frozenset(split), comm=layout.comm)
    module.tp_axes = axes
    return axes
