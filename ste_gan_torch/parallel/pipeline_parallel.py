"""Pipeline parallelism: GPipe-style staged execution of the encoder's
transformer stack over a ``stage`` axis of the ranks.

Counterpart of ``ste_gan_tpu/parallel/pipeline_parallel.py``. The JAX
module stacks the layers' parameters on a leading axis, shards it over
``stage`` and runs one ``lax.scan`` of ``M + S - 1`` ticks inside
``shard_map``: stage 0 injects microbatch ``t``, a single-hop ``ppermute``
ring passes each result on, stage ``S-1`` banks microbatch ``t - (S-1)``
and a ``psum`` replicates the output; ``jax.grad`` derives the reverse
schedule. Autograd stops at a process boundary, so the port writes the
GPipe schedule both ways (:class:`_Pipeline`):

* forward: stage ``s`` takes microbatch ``i`` from stage ``s - 1`` (stage
  0 from its input), applies its layers with autograd on, keeps that
  microbatch's local graph and sends the result to stage ``s + 1``; the
  last stage's results are broadcast over the stage group, so the output
  is replicated as JAX's ``psum`` makes it. The ring's wrap-around
  (``S-1 -> 0``), which carries nothing stage 0 reads, is not sent;
* backward, the reverse ticks: only the last stage's cotangent enters the
  ring (every stage rank computes the same downstream of the replicated
  output, and counting each would scale the gradients by ``S``); stage
  ``s`` receives its output's gradient from stage ``s + 1``, back-propagates
  the microbatch through its own layers (``torch.autograd.grad``) and
  sends the input's gradient to stage ``s - 1``. It returns the gradients
  of its own parameters and, on stage 0, of the input.

Sends are ``isend``, receives blocking: the chain has no cycle, so no
order deadlocks at any ``S``. gloo's send and receive move host memory, so
over gloo the activations travel through host copies. :class:`StageMesh`
counts the messages, their bytes and (``comm.timed``) the wall time of the
sends and receives, waits included.

Names: ``STAGE_AXIS``, ``create_stage_mesh``, ``create_stage_mesh_2d`` and
``pipeline_apply`` are JAX's. JAX's stacked pytrees have no counterpart:
each rank's stage is its slice of the module list, :func:`stage_layers`
(for ``stack_stage_params`` and ``encoder_transformer_params``), applied
in order by the ``stage_fn`` the caller gives (for
``transformer_stack_layer_fn``). :func:`shard_stages_` frees the layers a
rank does not own, so each rank holds its own layers' weights (and AdamW
moments) and the replicated frontend and heads;
:func:`gather_stage_state_dict` rebuilds the full reference-layout state
dict for a checkpoint.

The layout is ``(data, stage)``, stage ranks adjacent (``rank = d * S +
s``, JAX's ``reshape(data, stages)``): a data rank pipelines its slice of
every microbatch (:func:`microbatch_rows`) and ``pipeline_apply`` gathers
the slices back (:func:`gather_microbatch_rows`). Gradients of replicated
parameters are summed over the data group and then the stage group (the
frontend's are non-zero on stage 0, the heads' on the last stage, after
:func:`last_stage_only`), a stage's own layers' over the data group
(:func:`allreduce_stage_grads_`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ste_gan_torch.parallel import mesh as mesh_lib
from ste_gan_torch.parallel.mesh import ProcessGroup, rank_and_size, world
from ste_gan_torch.parallel.tensor_parallel import CommStats

__all__ = ["STAGE_AXIS", "StageMesh", "create_stage_mesh",
           "create_stage_mesh_2d", "pipeline_apply", "pipeline_local",
           "microbatch_rows", "gather_microbatch_rows", "stage_range",
           "stage_layers",
           "shard_stages_", "stage_parameters", "gather_stage_state_dict",
           "last_stage_only", "allreduce_stage_grads_", "sum_over_stages_"]

STAGE_AXIS = "stage"


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """This rank's place in a ``(data, stage)`` layout. ``stage``: the
    ranks of this data index, in stage order (``peers``, global ranks);
    ``data``: the ranks of this stage. A group of one rank is None."""

    world: ProcessGroup
    data: ProcessGroup
    stage: ProcessGroup
    data_rank: int = 0
    data_size: int = 1
    stage_rank: int = 0
    num_stages: int = 1
    peers: Tuple[int, ...] = (0,)
    #: The point-to-point messages and the output broadcast.
    comm: CommStats = dataclasses.field(default_factory=CommStats,
                                        compare=False)

    @property
    def is_last(self) -> bool:
        return self.stage_rank == self.num_stages - 1


def create_stage_mesh(num_stages: int, group: ProcessGroup = None
                      ) -> StageMesh:
    """1-D ``stage`` layout over the ranks of ``group`` (the default group
    when None), which must number ``num_stages``."""
    return create_stage_mesh_2d(1, num_stages, group)


def create_stage_mesh_2d(data_parallel: int, num_stages: int,
                         group: ProcessGroup = None) -> StageMesh:
    """2-D ``(data, stage)`` layout: each of ``data_parallel`` replicas runs
    the ``num_stages``-deep pipeline on its slice of every microbatch.
    Every launched rank has its place, so data x stages must be the ranks
    of ``group``. Every rank creates every sub-group, in one order (stage
    groups, then data groups), as ``dist.new_group`` requires."""
    if group is None:
        _, _, group = world()
    rank, size = rank_and_size(group)
    data, stages = int(data_parallel), int(num_stages)
    if stages <= 0 or data <= 0:
        raise ValueError("data_parallel and num_stages must be positive")
    if data * stages != size:
        raise ValueError(
            f"requested {data * stages} ranks ({data} x {stages} stages), "
            f"but {size} rank(s) were launched (parallel/pipeline_parallel"
            f".py): launch data x stages ranks")
    d, s = divmod(rank, stages)
    members = (dist.get_process_group_ranks(group) if group is not None
               else [0])
    stage_group = data_group = None
    if stages > 1:
        for dd in range(data):
            g = dist.new_group([members[dd * stages + i]
                                for i in range(stages)])
            if dd == d:
                stage_group = g
    if data > 1:
        for ss in range(stages):
            g = dist.new_group([members[i * stages + ss]
                                for i in range(data)])
            if ss == s:
                data_group = g
    peers = tuple(members[d * stages + i] for i in range(stages))
    return StageMesh(group, data_group, stage_group, d, data, s, stages,
                     peers)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def _host_path(mesh: StageMesh) -> bool:
    return dist.get_backend(mesh.stage) == "gloo"


def _timed(mesh: StageMesh, fn, device) -> None:
    if not mesh.comm.timed:
        fn()
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    mesh.comm.seconds += time.perf_counter() - t0


def _send(x: torch.Tensor, dst: int, mesh: StageMesh, pending: list) -> None:
    """``isend`` of ``x`` to global rank ``dst``; the buffer and the work
    go to ``pending`` (kept alive until waited)."""
    buf = x.detach().contiguous()
    if _host_path(mesh):
        buf = buf.cpu()
    mesh.comm.calls += 1
    mesh.comm.bytes += buf.numel() * buf.element_size()
    _timed(mesh, lambda: pending.append(
        (dist.isend(buf, dst, group=mesh.stage), buf)), x.device)


def _recv(like: torch.Tensor, src: int, mesh: StageMesh) -> torch.Tensor:
    """A tensor shaped like ``like`` from global rank ``src``."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _host_path(mesh) else like.device)
    _timed(mesh, lambda: dist.recv(buf, src, group=mesh.stage), like.device)
    return buf.to(like.device)


def _wait(pending: list) -> None:
    for work, _ in pending:
        work.wait()
    pending.clear()


class _Pipeline(torch.autograd.Function):
    """The GPipe ticks over the stage group (module docstring)."""

    @staticmethod
    def forward(ctx, stage_fn, mesh, m, grad, x, *params):
        s, last = mesh.stage_rank, mesh.num_stages - 1
        chunks = x.chunk(m)
        graphs, pending = [], []
        with torch.set_grad_enabled(grad):
            for i in range(m):
                if s == 0:
                    inp = chunks[i].detach().requires_grad_(
                        grad and ctx.needs_input_grad[4])
                else:
                    inp = _recv(chunks[i], mesh.peers[s - 1],
                                mesh).requires_grad_(grad)
                y = stage_fn(inp, i)
                graphs.append((inp, y))
                if s < last:
                    _send(y, mesh.peers[s + 1], mesh, pending)
        _wait(pending)
        out = (torch.cat([y.detach() for _, y in graphs]) if s == last
               else torch.empty_like(x))
        if mesh.stage is not None:
            mesh.comm.calls += 1
            mesh.comm.bytes += out.numel() * out.element_size()
            _timed(mesh, lambda: dist.broadcast(out, mesh.peers[last],
                                                group=mesh.stage), x.device)
        ctx.graphs, ctx.mesh, ctx.m = graphs, mesh, m
        ctx.params = params
        return out

    @staticmethod
    def backward(ctx, grad_out):
        mesh, graphs, params = ctx.mesh, ctx.graphs, ctx.params
        s, last = mesh.stage_rank, mesh.num_stages - 1
        cotangents = grad_out.chunk(ctx.m)
        param_grads: List[Optional[torch.Tensor]] = [None] * len(params)
        input_grads = [None] * ctx.m
        pending = []
        for i in reversed(range(ctx.m)):
            inp, y = graphs[i]
            g = (cotangents[i].contiguous() if s == last
                 else _recv(y, mesh.peers[s + 1], mesh))
            wrt = ([inp] if inp.requires_grad else []) + list(params)
            grads = torch.autograd.grad(y, wrt, g, allow_unused=True)
            if inp.requires_grad:
                if s > 0:
                    _send(grads[0], mesh.peers[s - 1], mesh, pending)
                else:
                    input_grads[i] = grads[0]
                grads = grads[1:]
            for j, gp in enumerate(grads):
                if gp is not None:
                    param_grads[j] = (gp if param_grads[j] is None
                                      else param_grads[j] + gp)
            graphs[i] = None  # this microbatch's graph is spent
        _wait(pending)
        grad_x = (torch.cat(input_grads) if s == 0 and ctx.needs_input_grad[4]
                  else None)
        return (None, None, None, None, grad_x, *param_grads)


def pipeline_local(stage_fn: Callable[[torch.Tensor, int], torch.Tensor],
                   params: Sequence[torch.Tensor], x: torch.Tensor,
                   mesh: StageMesh, num_microbatches: int) -> torch.Tensor:
    """The stack over ``x``, this data rank's rows of every microbatch in
    microbatch order (:func:`microbatch_rows`; stage 0 reads it, the other
    stages only its shape), as an ``S``-stage pipeline; the result is this
    data rank's rows of the stack's output, the same on every stage.
    ``stage_fn(x_mb, i)`` applies this rank's stage to microbatch ``i``
    and must keep its shape; ``params``: the tensors it reads that take
    gradients (this stage's own parameters)."""
    if mesh.num_stages == 1:
        return torch.cat([stage_fn(c, i) for i, c in
                          enumerate(x.chunk(num_microbatches))])
    return _Pipeline.apply(stage_fn, mesh, num_microbatches,
                           torch.is_grad_enabled(), x, *params)


def _check_microbatches(batch: int, num_microbatches: int,
                        mesh: StageMesh) -> int:
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"num_microbatches {num_microbatches}")
    mb = batch // num_microbatches
    if mb % mesh.data_size:
        raise ValueError(f"microbatch size {mb} not divisible by the "
                         f"data axis ({mesh.data_size})")
    return mb


def microbatch_rows(x: torch.Tensor, num_microbatches: int,
                    mesh: StageMesh) -> torch.Tensor:
    """This data rank's slice of every microbatch of the global batch
    ``x``, in microbatch order: rows ``i * mb + d * mb / D`` onward, ``mb /
    D`` of them, for each microbatch ``i``."""
    mb = _check_microbatches(x.shape[0], num_microbatches, mesh)
    local = mb // mesh.data_size
    parts = x.reshape(num_microbatches, mesh.data_size, local,
                      *x.shape[1:])
    return parts[:, mesh.data_rank].reshape(num_microbatches * local,
                                            *x.shape[1:])


def gather_microbatch_rows(y: torch.Tensor, num_microbatches: int,
                           mesh: StageMesh) -> torch.Tensor:
    """The global batch from every data rank's :func:`microbatch_rows`;
    the gradient goes back to this rank's rows (``mesh.gather_rows``: for
    a downstream every data rank computes alike)."""
    if mesh.data_size == 1:
        return y
    every = mesh_lib.gather_rows(y, mesh.data)
    parts = every.reshape(mesh.data_size, num_microbatches,
                          y.shape[0] // num_microbatches, *y.shape[1:])
    return parts.transpose(0, 1).reshape(-1, *y.shape[1:])


def pipeline_apply(stage_fn: Callable[[torch.Tensor, int], torch.Tensor],
                   params: Sequence[torch.Tensor], x: torch.Tensor,
                   mesh: StageMesh, num_microbatches: int) -> torch.Tensor:
    """The layers of every stage applied in order to the global batch ``x``
    (the same on every rank), as an ``S``-stage pipeline over ``mesh``; the
    global result on every rank. Semantics::

        for s in range(S):
            x = stage_s(x)

    ``stage_fn(x_mb, i)`` and ``params``: this rank's stage
    (:func:`pipeline_local`). ``x.shape[0]`` must divide into
    ``num_microbatches``, and each microbatch by the data axis. The
    gradients of ``params`` are this data rank's share: sum them over
    ``mesh.data``."""
    local = microbatch_rows(x, num_microbatches, mesh)
    y = pipeline_local(stage_fn, params, local, mesh, num_microbatches)
    return gather_microbatch_rows(y, num_microbatches, mesh)


# ---------------------------------------------------------------------------
# Stages of the encoder, their state and their gradients
# ---------------------------------------------------------------------------


def _layers(model: nn.Module) -> nn.ModuleList:
    return model.transformer.layers


def stage_range(num_layers: int, stage: int, num_stages: int) -> range:
    """The layer indices stage ``stage`` of ``num_stages`` owns."""
    if num_layers % num_stages:
        raise ValueError(f"num_transformer_layers {num_layers} not divisible "
                         f"by pipeline stages {num_stages}")
    per = num_layers // num_stages
    return range(stage * per, (stage + 1) * per)


def stage_layers(model: nn.Module, stage: int, num_stages: int
                 ) -> nn.ModuleList:
    """The transformer layers stage ``stage`` of ``num_stages`` owns (the
    counterpart of JAX's ``[S, per_stage, ...]`` slice of the stacked layer
    parameters)."""
    layers = _layers(model)
    r = stage_range(len(layers), stage, num_stages)
    return layers[r.start:r.stop]


def shard_stages_(model: nn.Module, mesh: StageMesh) -> Dict[str, tuple]:
    """Free the parameters of the transformer layers this rank's stage does
    not own, in place (empty tensors behind the same ``Parameter``s), and
    keep every ``state_dict`` key's full shape as ``model.pp_shapes`` for
    :func:`gather_stage_state_dict`. One stage changes nothing."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.pp_shapes = shapes
    if mesh.num_stages == 1:
        return shapes
    own = set(stage_range(len(_layers(model)), mesh.stage_rank,
                          mesh.num_stages))
    for i, layer in enumerate(_layers(model)):
        if i in own:
            continue
        for p in layer.parameters():
            p.data = p.data.new_empty(0)
    return shapes


def stage_parameters(model: nn.Module, mesh: StageMesh
                     ) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """``(replicated, own)``: the frontend's and heads' parameters, which
    every stage holds, and this stage's layers' parameters."""
    layers = _layers(model)
    own = stage_layers(model, mesh.stage_rank, mesh.num_stages)
    in_layers = {id(p) for p in layers.parameters()}
    replicated = [p for p in model.parameters() if id(p) not in in_layers]
    return replicated, list(own.parameters())


def gather_stage_state_dict(model: nn.Module, mesh: StageMesh,
                            state_dict: Optional[Dict[str, torch.Tensor]]
                            = None) -> Dict[str, torch.Tensor]:
    """The full reference-layout state dict of a model cut by
    :func:`shard_stages_` (``state_dict``: one laid out like it, e.g. a
    snapshot): each layer's tensors broadcast over the stage group from the
    stage that owns them. A collective: every stage rank calls it."""
    sd = model.state_dict() if state_dict is None else state_dict
    if mesh.num_stages == 1:
        return {k: v.detach().clone() for k, v in sd.items()}
    n = len(_layers(model))
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[:2] != ["transformer", "layers"]:
            out[k] = v.detach().clone()
            continue
        owner = int(parts[2]) // (n // mesh.num_stages)
        full = (v.detach().clone(memory_format=torch.contiguous_format)
                if owner == mesh.stage_rank
                else v.new_empty(model.pp_shapes[k]))
        dist.broadcast(full, mesh.peers[owner], group=mesh.stage)
        out[k] = full
    return out


def last_stage_only(loss: torch.Tensor, mesh: StageMesh) -> torch.Tensor:
    """The loss to differentiate on this rank: as it is on the last stage,
    times 0 elsewhere. Every stage rank computes the same loss of the
    replicated output; the backward must still run on each (it drives the
    reverse ticks), but only the last stage's cotangent may enter the ring
    and the heads' gradients may be counted once."""
    return loss if mesh.is_last else loss * 0.0


def sum_over_stages_(grads: Sequence[torch.Tensor], mesh: StageMesh) -> None:
    """Sum the replicated parameters' gradients over the stage group in
    place: the frontend's are non-zero on stage 0 alone (only its frontend
    feeds the ring), the heads' on the last stage alone."""
    mesh_lib.allreduce_grads_(grads, mesh.stage, average=False)


def allreduce_stage_grads_(replicated: Sequence[torch.Tensor],
                           own: Sequence[torch.Tensor],
                           mesh: StageMesh) -> None:
    """The pipelined step's gradient sums, in place: every gradient over
    the data group (each data rank's share of the batch), then the
    replicated parameters' over the stage group."""
    mesh_lib.allreduce_grads_(list(replicated) + list(own), mesh.data,
                              average=False)
    sum_over_stages_(replicated, mesh)
