"""Cross-process pipeline and expert parallelism: the worker one rank of a
two-process fleet runs.

Counterpart of ``ste_gan_tpu/parallel/multiprocess_axes.py``, at its tiny
geometry (D 32, 4 heads, FF 64, 8 transformer layers, 8 microbatches of a
16 x 12 batch; 8 experts on a 4 x 8 token batch):

* ``--mode pipeline``: the encoder's 8-layer stack as a GPipe pipeline
  (``parallel/pipeline_parallel.py``) over the processes; every hop
  between them crosses the process boundary, forward and backward;
* ``--mode expert``: a ``MoEFeedForward`` block (``models/moe.py``) with its
  experts split over the processes (``parallel/expert_parallel.py``); the
  combine is summed across them.

A JAX process of that worker holds 4 of the 8 devices: its 8-stage ring
puts 4 stages on each of 2 processes, its 8-way expert axis 4 experts. A
torch process is one rank, so here 2 processes make 2 stages of 4 layers
and an expert axis of 2 with 4 experts each: the same layers and experts
per process. Each process writes its forward (``fwd_p{i}.npy``) and the
gradients of ``mean(y ** 2)`` re-replicated over the processes
(``grads_p{i}.npz``, ``multiprocess.flatten_state`` names: the encoder's
state-dict keys, or the block's parameter names), then takes one step of
the AdamW kernel on its own set and writes the re-replicated weights
(``state_p{i}.npz``) and its counters (``stats_p{i}.json``).
:func:`oracle` computes the same at one process.

    python -m ste_gan_torch.parallel.launch ...   # or torchrun, 2 ranks:
    torchrun --nproc_per_node 2 -m ste_gan_torch.parallel.multiprocess_axes \\
        --mode pipeline --out DIR [--device cpu] [--dist_backend gloo]

Runs on ``cuda`` unless ``--device cpu`` is given (gloo ranks may share a
card). ``--weights`` loads the parameters (a state dict of the stack's
encoder or of the block) instead of the seeded ones.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ste_gan_torch.device import resolve_device
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.moe import MoEFeedForward
from ste_gan_torch.ops import kernel_launches
from ste_gan_torch.ops.fused_adamw import adamw_init, fused_adamw_
from ste_gan_torch.parallel import expert_parallel as ep
from ste_gan_torch.parallel import pipeline_parallel as pp
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.parallel.mesh import DEFAULT_TIMEOUT_S, init_ranks
from ste_gan_torch.parallel.multiprocess import flatten_state

# The JAX worker's geometry.
D_MODEL = 32
HEADS = 4
FF = 64
LAYERS = 8          # JAX's STAGES: one layer per JAX stage
MICROBATCHES = 8
BATCH = 16          # pipeline input rows
SEQ = 12
EXPERTS = 8
MOE_B, MOE_T = 4, 8
#: AdamW of the step each process takes on its own set.
LR = 1e-3

Tensors = Dict[str, torch.Tensor]


def pipeline_setup(device=None, weights: Optional[Path] = None
                   ) -> Tuple[EMGEncoderTransformer, torch.Tensor]:
    """The 8-layer encoder whose stack is pipelined (seeded, or
    ``weights``) and its input ``[16, 12, 32]`` (numpy seed 1)."""
    model = EMGEncoderTransformer(
        model_size=D_MODEL, num_extra_res_blocks=1,
        num_transformer_layers=LAYERS, num_heads=HEADS, dim_feedforward=FF,
        dropout=0.0, generator=torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True))
    x = np.random.default_rng(1).normal(size=(BATCH, SEQ, D_MODEL))
    return (model.to(device),
            torch.from_numpy(x.astype(np.float32)).to(device))


def moe_setup(device=None, weights: Optional[Path] = None
              ) -> Tuple[MoEFeedForward, torch.Tensor]:
    """The 8-expert block (top-2, seeded or ``weights``) and its input
    ``[4, 8, 32]`` (numpy seed 6)."""
    moe = MoEFeedForward(D_MODEL, EXPERTS, FF, top_k=2,
                         generator=torch.Generator().manual_seed(0))
    if weights is not None:
        moe.load_state_dict(torch.load(weights, map_location="cpu",
                                       weights_only=True))
    x = np.random.default_rng(6).normal(size=(MOE_B, MOE_T, D_MODEL))
    return (moe.to(device),
            torch.from_numpy(x.astype(np.float32)).to(device))


def _layer_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters()
            if n.startswith("transformer.layers.")}


def _adamw_step(params, grads) -> None:
    fused_adamw_(adamw_init(list(params), lr=LR), list(grads))


def run_pipeline(device, weights=None, group=None
                 ) -> Tuple[torch.Tensor, Tensors, Tensors, dict]:
    """The stack over the ranks of ``group`` as that many stages: the
    forward, the re-replicated gradients and weights after one AdamW step
    on this stage's layers, and the point-to-point counters."""
    model, x = pipeline_setup(device, weights)
    stages = pp.create_stage_mesh(dist.get_world_size(group)
                                  if group is not None else 1, group)
    pp.shard_stages_(model, stages)
    layers = pp.stage_layers(model, stages.stage_rank, stages.num_stages)
    _, own = pp.stage_parameters(model, stages)

    def stage_fn(h, i):
        for layer in layers:
            h = layer(h)
        return h

    y = pp.pipeline_apply(stage_fn, own, x, stages, MICROBATCHES)
    loss = torch.mean(torch.square(y))
    grads = torch.autograd.grad(pp.last_stage_only(loss, stages), own)
    by_id = dict(zip((id(p) for p in own), grads))
    named = _layer_params(model)
    full_grads = pp.gather_stage_state_dict(model, stages, {
        n: by_id.get(id(p), p.detach()) for n, p in named.items()})
    _adamw_step(own, grads)
    weights_after = pp.gather_stage_state_dict(model, stages, {
        n: p.detach() for n, p in named.items()})
    comm = {"messages": stages.comm.calls, "bytes": stages.comm.bytes}
    return y.detach(), full_grads, weights_after, comm


def run_expert(device, weights=None, group=None
               ) -> Tuple[torch.Tensor, Tensors, Tensors, dict]:
    """The block with its experts split over the ranks of ``group``: the
    forward, the re-replicated gradients and weights after one AdamW step
    on this rank's set, and the collectives' counters."""
    moe, x = moe_setup(device, weights)
    size = dist.get_world_size(group) if group is not None else 1
    layout = ep.create_expert_mesh(1, size, group)
    holder = nn.Module()
    holder.moe_ffn = moe  # the rule keys on the module's name
    axes = ep.shard_moe_module_(holder, layout)
    y = moe(x)
    names = [n for n, _ in moe.named_parameters()]
    params = list(moe.parameters())
    grads = torch.autograd.grad(torch.mean(torch.square(y)), params)

    def whole(tensors):
        out = {}
        for n, t in zip(names, tensors):
            axis = axes[f"moe_ffn.{n}"]
            out[n] = (t.detach() if axis is None or layout.model is None
                      else tp._all_gather(t.detach(), axis, layout.model))
        return out

    full_grads = whole(grads)
    _adamw_step(params, grads)
    comm = {"collectives": layout.comm.calls, "bytes": layout.comm.bytes}
    return y.detach(), full_grads, whole(params), comm


def oracle(mode: str, device=None, weights: Optional[Path] = None
           ) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                      Dict[str, np.ndarray]]:
    """One process: the forward (the stack at the pipeline's microbatch
    shape, the whole block), the gradients of ``mean(y ** 2)`` and the
    weights after one AdamW step, under the worker's names."""
    if mode == "pipeline":
        model, x = pipeline_setup(device, weights)
        named = _layer_params(model)
        chunks = []
        for xb in x.chunk(MICROBATCHES):
            for layer in model.transformer.layers:
                xb = layer(xb)
            chunks.append(xb)
        y = torch.cat(chunks)
    else:
        moe, x = moe_setup(device, weights)
        named = dict(moe.named_parameters())
        y = moe(x)
    grads = torch.autograd.grad(torch.mean(torch.square(y)),
                                list(named.values()))
    _adamw_step(named.values(), grads)
    return (y.detach().cpu().numpy(),
            flatten_state(dict(zip(named, grads))),
            flatten_state({n: p.detach() for n, p in named.items()}))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("pipeline", "expert"), required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--weights", type=Path, default=None,
                    help="state dict of the stack's encoder (pipeline) or "
                         "of the block (expert); else seeded weights")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", type=str, default=None,
                    help="nccl (default on cuda) or gloo")
    ap.add_argument("--init_method", type=str, default=None,
                    help="rendezvous URL (default env://, from "
                         "MASTER_ADDR / MASTER_PORT)")
    ap.add_argument("--timeout_s", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds a collective may wait")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    rank, group, _ = init_ranks(args.dist_backend, args.timeout_s,
                                args.device, args.init_method)
    try:
        dev = resolve_device(args.device)
        run = run_pipeline if args.mode == "pipeline" else run_expert
        y, grads, weights, comm = run(dev, args.weights, group)
        args.out.mkdir(parents=True, exist_ok=True)
        np.save(args.out / f"fwd_p{rank}.npy", y.cpu().numpy())
        np.savez(args.out / f"grads_p{rank}.npz", **flatten_state(grads))
        np.savez(args.out / f"state_p{rank}.npz", **flatten_state(weights))
        (args.out / f"stats_p{rank}.json").write_text(json.dumps({
            **comm, "launches": kernel_launches(), "device": str(dev)}))
        size = dist.get_world_size() if group is not None else 1
        print(f"rank {rank}/{size}: {args.mode} over {size} process(es) OK",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
