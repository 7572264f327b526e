"""CUDA-graph replay of a network's forward and backward inside the GAN
step.

The eager GAN step launches some 5,900 kernels, copies and fills, and the
host spends ~17 us on each: more than the card spends on most of them.
The generator and the frozen encoder hold none of the discriminator's
grouped convs or spectral-norm state, so their forward and backward can be
recorded once as CUDA graphs and replayed, one launch where there were
hundreds.

:class:`GraphedCall` stands in for ``module(*args)`` in the step. It
serves a call from graphs only where the call can observe that a replay
computes what the eager call computes (:meth:`GraphedCall.eager_reason`):

* the step lets it (``capturable``: under ``train.remat``
  ``torch.utils.checkpoint`` recomputes the forward inside the backward);
* grad mode is on (a no-grad caller wants no backward);
* no submodule carries a tensor-parallel shard or routes tokens by their
  values (an MoE block: the capacity block reads its routing on the host,
  which a capture cannot; the dropless one sums its counters and keeps
  its loads outside any graph);
* no hook is registered but the module's own forward hooks (a hook inside
  the forward would not run in a replay);
* the call's tensors and the module's parameters are on one CUDA device.

Otherwise it calls the module as before. Graphs are keyed by the call's
signature and ``requires_grad`` of the module's parameters, and admitted
as ``utils/graph_keys.py`` says, at most :data:`MAX_SIGNATURES`; a
signature's second call runs the forward and backward once more on a side
stream and captures both into a memory pool of their own.

A replay reads the parameters and buffers where they were at capture:
AdamW, the EMA swap, checkpoint restores and ``eval_generator_params``
write them in place. A parameter that moved (FSDP frees the generator's
flat buffer after every step and allocates it again for the next) makes a
new signature, so no graph reads an address its tensor has left. The
outputs a replay returns, and the gradients its backward gives, live in
the graph's buffers, which the next replay overwrites: a caller that keeps
one past that copies it. The module's forward hooks run on every call's
outputs, replays included.

Counters (``utils/profiling.py``): ``gan/graph_replays`` (calls served by
a replay), ``gan/graph_eager`` (calls run eagerly), ``gan/graph_captures``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence, Tuple

import torch

from ste_gan_torch.models.moe import DroplessMoE, MoEFeedForward
from ste_gan_torch.utils.graph_keys import (Admission, global_hooks, hooked,
                                            signature, tensor_parallel)
from ste_gan_torch.utils.graph_keys import on_cuda as _on_cuda

REPLAYS = "gan/graph_replays"
EAGER = "gan/graph_eager"
CAPTURES = "gan/graph_captures"

#: Signatures a :class:`GraphedCall` keeps, seen once or captured.
MAX_SIGNATURES = 4


class GraphedCall:
    """``module(*args)``, served from CUDA graphs where the call allows
    it (see the module docstring)."""

    def __init__(self, module: torch.nn.Module, capturable: bool = True):
        self.module = module
        self.capturable = capturable
        self._subs = list(module.modules())
        self._routed = any(isinstance(m, (MoEFeedForward, DroplessMoE))
                           for m in self._subs)
        self._params = list(module.parameters())
        self._state = self._params + list(module.buffers())
        self._admission = Admission(MAX_SIGNATURES, EAGER, CAPTURES, REPLAYS)

    def eager_reason(self, args: Sequence[Any]) -> Optional[str]:
        """Why this call runs eagerly, or None if graphs may serve it."""
        if not self.capturable:
            return "the step recomputes it (train.remat)"
        if not torch.is_grad_enabled():
            return "grad mode is off"
        if self._routed:
            return "routing by value (MoE)"
        if global_hooks():
            return "a global module hook"
        if tensor_parallel(self._subs):
            return "a tensor-parallel layer"
        if hooked(self._subs, self.module):
            return "a hook inside the forward"
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors or not _on_cuda(tensors + self._state[:1]):
            return "not on CUDA"
        return None

    def signature(self, args: Sequence[Any]) -> tuple:
        """The key of the call's graphs."""
        return signature(args, self._state) + (
            tuple(p.requires_grad for p in self._params),)

    def __call__(self, *args):
        graphs = None if self.eager_reason(args) else self._admission.graph(
            self.signature(args), None, lambda _: _Graphs(self.module, args))
        if graphs is None:
            return self._admission.eager(self.module, args)
        return self._hooked(args, graphs.run(args))

    def _hooked(self, args, out):
        """``out`` through the module's forward hooks, as ``module(*args)``
        would pass it."""
        m = self.module
        for hook_id, hook in list(m._forward_hooks.items()):
            if hook_id in m._forward_hooks_with_kwargs:
                result = hook(m, args, {}, out)
            else:
                result = hook(m, args, out)
            if result is not None:
                out = result
        return out


def _leaves(out) -> Tuple[torch.Tensor, ...]:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@contextlib.contextmanager
def _swapped(slots: Sequence[tuple]):
    """Each ``(submodule, name, tensor)``'s tensor in place of the
    parameter ``name`` while the block runs."""
    kept = [(m, name, m._parameters[name]) for m, name, _ in slots]
    for m, name, t in slots:
        m._parameters[name] = t
    try:
        yield
    finally:
        for m, name, p in kept:
            m._parameters[name] = p


class _Graphs:
    """The forward and the backward of one signature, captured into one
    memory pool, with their static inputs, outputs and gradients.

    The captures differentiate with respect to aliases of the trainable
    parameters (same storage, leaves of their own), so no autograd node a
    caller keeps from an eager call on another stream (the last
    microbatch's graph, say) takes part in the capture."""

    def __init__(self, module: torch.nn.Module, args: Sequence[Any]):
        self.static = [a.detach().clone().requires_grad_(a.requires_grad)
                       if isinstance(a, torch.Tensor) else a for a in args]
        self.where = [i for i, a in enumerate(self.static)
                      if isinstance(a, torch.Tensor)]
        alias, slots = {}, []
        for m in module.modules():
            for name, p in m._parameters.items():
                if p is not None and p.requires_grad:
                    if id(p) not in alias:
                        alias[id(p)] = (p, p.detach().requires_grad_(True))
                    slots.append((m, name, alias[id(p)][1]))
        self.wrt_params = [p for p, _ in alias.values()]
        wrt = [self.static[i] for i in self.where
               if self.static[i].requires_grad] + [
                   a for _, a in alias.values()]

        def forward(*a):
            with _swapped(slots):
                return module.forward(*a)

        # Warm-up on a side stream: cuBLAS workspaces and the autograd
        # engine's state for this stream, outside any capture.
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            outs = [o for o in _leaves(forward(*self.static))
                    if o.requires_grad]
            if outs and wrt:
                torch.autograd.grad(outs, wrt,
                                    [torch.ones_like(o) for o in outs],
                                    allow_unused=True)
            del outs
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()

        # thread_local: the data feed's thread goes on copying meanwhile.
        pool = torch.cuda.graph_pool_handle()
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, pool=pool,
                              capture_error_mode="thread_local"):
            out = forward(*self.static)
        self.single = isinstance(out, torch.Tensor)
        outs = _leaves(out)
        self.grad_outs = [torch.empty_like(o) if o.requires_grad else None
                          for o in outs]
        diff = [o for o in outs if o.requires_grad]
        grads: Sequence[Optional[torch.Tensor]] = [None] * len(wrt)
        self.bwd = None
        if diff and wrt:
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=pool,
                                  capture_error_mode="thread_local"):
                grads = torch.autograd.grad(
                    diff, wrt, [g for g in self.grad_outs if g is not None],
                    allow_unused=True)
        self.outs = [o.detach() for o in outs]
        # One gradient per input of _Replay: the call's tensors, then the
        # parameters.
        it = iter(grads)
        self.input_grads = [next(it) if self.static[i].requires_grad else None
                            for i in self.where] + [next(it) for _ in
                                                    self.wrt_params]

    def run(self, args: Sequence[Any]):
        """The outputs of ``forward(*args)`` by replay, as one autograd
        node over the call's tensors and the parameters."""
        outs = _Replay.apply(self, *(args[i] for i in self.where),
                             *self.wrt_params)
        return outs[0] if self.single else outs


class _Replay(torch.autograd.Function):
    """The captured forward as one autograd node; its backward replays
    the captured backward."""

    @staticmethod
    def forward(ctx, graphs: _Graphs, *inputs):
        for i, x in zip(graphs.where, inputs):
            graphs.static[i].copy_(x)
        graphs.fwd.replay()
        ctx.graphs = graphs
        return tuple(o.detach() for o in graphs.outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        graphs = ctx.graphs
        for buf, g in zip(graphs.grad_outs, grads):
            if buf is not None:
                buf.copy_(g)
        if graphs.bwd is not None:
            graphs.bwd.replay()
        return (None,) + tuple(None if g is None else g.detach()
                               for g in graphs.input_grads)
