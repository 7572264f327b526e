"""CUDA-graph replay of the synthesizer's generator forward.

The generator's forward launches some 600 kernels, and the host spends
~17 us on each: more than the card spends on most of them, so the host
paces synthesis. A corpus pass repeats few call shapes (rows times the
bucketed length), so each shape's forward is recorded once as a CUDA graph
and replayed: one launch where there were hundreds.

:class:`GraphedForward` stands in for ``module(*args)`` at inference. It
serves a call from a graph only where a replay computes what the eager
call computes (:meth:`GraphedForward.eager_reason`):

* the call runs under ``torch.inference_mode()`` (a graph records no
  autograd history, and its buffers are inference tensors);
* no submodule carries a tensor-parallel shard;
* no hook is registered, globally or on any submodule (a replay runs
  none);
* every argument is a tensor or None, and the tensors and the module's
  parameters are on one CUDA device.

Otherwise it calls the module as before. Graphs are keyed by the call's
signature and admitted as ``utils/graph_keys.py`` says, at most
:data:`MAX_SIGNATURES`; a signature's second call captures the forward on
a side stream, first running it outside the capture only where its thread
has not captured before or did not run the signature's eager call.

All graphs of one :class:`GraphedForward` share one memory pool, so a
graph's replay may overwrite another graph's output buffer; and calls of
one signature share its input buffers. A lock therefore holds each call
from its bookkeeping to the enqueue of its output's copy, and a replay
from another stream than the last one's first waits for that stream: a
server's threads may call one synthesizer at once.

A replay reads the parameters and buffers where they were at capture:
``EMGSynthesizer.set_params`` copies weights in place, so the next replay
reads the new ones; a parameter that moved makes a new signature. A replay
copies the call's tensors into the graph's input buffers and returns a
copy of its output buffer, so a caller may keep what it got. A capture
cannot hold a copy from the host inside the forward, so the synthesizer
hands the generator its valid lengths as device tensors.

Counters (``utils/profiling.py``): ``synth/graph_replays`` (calls served
by a replay, the capturing call among them), ``synth/graph_eager`` (calls
run eagerly), ``synth/graph_captures``.
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

import torch

from ste_gan_torch.utils.graph_keys import (Admission, hooked, signature,
                                            tensor_parallel)
from ste_gan_torch.utils.graph_keys import on_cuda as _on_cuda

REPLAYS = "synth/graph_replays"
EAGER = "synth/graph_eager"
CAPTURES = "synth/graph_captures"

#: Signatures a :class:`GraphedForward` keeps, seen once or captured: a
#: corpus bucketed by 64 frames in rows of up to 16 has about two shapes a
#: bucket (full batches and the tail), some 20-30 in all.
MAX_SIGNATURES = 64


class GraphedForward:
    """``module(*args)``, served from CUDA graphs where the call allows
    it (see the module docstring). Safe to call from several threads."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self._subs = list(module.modules())
        self._state = [*module.parameters(), *module.buffers()]
        self._admission = Admission(MAX_SIGNATURES, EAGER, CAPTURES, REPLAYS)
        self._lock = threading.Lock()
        self._warmed = threading.local()
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        # The stream of the last replay; a replay from another stream
        # waits for it.
        self._last: Optional[torch.cuda.Stream] = None

    def eager_reason(self, args: Sequence[Any]) -> Optional[str]:
        """Why this call runs eagerly, or None if graphs may serve it."""
        if not torch.is_inference_mode_enabled():
            return "not in inference mode"
        if tensor_parallel(self._subs):
            return "a tensor-parallel layer"
        if hooked(self._subs):
            return "a module hook"
        if not all(a is None or isinstance(a, torch.Tensor) for a in args):
            return "an argument neither a tensor nor None"
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors or not _on_cuda(tensors + self._state[:1]):
            return "not on one CUDA device"
        return None

    def signature(self, args: Sequence[Any]) -> tuple:
        """The key of the call's graph (``utils/graph_keys.py``)."""
        return signature(args, self._state)

    def __call__(self, *args):
        if self.eager_reason(args) is not None:
            return self._admission.eager(self.module, args)
        key = self.signature(args)
        # One call at a time, from the bookkeeping to the enqueue of the
        # output's copy: calls share the graphs' input buffers, and graphs
        # share one memory pool, so one graph's replay may overwrite
        # another's output buffer.
        with self._lock:
            graph = self._admission.graph(
                key, threading.get_ident(),
                lambda thread: self._capture(args, self._warm_first(thread)))
            if graph is None:
                return self._admission.eager(self.module, args)
            self._after_last(graph)
            return graph.run(args)

    def _after_last(self, graph: "_Graph") -> None:
        """Order this call's copies, replay and clone after the last
        call's: they run in the order they are enqueued on one stream, so
        a call from another stream first waits for the last one's."""
        stream = torch.cuda.current_stream(graph.device)
        if self._last is not None and self._last != stream:
            stream.wait_stream(self._last)
        self._last = stream

    def _warm_first(self, eager_thread: int) -> bool:
        """Whether a capture on this thread first runs the forward on the
        capture stream outside the capture, for what a capture cannot
        create: the thread's library handles and their workspaces for
        that stream (at its first capture), and cuDNN's choice of
        algorithms for the shape (where another thread, ``eager_thread``,
        ran the signature's eager call)."""
        first = not getattr(self._warmed, "done", False)
        self._warmed.done = True
        return first or eager_thread != threading.get_ident()

    def _capture(self, args: Sequence[Any], warm: bool) -> "_Graph":
        """The call's graph, in the memory pool and on the capture stream
        that all graphs of this module share."""
        if self._pool is None:
            tensor = next(a for a in args if isinstance(a, torch.Tensor))
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(tensor.device)
        return _Graph(self.module, args, self._pool, self._stream, warm)


class _Graph:
    """The forward of one signature, captured on ``stream`` into the
    memory pool ``pool``, with its input and output buffers."""

    def __init__(self, module: torch.nn.Module, args: Sequence[Any], pool,
                 stream: torch.cuda.Stream, warm: bool):
        self.static = [a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args]
        self.where = [i for i, a in enumerate(args)
                      if isinstance(a, torch.Tensor)]
        self.device = stream.device
        # Where ``warm``, one forward on the capture stream outside the
        # capture (GraphedForward._warm_first); then the capture.
        # thread_local: a server's other threads may use the card
        # meanwhile.
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                if warm:
                    module(*self.static)
                self.graph.capture_begin(pool,
                                         capture_error_mode="thread_local")
                try:
                    self.out = module(*self.static)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)

    def run(self, args: Sequence[Any]) -> torch.Tensor:
        """``module(*args)`` by replay, in a tensor of the caller's own."""
        with torch.cuda.device(self.device):
            for i in self.where:
                self.static[i].copy_(args[i])
            self.graph.replay()
            return self.out.clone()
