"""The admission policy of the two CUDA-graph replay paths, the GAN step's
(``train/graphed.py`` ``GraphedCall``) and the synthesizer's
(``infer_graphs.py`` ``GraphedForward``), and what it keys on.

A replay runs the kernels its capture recorded, on the addresses it
recorded, with the settings the capture saw: so graphs are keyed by
:func:`signature`, and serve no call off one CUDA device, through a
tensor-parallel layer or past a hook a replay would skip. The rest of the
policy is :class:`Admission`'s.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence

import torch
from torch.nn.modules import module as nn_module

from ste_gan_torch.utils.profiling import add


def on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    """All on one CUDA device."""
    return (len({t.device for t in tensors}) == 1
            and tensors[0].device.type == "cuda")


def global_hooks() -> bool:
    """A module hook registered for every module."""
    return any(getattr(nn_module, name, None) for name in (
        "_global_forward_pre_hooks", "_global_forward_hooks",
        "_global_backward_pre_hooks", "_global_backward_hooks"))


def hooked(modules: Sequence[torch.nn.Module],
           own: Optional[torch.nn.Module] = None) -> bool:
    """A hook a replay would skip: a global one, or one on any of
    ``modules`` but ``own``'s forward hooks, which the caller runs on a
    replay's outputs itself."""
    return global_hooks() or any(
        m._forward_pre_hooks or m._backward_hooks
        or getattr(m, "_backward_pre_hooks", None)
        or (m is not own and m._forward_hooks) for m in modules)


def tensor_parallel(modules: Sequence[torch.nn.Module]) -> bool:
    """A layer of ``modules`` holding a tensor-parallel shard, which runs
    collectives inside the forward. The port sets ``tp`` on instances only;
    the one class-level ``tp`` is the convs' None."""
    return any(vars(m).get("tp") is not None for m in modules)


def switches() -> tuple:
    """The global settings that change which kernels a call runs: TF32 in
    cuDNN and in matrix products, cuDNN's deterministic mode, autocast."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cuda.matmul.allow_tf32,
            torch.is_autocast_enabled("cuda"))


def signature(args: Sequence[Any], state: Sequence[torch.Tensor]) -> tuple:
    """The key of a call's graphs: shape, stride, dtype, device and
    ``requires_grad`` of each tensor argument, the others by value; the
    addresses of ``state`` (a module's parameters and buffers); the
    :func:`switches`."""
    return tuple((tuple(a.shape), a.stride(), a.dtype, a.device,
                  a.requires_grad) if isinstance(a, torch.Tensor)
                 else ("value", a) for a in args) + (
        tuple(t.data_ptr() for t in state), switches())


class Admission:
    """A signature's first call runs eagerly, which warms cuDNN's choice
    of algorithms and lazy initialisation; its second captures; later calls
    replay. At most ``bound`` signatures, seen once or captured, are kept,
    the least recently used dropped first. Calls add to the caller's
    counters of eager calls, captures and replays. Not thread-safe."""

    def __init__(self, bound: int, eager: str, captures: str, replays: str):
        self.bound = bound
        self._eager, self._captures, self._replays = eager, captures, replays
        self.entries: "OrderedDict[tuple, list]" = OrderedDict()

    def eager(self, module: Callable, args: Sequence[Any]):
        """``module(*args)``, counted as an eager call."""
        add(self._eager, 1)
        return module(*args)

    def graph(self, key: tuple, first: Any, capture: Callable[[Any], Any]):
        """The graph that serves the call of signature ``key``, counted as
        a replay; or None at its first sighting, noted with ``first``. The
        second sighting makes the graph with ``capture(first)``."""
        entry = self.entries.get(key)
        if entry is None:
            self.entries[key] = [first, None]
            while len(self.entries) > self.bound:
                self.entries.popitem(last=False)
            return None
        self.entries.move_to_end(key)
        if entry[1] is None:
            entry[1] = capture(entry[0])
            add(self._captures, 1)
        add(self._replays, 1)
        return entry[1]
