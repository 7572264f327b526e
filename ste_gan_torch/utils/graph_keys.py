"""What the two CUDA-graph replay paths share: the GAN step's
(``train/graphed.py`` ``GraphedCall``) and the synthesizer's
(``infer_graphs.py`` ``GraphedForward``).

A replay runs the kernels its capture recorded, on the addresses it
recorded, with the settings the capture saw; so each path keys its graphs
by :func:`signature`, serves only calls whose tensors sit on one CUDA
device (:func:`on_cuda`) and runs eagerly while a global module hook,
which a replay would skip, is registered (:func:`global_hooks`).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch.nn.modules import module as nn_module


def on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    """All on one CUDA device."""
    return (len({t.device for t in tensors}) == 1
            and tensors[0].device.type == "cuda")


def global_hooks() -> bool:
    """A module hook registered for every module."""
    return any(getattr(nn_module, name, None) for name in (
        "_global_forward_pre_hooks", "_global_forward_hooks",
        "_global_backward_pre_hooks", "_global_backward_hooks"))


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
