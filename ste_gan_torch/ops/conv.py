"""Convolutions with explicit weight- and spectral-norm reparameterisations,
and the pooling and resampling helpers around them.

Counterpart of ``ste_gan_tpu/ops/conv.py``. Modules and helpers use
PyTorch's channel-first layout (``[B, C, T]``, ``[B, C, H, W]``); parameter
names follow the reference state-dict layout: ``weight_v``/``weight_g`` for
weight norm, ``weight_orig`` with ``weight_u``/``weight_v`` buffers for
spectral norm, ``weight`` for a plain conv.

:func:`conv` is the one dispatch point for convolutions: a grouped 1-D conv
without dilation goes to the hand-written Hopper kernel
(:mod:`ste_gan_torch.ops.grouped_conv`); every other conv (dense, dilated,
2-D) is ``F.conv1d``/``F.conv2d``, as XLA computed them outside any Pallas
kernel. Convs compute in the module dtype (bf16 under mixed precision) with
f32 parameters, casting at the same places as the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch.ops.grouped_conv import grouped_conv1d
from ste_gan_torch.parallel.tensor_parallel import (
    copy_to_model, gather_from_model, replicated_sum)

IntOrPair = Union[int, Sequence[int]]


def _tuple(v: IntOrPair, rank: int) -> Tuple[int, ...]:
    return (v,) * rank if isinstance(v, int) else tuple(int(a) for a in v)


def conv(x, w, stride: Tuple[int, ...], padding: Tuple[int, ...],
         dilation: Tuple[int, ...], groups: int):
    """Dispatch a convolution (symmetric padding per spatial axis)."""
    rank = w.dim() - 2
    if rank == 1 and groups > 1 and dilation[0] == 1:
        return grouped_conv1d(x, w, stride=stride[0],
                              padding=(padding[0], padding[0]), groups=groups)
    fn = F.conv1d if rank == 1 else F.conv2d
    return fn(x, w, stride=stride, padding=padding, dilation=dilation,
              groups=groups)


def _uniform(shape, bound: float, generator: Optional[torch.Generator]):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class _ConvBase(nn.Module):
    """Shared geometry of the convs. ``kernel_size``, ``stride``,
    ``padding`` and ``dilation`` are per spatial axis (rank 1 or 2).
    Weights and bias draw from ``generator`` with PyTorch's default conv
    init, U(+-1/sqrt(fan_in)). ``tp``: the layer's ``ModelShard`` once its
    output channels are split (``tensor_parallel.shard_module_``)."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrPair, stride: IntOrPair = 1,
                 padding: IntOrPair = 0, dilation: IntOrPair = 1,
                 groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rank = 1 if isinstance(kernel_size, int) else len(kernel_size)
        self.kernel_size = _tuple(kernel_size, rank)
        self.stride = _tuple(stride, rank)
        self.padding = _tuple(padding, rank)
        self.dilation = _tuple(dilation, rank)
        if in_channels % groups or out_channels % groups:
            raise ValueError("channels not divisible by groups")
        self.groups = groups
        self.dtype = dtype
        self.in_channels = in_channels
        self.out_channels = out_channels
        wshape = (out_channels, in_channels // groups, *self.kernel_size)
        bound = 1.0 / math.sqrt((in_channels // groups)
                                * math.prod(self.kernel_size))
        self._make_weight(_uniform(wshape, bound, generator), generator)
        self.bias = (nn.Parameter(_uniform((out_channels,), bound, generator))
                     if bias else None)

    def _make_weight(self, w: torch.Tensor,
                     generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def _conv(self, x, w):
        groups = self.groups if self.tp is None else self.tp.groups
        return conv(x.to(self.dtype), w.to(self.dtype), self.stride,
                    self.padding, self.dilation, groups)

    def _input(self, x):
        """The input as this rank's slab reads it (all of it unsplit)."""
        if self.tp is None:
            return x
        x = copy_to_model(x, self.tp.group, self.tp.comm)
        return x if self.tp.in_slice is None else x[:, self.tp.in_slice]

    def _finish(self, y, gather: bool = True):
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(
                (1, -1) + (1,) * (y.dim() - 2))
        if self.tp is not None and gather:
            y = gather_from_model(y, 1, self.tp.group, self.tp.comm)
        return y


class Conv(_ConvBase):
    """Plain convolution (the EMG encoder's ResBlocks)."""

    def _make_weight(self, w, generator):
        self.weight = nn.Parameter(w)

    def forward(self, x, gather: bool = True):
        """``gather=False``: a split layer returns its output slab."""
        return self._finish(self._conv(self._input(x), self.weight), gather)


def norm_per_out_channel(v: torch.Tensor) -> torch.Tensor:
    """L2 norm over every axis but the leading output-channel axis."""
    return torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(1, v.dim()))))


class WNConv(_ConvBase):
    """Weight-normalised conv: ``w = g * v / ||v||`` per output channel,
    ``g`` initialised to ``||v||`` so that ``w == v`` at init."""

    def _make_weight(self, v, generator):
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(
            norm_per_out_channel(v).view((-1,) + (1,) * (v.dim() - 1)))

    def weight(self):
        v = self.weight_v
        scale = self.weight_g.view(-1) / norm_per_out_channel(v.float())
        return v * scale.to(v.dtype).view((-1,) + (1,) * (v.dim() - 1))

    def forward(self, x):
        return self._finish(self._conv(self._input(x), self.weight()))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def _dual_scale(y, sigma1, sigma2, dual_batch: int):
    """The first ``dual_batch`` rows of ``y`` over ``sigma1``, the rest over
    ``sigma2``."""
    inv = torch.cat([(1.0 / sigma1).expand(dual_batch),
                     (1.0 / sigma2).expand(y.shape[0] - dual_batch)])
    return y * inv.to(y.dtype).view((-1,) + (1,) * (y.dim() - 1))


class SNConv(_ConvBase):
    """Spectrally-normalised conv with persistent power iteration.

    ``weight_u`` [out] and ``weight_v`` [rest] are buffers (``weight_v`` in
    the order of the flattened ``[out, in/G, *k]`` weight). A training
    forward runs one power iteration and stores the vectors; an eval forward
    reuses them. ``dual_batch=B`` reproduces two sequential training
    forwards on a stacked ``[fake; real]`` input in one conv: the iteration
    advances twice and the first B rows are scaled by ``1/sigma_1``, the rest
    by ``1/sigma_2`` (``ste_gan_tpu/ops/conv.py:303-363``)."""

    eps = 1e-12

    def _make_weight(self, w, generator):
        self.weight_orig = nn.Parameter(w)
        u = l2_normalize(torch.randn(w.shape[0], generator=generator),
                         self.eps)
        self.register_buffer("weight_u", u)
        self.register_buffer(
            "weight_v", l2_normalize(w.reshape(w.shape[0], -1).T @ u,
                                     self.eps))

    def _place(self):
        """``(group, rank, comm)`` of this layer over the model ranks; an
        unsplit layer is rank 0 of a group of one (None: no collective)."""
        tp = self.tp
        return (None, 0, None) if tp is None else (tp.group, tp.rank, tp.comm)

    def _power_step(self, mat_ng, u):
        """One power iteration ``v = norm(Wᵀu)``, ``u = norm(Wv)``; over the
        model ranks ``W`` is this rank's rows, ``Wᵀu`` a sum of the ranks'
        parts and ``Wv`` a gather of them."""
        group, rank, comm = self._place()
        rows = mat_ng.shape[0]
        part = mat_ng.T @ u[rank * rows:(rank + 1) * rows]
        v = l2_normalize(replicated_sum(part, group, comm), self.eps)
        wv = gather_from_model(mat_ng @ v, 0, group, comm)
        return l2_normalize(wv, self.eps), v

    def _sigma(self, mat, u, v):
        """``u @ W @ v``, with gradients through ``W`` only; over the model
        ranks the sum of the ranks' rows (a ``replicated_sum``: every rank
        scales the gathered output by it)."""
        group, rank, comm = self._place()
        rows = mat.shape[0]
        return replicated_sum(u[rank * rows:(rank + 1) * rows] @ (mat @ v),
                              group, comm)

    def forward(self, x, dual_batch: Optional[int] = None):
        kernel = self.weight_orig
        mat = kernel.reshape(kernel.shape[0], -1).float()
        dual = self.training and dual_batch is not None
        with torch.no_grad():
            mat_ng = mat.detach()
            u, v = self.weight_u.clone(), self.weight_v.clone()
            if self.training:
                u, v = self._power_step(mat_ng, u)
                if dual:
                    u1, v1 = u, v
                    u, v = self._power_step(mat_ng, u1)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        if self.tp is None and not dual:
            # One sigma, one rank: the kernel is scaled before the conv, as
            # the JAX package rounds it.
            sigma = self._sigma(mat, u, v)
            return self._finish(self._conv(x, kernel / sigma.to(kernel.dtype)))
        # Otherwise sigma (two in the dual mode; gradients through the
        # weight only) scales the output, gathered over the model ranks so
        # that every rank uses it on the same full tensor, and the gathered
        # bias follows.
        group, _, comm = self._place()
        y = gather_from_model(self._conv(self._input(x), kernel), 1, group,
                              comm)
        if dual:
            y = _dual_scale(y, self._sigma(mat, u1, v1),
                            self._sigma(mat, u, v), dual_batch)
        else:
            y = y * (1.0 / self._sigma(mat, u, v)).to(y.dtype)
        if self.bias is not None:
            bias = gather_from_model(self.bias, 0, group, comm)
            y = y + bias.to(self.dtype).view((1, -1) + (1,) * (y.dim() - 2))
        return y


# ---------------------------------------------------------------------------
# Pooling / resampling helpers, channel-first [B, C, T]
# ---------------------------------------------------------------------------


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling along time."""
    if factor == 1:
        return x
    return torch.repeat_interleave(x, factor, dim=-1)


def avg_pool1d(x: torch.Tensor, window: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    """Average pool over time; the zero padding counts in the denominator."""
    return F.avg_pool1d(x, window, stride, padding, count_include_pad=True)


def reflect_pad_time(x: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
    """Reflect-pad the last (time) axis."""
    return F.pad(x, pad, mode="reflect")


def moving_average(x: torch.Tensor, window: int,
                   pad_signal: bool = True) -> torch.Tensor:
    """Centred moving average over time with reflect padding, as a
    depthwise conv with a constant kernel."""
    c = x.shape[1]
    if pad_signal:
        half = window // 2
        x = reflect_pad_time(x, (half, half))
    kernel = torch.full((c, 1, window), 1.0 / window, dtype=x.dtype,
                        device=x.device)
    return F.conv1d(x, kernel, groups=c)
