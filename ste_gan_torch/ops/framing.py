"""Windowed (framed) reductions over the time axis.

Counterpart of ``ste_gan_tpu/ops/framing.py``: a framed mean or sum is a
strided depthwise convolution with a constant kernel. Frame count
``(T - window) // stride + 1``; the trailing remainder is dropped, as
``Tensor.unfold`` drops it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def frame_reduce(x: torch.Tensor, window: int, stride: int,
                 mode: str = "mean") -> torch.Tensor:
    """``[B, C, T] -> [B, C, num_frames]`` framed reduction in f32."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"unsupported mode: {mode}")
    c, t = x.shape[1], x.shape[2]
    num_frames = (t - window) // stride + 1
    needed = (num_frames - 1) * stride + window
    x = x[..., :needed].float()
    fill = 1.0 / window if mode == "mean" else 1.0
    kernel = torch.full((c, 1, window), fill, dtype=x.dtype, device=x.device)
    return F.conv1d(x, kernel, stride=stride, groups=c)
