"""Multi-window time-domain (TD) feature loss (counterpart of
``ste_gan_tpu/losses/td_loss.py``).

A signal splits into a low part (double 9-point moving average) and a
rectified high residual; per window, four framed features (mean and power of
the low part, power and mean of the rectified high part) are compared by L1
against the detached real features, summed over the windows (20, 8),
(51, 13), (80, 16). Public functions take channel-last ``[B, T, C]``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ste_gan_torch.ops.conv import moving_average, reflect_pad_time
from ste_gan_torch.ops.framing import frame_reduce

DEFAULT_TD_WINDOWS: Tuple[Tuple[int, int], ...] = ((20, 8), (51, 13), (80, 16))

AVG_FILTER_WINDOW = 9


def time_domain_features(x: torch.Tensor, window: int, stride: int,
                         avg_window: int = AVG_FILTER_WINDOW) -> torch.Tensor:
    """``[B, T, C] -> [B, F, C, 4]`` framed TD features in f32."""
    x = x.float().transpose(1, 2)
    low = moving_average(moving_average(x, avg_window), avg_window)
    high_rect = torch.abs(x - low)
    pad = window // 2
    low_p = reflect_pad_time(low, (pad, pad))
    rect_p = reflect_pad_time(high_rect, (pad, pad))
    feats = torch.stack([
        frame_reduce(low_p, window, stride, "mean"),
        frame_reduce(torch.square(low_p), window, stride, "sum"),
        frame_reduce(torch.square(rect_p), window, stride, "sum"),
        frame_reduce(rect_p, window, stride, "mean"),
    ], dim=-1)
    return feats.transpose(1, 2)


def time_domain_loss(x_real: torch.Tensor, x_generated: torch.Tensor,
                     window: int, stride: int) -> torch.Tensor:
    """Mean L1 between generated and detached real TD features."""
    with torch.no_grad():
        feats_real = time_domain_features(x_real, window, stride)
    feats_gen = time_domain_features(x_generated, window, stride)
    return torch.mean(torch.abs(feats_gen - feats_real))


def multi_time_domain_loss(
        x_real: torch.Tensor, x_generated: torch.Tensor,
        windows: Sequence[Tuple[int, int]] = DEFAULT_TD_WINDOWS
) -> torch.Tensor:
    """Sum of TD losses over the window configurations."""
    return sum(time_domain_loss(x_real, x_generated, w, s) for w, s in windows)
