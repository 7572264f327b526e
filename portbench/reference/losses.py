"""STE-GAN's losses in plain PyTorch, all reduced in f32.

* LS-GAN: D sums MSE(fake logits, 0) + MSE(real logits, 1) over the eight
  sub-discriminators, G sums MSE(fake logits, 1).
* Feature matching: the sum over sub-discriminators and feature maps (the
  logits excluded) of the mean L1 to the detached real maps.
* Multi-window time-domain loss: the signal's double 9-point moving average
  (reflect padded) and the rectified residual; per window (20, 8), (51, 13),
  (80, 16), reflect padded by half the window, the framed mean and power of
  the low part and power and mean of the rectified part, compared by mean
  L1 against the detached real features and summed over the windows.
* Encoder losses: the mean euclidean distance between unit vectors (1e-6
  added to the difference) and the mean phoneme cross-entropy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TD_WINDOWS = ((20, 8), (51, 13), (80, 16))


def _mse(x, target: float):
    return torch.mean(torch.square(x.float() - target))


def d_loss(fake_maps, real_maps):
    return (sum(_mse(f[-1], 0.0) for f in fake_maps)
            + sum(_mse(r[-1], 1.0) for r in real_maps))


def g_adversarial(fake_maps):
    return sum(_mse(f[-1], 1.0) for f in fake_maps)


def feature_matching(fake_maps, real_maps):
    total = 0.0
    for fl, rl in zip(fake_maps, real_maps):
        for f, r in zip(fl[:-1], rl[:-1]):
            total = total + torch.mean(torch.abs(f.float()
                                                 - r.detach().float()))
    return total


def _moving_average(x, window: int):
    c, half = x.shape[1], window // 2
    x = F.pad(x, (half, half), mode="reflect")
    kernel = torch.full((c, 1, window), 1.0 / window, dtype=x.dtype,
                        device=x.device)
    return F.conv1d(x, kernel, groups=c)


def _frames(x, window: int, stride: int, mean: bool):
    c, t = x.shape[1], x.shape[2]
    n = (t - window) // stride + 1
    x = x[..., :(n - 1) * stride + window]
    kernel = torch.full((c, 1, window), 1.0 / window if mean else 1.0,
                        dtype=x.dtype, device=x.device)
    return F.conv1d(x, kernel, stride=stride, groups=c)


def td_features(x, window: int, stride: int):
    x = x.float().transpose(1, 2)
    low = _moving_average(_moving_average(x, 9), 9)
    rect = torch.abs(x - low)
    pad = window // 2
    low_p = F.pad(low, (pad, pad), mode="reflect")
    rect_p = F.pad(rect, (pad, pad), mode="reflect")
    return torch.stack([
        _frames(low_p, window, stride, True),
        _frames(torch.square(low_p), window, stride, False),
        _frames(torch.square(rect_p), window, stride, False),
        _frames(rect_p, window, stride, True)], dim=-1)


def multi_td(real, fake):
    total = 0.0
    for window, stride in TD_WINDOWS:
        with torch.no_grad():
            fr = td_features(real, window, stride)
        total = total + torch.mean(torch.abs(td_features(fake, window, stride)
                                             - fr))
    return total


def unit_distance(target, pred):
    diff = target.float() - pred.float() + 1e-6
    return torch.mean(torch.sqrt(torch.sum(torch.square(diff), dim=-1)))


def phoneme_ce(logits, targets):
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets.long()[..., None])[..., 0])
