"""Adversarial (LS-GAN) and feature-matching losses over discriminator
feature-map lists (counterpart of ``ste_gan_tpu/losses/gan_loss.py``).
Losses reduce in f32; the real side of feature matching is detached."""
from __future__ import annotations

from typing import List

import torch

Fmaps = List[List[torch.Tensor]]


def _mse_to(x: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.square(x.float() - target))


def discriminator_loss(fmaps_fake: Fmaps, fmaps_real: Fmaps) -> torch.Tensor:
    """Sum over sub-discriminators of MSE(fake->0) + MSE(real->1)."""
    loss = 0.0
    for fmap in fmaps_fake:
        loss = loss + _mse_to(fmap[-1], 0.0)
    for fmap in fmaps_real:
        loss = loss + _mse_to(fmap[-1], 1.0)
    return loss


def generator_adversarial_loss(fmaps_fake: Fmaps) -> torch.Tensor:
    """Sum over sub-discriminators of MSE(fake->1)."""
    loss = 0.0
    for fmap in fmaps_fake:
        loss = loss + _mse_to(fmap[-1], 1.0)
    return loss


def feature_matching_loss(fmaps_fake: Fmaps, fmaps_real: Fmaps) -> torch.Tensor:
    """Sum of mean L1 over every feature map but the logits, real side
    detached."""
    loss = 0.0
    for fake_list, real_list in zip(fmaps_fake, fmaps_real):
        for fake, real in zip(fake_list[:-1], real_list[:-1]):
            loss = loss + torch.mean(torch.abs(fake.float()
                                               - real.detach().float()))
    return loss
