"""Multi-period + multi-scale discriminator ensemble over 8-channel EMG.

Counterpart of ``ste_gan_tpu/models/discriminator.py``: five period
discriminators (periods 2/3/5/7/11) fold time into a 2-D view and apply
(k, 1) convs; three scale discriminators apply grouped 1-D convs (the
hand-written Hopper kernel) with AvgPool(4, 2, 1) between scales; the first
scale discriminator is spectrally normalised, everything else
weight-normalised. Each sub-discriminator returns its post-LeakyReLU feature
maps with the raw logits map last.

The ensemble takes channel-last ``[B, T, C]`` input like the JAX model and
returns feature maps channel-first (``[B, C, T]`` for the scale
discriminators, ``[B, C, T/p, p]`` for the period ones; the JAX layout moves
the channel axis last). Module paths follow the reference state-dict layout
(``multi_pooled_disc.i.layers.j``, ``multi_scale_disc.i.output``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch.ops.conv import SNConv, WNConv, avg_pool1d, reflect_pad_time

LEAKY_SLOPE = 0.1

SMALL_PERIOD_SPEC = ((32, 3, 1, 2), (256, 3, 3, 2), (512, 3, 3, 2))
SMALL_SCALE_SPEC = ((128, 15, 1, 1, 7), (256, 37, 2, 4, 18),
                    (512, 37, 2, 16, 18), (1024, 5, 1, 1, 2))
FULL_PERIOD_SPEC = ((32, 5, 3, 2), (128, 5, 3, 2), (512, 5, 3, 2),
                    (1024, 5, 3, 2), (1024, 5, 1, 2))
FULL_SCALE_SPEC = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20),
                   (256, 41, 2, 16, 20), (512, 41, 4, 16, 20),
                   (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
                   (1024, 5, 1, 1, 2))
PRIME_PERIODS = (2, 3, 5, 7, 11)


class _FmapDiscriminator(nn.Module):
    def run_layers(self, x, dual_batch=None) -> List[torch.Tensor]:
        fmaps = []
        for layer in self.layers:
            if isinstance(layer, SNConv):
                x = layer(x, dual_batch=dual_batch)
            else:
                x = layer(x)
            x = F.leaky_relu(x, LEAKY_SLOPE)
            fmaps.append(x)
        fmaps.append(self.output(x))
        return fmaps


class PeriodDiscriminator(_FmapDiscriminator):
    """Folds ``[B, C, T]`` into ``[B, C, T/p, p]`` and applies (k, 1) convs.
    ``layer_spec`` rows: (features, kernel_h, stride_h, pad_h)."""

    def __init__(self, period: int, layer_spec: Sequence, in_channels: int,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.period = period
        layers, cin = [], in_channels
        for feats, k, s, pad in layer_spec:
            layers.append(WNConv(cin, feats, (k, 1), stride=(s, 1),
                                 padding=(pad, 0), dtype=dtype,
                                 generator=generator))
            cin = feats
        self.layers = nn.ModuleList(layers)
        self.output = WNConv(cin, 1, (3, 1), padding=(1, 0), dtype=dtype,
                             generator=generator)

    def forward(self, x):
        p = self.period
        # The reference pads by p - T % p: a full extra period when T is
        # already divisible.
        x = reflect_pad_time(x, (0, p - x.shape[-1] % p))
        b, c, t = x.shape
        return self.run_layers(x.view(b, c, t // p, p))


class ScaleDiscriminator(_FmapDiscriminator):
    """Grouped 1-D conv stack. ``layer_spec`` rows:
    (features, kernel, stride, groups, pad)."""

    def __init__(self, layer_spec: Sequence, in_channels: int,
                 norm: str = "weight_norm", dtype=torch.float32,
                 generator=None):
        super().__init__()
        conv_cls = {"weight_norm": WNConv, "spectral_norm": SNConv}[norm]
        layers, cin = [], in_channels
        for feats, k, s, g, pad in layer_spec:
            layers.append(conv_cls(cin, feats, k, stride=s, padding=pad,
                                   groups=g, dtype=dtype, generator=generator))
            cin = feats
        self.layers = nn.ModuleList(layers)
        self.output = WNConv(cin, 1, 3, padding=1, dtype=dtype,
                             generator=generator)

    def forward(self, x, dual_batch: Optional[int] = None):
        return self.run_layers(x, dual_batch)


class DiscriminatorEnsemble(nn.Module):
    """5 period + 3 scale discriminators. ``forward(x)`` returns one fmap
    list per sub-discriminator; ``forward(x, pair=y)`` evaluates (x, y) in
    one pass on the stacked batch and returns both lists. In pair mode the
    spectrally-normalised ``scale_0`` runs with dual sigma when training,
    so its power iteration advances as in two sequential forwards."""

    def __init__(self, num_emg_channels: int = C.NUM_EMG_CHANNELS,
                 small: bool = True, num_multi_pool: int = 5,
                 num_multi_scale: int = 3, dtype=torch.float32,
                 period_spec_override=None, scale_spec_override=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        period_spec = period_spec_override or (
            SMALL_PERIOD_SPEC if small else FULL_PERIOD_SPEC)
        scale_spec = scale_spec_override or (
            SMALL_SCALE_SPEC if small else FULL_SCALE_SPEC)
        self.multi_pooled_disc = nn.ModuleList([
            PeriodDiscriminator(PRIME_PERIODS[i], period_spec,
                                num_emg_channels, dtype, generator)
            for i in range(num_multi_pool)])
        self.multi_scale_disc = nn.ModuleList([
            ScaleDiscriminator(scale_spec, num_emg_channels,
                               "spectral_norm" if i == 0 else "weight_norm",
                               dtype, generator)
            for i in range(num_multi_scale)])

    def forward(self, x, pair=None):
        xin = x.to(self.dtype).transpose(1, 2)
        paired = pair is not None
        b = x.shape[0]
        if paired:
            xin = torch.cat([xin, pair.to(self.dtype).transpose(1, 2)], dim=0)
        results, results_pair = [], []

        def emit(fmaps):
            if paired:
                results.append([fm[:b] for fm in fmaps])
                results_pair.append([fm[b:] for fm in fmaps])
            else:
                results.append(fmaps)

        for disc in self.multi_pooled_disc:
            emit(disc(xin))
        for i, disc in enumerate(self.multi_scale_disc):
            dual = b if (paired and i == 0 and self.training) else None
            emit(disc(xin, dual_batch=dual))
            xin = avg_pool1d(xin, window=4, stride=2, padding=1)
        if paired:
            return results, results_pair
        return results


def init_emg_discriminators(cfg, dtype=torch.float32,
                            generator: Optional[torch.Generator] = None
                            ) -> DiscriminatorEnsemble:
    """Factory from config. The grouped convs take the Hopper kernel on the
    card whatever ``grouped_conv_impl`` says."""
    return DiscriminatorEnsemble(
        num_emg_channels=cfg.data.num_emg_channels,
        small=bool(cfg.model.discriminator_small), dtype=dtype,
        generator=generator,
        **(getattr(cfg.model, "discriminator_params", None) or {}))
