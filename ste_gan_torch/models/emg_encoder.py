"""Conv-transformer EMG encoder: 800 Hz EMG -> 50 Hz (speech units,
phoneme logits). Counterpart of ``ste_gan_tpu/models/emg_encoder.py``.

Four stride-2 BatchNorm ResBlocks (x16 downsampling), a linear projection,
post-norm transformer layers with relative positions, and two linear heads.
In the GAN step the encoder is frozen and runs in eval mode (running
statistics, no dropout); gradients still flow to its input. The train-only
random shift of encoder pre-training is not part of this port yet.

Takes channel-last ``[B, T, C]`` EMG; module paths follow the reference
state-dict layout (``conv_blocks.i``, ``transformer.layers.i``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch.models.transformer import (
    TransformerEncoderLayer, linear, torch_linear)
from ste_gan_torch.ops.conv import Conv


def batch_norm(x, bn: nn.BatchNorm1d, dtype):
    """BatchNorm computed in f32 (statistics are f32), result in ``dtype``."""
    return bn(x.float()).to(dtype)


class ResBlock(nn.Module):
    """conv-BN-ReLU, conv-BN, plus a strided 1x1 conv + BN residual path."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_channels, features, 3, stride=stride, padding=1,
                          dtype=dtype, generator=generator)
        self.bn1 = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dtype,
                          generator=generator)
        self.bn2 = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)
        self.residual_path = None
        if stride != 1 or in_channels != features:
            self.residual_path = Conv(in_channels, features, 1, stride=stride,
                                      dtype=dtype, generator=generator)
            self.res_norm = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        dt = self.dtype
        h = F.relu(batch_norm(self.conv1(x), self.bn1, dt))
        h = batch_norm(self.conv2(h), self.bn2, dt)
        res = x
        if self.residual_path is not None:
            res = batch_norm(self.residual_path(x), self.res_norm, dt)
        return F.relu(h + res)


class EMGEncoderTransformer(nn.Module):
    """EMG ``[B, T, C]`` -> (speech units ``[B, T/16, 256]``, phoneme logits
    ``[B, T/16, 48]``), both f32."""

    def __init__(self, num_ins: int = C.NUM_EMG_CHANNELS,
                 num_outs: int = C.SPEECH_UNITS_FEAT_SIZE,
                 num_aux_outs: int = C.NUM_PHONEMES, model_size: int = 768,
                 num_extra_res_blocks: int = 3, dropout: float = 0.2,
                 num_transformer_layers: int = 6, num_heads: int = 8,
                 dim_feedforward: int = 3072,
                 relative_positional_distance: int = 100,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        blocks, cin = [], num_ins
        for _ in range(1 + num_extra_res_blocks):
            blocks.append(ResBlock(cin, model_size, 2, dtype, generator))
            cin = model_size
        self.conv_blocks = nn.ModuleList(blocks)
        self.w_raw_in = torch_linear(model_size, model_size, generator)
        # ``transformer.layers.i``: the reference's module path.
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList([
            TransformerEncoderLayer(
                model_size, num_heads, dim_feedforward, dropout, True,
                relative_positional_distance, dtype, generator)
            for _ in range(num_transformer_layers)])
        self.w_out = torch_linear(model_size, num_outs, generator)
        self.w_aux = torch_linear(model_size, num_aux_outs, generator)

    def forward(self, x_raw) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        x = x_raw.to(dt).transpose(1, 2)
        for block in self.conv_blocks:
            x = block(x)
        x = linear(x.transpose(1, 2), self.w_raw_in, dt)
        for layer in self.transformer.layers:
            x = layer(x)
        return (linear(x, self.w_out, dt).float(),
                linear(x, self.w_aux, dt).float())


def init_emg_encoder(cfg, dtype=torch.float32,
                     generator: Optional[torch.Generator] = None
                     ) -> EMGEncoderTransformer:
    """Factory from config (counterpart of the JAX factory)."""
    if cfg.emg_encoder.type != "EMGEncoderTransformer":
        raise ValueError(f"Unknown EMG encoder type: {cfg.emg_encoder.type}")
    params = dict(cfg.emg_encoder.params or {})
    if params.get("moe_experts", 0):
        raise NotImplementedError("the MoE encoder is not ported yet")
    for key in ("moe_experts", "moe_top_k", "moe_capacity_factor"):
        params.pop(key, None)
    return EMGEncoderTransformer(
        num_ins=cfg.data.num_emg_channels, num_outs=C.SPEECH_UNITS_FEAT_SIZE,
        num_aux_outs=C.NUM_PHONEMES, dtype=dtype, generator=generator,
        **params)
