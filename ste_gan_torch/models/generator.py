"""GanTTS-style EMG generator: speech features + session embedding ->
8-channel 800 Hz EMG in [-1, 1].

Counterpart of ``ste_gan_tpu/models/generator.py``. Input 1x1 conv to the
model width, eight dilated-conv GBlocks (two processing, four upsampling,
two processing), ReLU + k3 output conv, tanh in f32. Every conv is
weight-normalised. Module paths follow the reference state-dict layout
(``gblocks.N`` with the optional ``nn.Upsample`` shifting the Sequential
indices), so :mod:`ste_gan_torch.interop` dicts load with ``strict=True``.

The forward takes and returns channel-last ``[B, T, C]``, like the JAX
model; inside it runs channel-first.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch.ops.conv import WNConv, upsample_nearest


def _same_pad(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def gblock_spec(speech_feature_type: str, channels: int = 768):
    """(output_dim, upsample) per GBlock (copy of the JAX package's spec)."""
    ch = channels
    upsample_last = 2 if speech_feature_type == C.DataType.SPEECH_UNITS else 1
    return (
        (ch, 1), (ch, 1),
        (ch // 2, 2), (ch // 2, 2), (ch // 2, 2), (ch // 4, upsample_last),
        (ch // 4, 1), (ch // 4, 1),
    )


class GBlock(nn.Module):
    """``y = conv1(x) + res1(x); return y + conv2(y)`` with dilations
    1/3 (conv1) and 9/27 (conv2) and optional nearest upsampling."""

    def __init__(self, input_dim: int, output_dim: int, upsample: int = 1,
                 kernel_size: int = 3, dtype=torch.float32, generator=None):
        super().__init__()
        self.upsample = upsample
        off = 1 if upsample > 1 else 0
        k = kernel_size

        def wn(cin, dilation=1, kernel=k):
            return WNConv(cin, output_dim, kernel, dilation=dilation,
                          padding=_same_pad(kernel, dilation), dtype=dtype,
                          generator=generator)

        self._names = (str(1 + off), str(3 + off), str(off))
        self.conv1 = nn.ModuleDict({self._names[0]: wn(input_dim),
                                    self._names[1]: wn(output_dim, 3)})
        self.res1 = nn.ModuleDict({self._names[2]: WNConv(
            input_dim, output_dim, 1, dtype=dtype, generator=generator)})
        self.conv2 = nn.ModuleDict({"1": wn(output_dim, 9),
                                    "3": wn(output_dim, 27)})

    def forward(self, x):
        a, b, r = self._names
        h = upsample_nearest(F.relu(x), self.upsample)
        h = self.conv1[a](h)
        h = self.conv1[b](F.relu(h))
        y = h + self.res1[r](upsample_nearest(x, self.upsample))
        h2 = self.conv2["1"](F.relu(y))
        h2 = self.conv2["3"](F.relu(h2))
        return y + h2


class EMGGeneratorGanTTS(nn.Module):
    """Speech features ``[B, T, F]`` -> EMG ``[B, factor*T, channels]``."""

    def __init__(self, speech_feature_type: str = C.DataType.SPEECH_UNITS,
                 speech_input_dim: int = C.SPEECH_UNITS_FEAT_SIZE,
                 num_sessions: int = C.NUM_EMG_SESSIONS,
                 num_emg_channels: int = C.NUM_EMG_CHANNELS,
                 use_speaking_mode_embedding: bool = False,
                 use_session_embeddings: bool = True,
                 num_speaking_modes: int = 3,
                 embedding_dim: int = C.EMBEDDING_DIM_SIZE,
                 channels: int = 768, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.speech_feature_type = speech_feature_type
        self.dtype = dtype
        in_dim = speech_input_dim
        self.session_embeddings = None
        self.speaking_mode_embeddings = None
        if use_session_embeddings:
            self.session_embeddings = nn.Embedding(num_sessions, embedding_dim)
            nn.init.normal_(self.session_embeddings.weight, 0.0, 1.0,
                            generator=generator)
            in_dim += embedding_dim
        if use_speaking_mode_embedding:
            self.speaking_mode_embeddings = nn.Embedding(num_speaking_modes,
                                                         embedding_dim)
            nn.init.normal_(self.speaking_mode_embeddings.weight, 0.0, 1.0,
                            generator=generator)
            in_dim += embedding_dim
        blocks = [WNConv(in_dim, channels, 1, dtype=dtype, generator=generator)]
        cur = channels
        for out_dim, up in gblock_spec(speech_feature_type, channels):
            blocks.append(GBlock(cur, out_dim, upsample=up, dtype=dtype,
                                 generator=generator))
            cur = out_dim
        self.gblocks = nn.ModuleList(blocks)
        self.last_conv = nn.ModuleDict({"1": WNConv(
            cur, num_emg_channels, 3, padding=1, dtype=dtype,
            generator=generator)})

    @property
    def upsample_factor(self) -> int:
        return 16 if self.speech_feature_type == C.DataType.SPEECH_UNITS else 8

    def forward(self, speech_features, session_ids, speaking_mode_ids=None):
        x = speech_features.to(self.dtype)
        b, t, _ = x.shape
        parts = [x]
        if self.session_embeddings is not None:
            emb = self.session_embeddings(session_ids).to(self.dtype)
            parts.append(emb[:, None, :].expand(b, t, emb.shape[-1]))
        if self.speaking_mode_embeddings is not None:
            emb = self.speaking_mode_embeddings(speaking_mode_ids).to(self.dtype)
            parts.append(emb[:, None, :].expand(b, t, emb.shape[-1]))
        x = torch.cat(parts, dim=-1).transpose(1, 2)
        for block in self.gblocks:
            x = block(x)
        x = self.last_conv["1"](F.relu(x))
        return torch.tanh(x.float()).transpose(1, 2)


def init_emg_generator(cfg, dtype=torch.float32,
                       generator: Optional[torch.Generator] = None
                       ) -> EMGGeneratorGanTTS:
    """Factory from config (counterpart of the JAX factory)."""
    sft = cfg.model.speech_feature_type
    if sft == C.DataType.SPEECH_UNITS:
        speech_input_dim = C.SPEECH_UNITS_FEAT_SIZE
    elif sft == C.DataType.MFCCS:
        speech_input_dim = C.NUM_MFCCS
    else:
        raise ValueError(f"Unrecognized speech feature type: {sft}")
    if cfg.model.type != "EMGGeneratorGanTTS":
        raise ValueError(f"Unrecognized EMG generator type: {cfg.model.type}")
    return EMGGeneratorGanTTS(
        speech_feature_type=sft, speech_input_dim=speech_input_dim,
        num_sessions=cfg.data.num_emg_sessions,
        num_emg_channels=cfg.data.num_emg_channels, dtype=dtype,
        generator=generator, **(cfg.model.params or {}))
