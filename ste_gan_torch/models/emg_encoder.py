"""Conv-transformer EMG encoder: 800 Hz EMG -> 50 Hz (speech units,
phoneme logits). Counterpart of ``ste_gan_tpu/models/emg_encoder.py``.

Four stride-2 BatchNorm ResBlocks (x16 downsampling), a linear projection,
post-norm transformer layers with relative positions, and two linear heads.
In the GAN step the encoder is frozen and runs in eval mode (running
statistics, no dropout); gradients still flow to its input.

Like the flax module, the mode is an argument of the forward, not the
module's ``training`` flag. ``train=True`` (encoder pre-training) applies
the random left shift it is given, normalises with the batch statistics and
updates the running ones with flax's semantics (see :func:`batch_norm`),
and draws dropout from the ``torch.Generator`` it is given.

Under data parallelism (``group``) each rank runs its rows of the global
batch, and the forward computes what the JAX step computes over its whole
mesh: BatchNorm statistics over the global batch (the sums and sums of
squares are all-reduced, with a gradient), and dropout masks drawn in the
global batch's shape from the shared generator and sliced to the rank's
rows, so the masks are those of one device.

Under tensor parallelism (``parallel/tensor_parallel.py``) each ResBlock
conv computes its output-channel slab and the BatchNorm after it runs on
that slab with the slab's parameters and running statistics (over
``group`` in train mode, as above); the block's output is gathered. The
dense and attention layers split as ``models/transformer.py`` says. The
GAN step's frozen encoder stays replicated.

:meth:`EMGEncoderTransformer.pipelined` runs the transformer stack as a
GPipe pipeline over stage ranks (``parallel/pipeline_parallel.py``); the
frontend and heads run on every stage rank. Under data parallelism an MoE
block routes the whole batch's tokens (``group``, ``models/moe.py``).

Takes channel-last ``[B, T, C]`` EMG; module paths follow the reference
state-dict layout (``conv_blocks.i``, ``transformer.layers.i``).
``moe_experts > 0`` gives every transformer layer a mixture-of-experts FFN
(``transformer.layers.i.moe_ffn``; ``configs/emg_encoder/
conv_transformer_moe.yaml``); a training forward records each block's
load-balancing loss, which :meth:`pop_moe_aux_loss` collects.
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
from ste_gan_torch.parallel.mesh import all_reduce_sum, rank_and_size
from ste_gan_torch.parallel.tensor_parallel import (
    copy_to_model, gather_from_model)


def batch_norm(x, bn: nn.BatchNorm1d, dtype, train: bool = False,
               group=None):
    """BatchNorm of ``x [B, C, T]`` computed in f32, result in ``dtype``.

    Eval: the running statistics. Train: flax's ``nn.BatchNorm(momentum=0.9)``,
    not torch's train mode: normalise with the biased batch variance over
    (batch, time), and move the running statistics by ``0.1`` towards the
    batch mean and the *biased* batch variance (torch would use the
    unbiased one), without gradient. The ``BatchNorm1d`` module holds the
    parameters and buffers in the reference layout.

    ``group`` (train mode): ``x`` is this rank's rows; the statistics are
    those of every rank's rows together, from all-reduced f32 sums and
    sums of squares (``E[x^2] - E[x]^2``, as flax computes them), and the
    gradient flows through the all-reduce."""
    xf = x.float()
    if not train:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps).to(dtype)
    if group is not None:
        _, size = rank_and_size(group)
        count = xf.shape[0] * xf.shape[2] * size
        sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2)),
                                           (xf * xf).sum(dim=(0, 2))]),
                              group)
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            decay = 1.0 - bn.momentum
            bn.running_mean.copy_(decay * bn.running_mean
                                  + bn.momentum * mean)
            bn.running_var.copy_(decay * bn.running_var + bn.momentum * var)
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        return ((xf - mean[None, :, None]) * scale[None, :, None]
                + bn.bias[None, :, None]).to(dtype)
    with torch.no_grad():
        var, mean = torch.var_mean(xf, dim=(0, 2), correction=0)
        decay = 1.0 - bn.momentum
        bn.running_mean.copy_(decay * bn.running_mean + bn.momentum * mean)
        bn.running_var.copy_(decay * bn.running_var + bn.momentum * var)
    return F.batch_norm(xf, None, None, bn.weight, bn.bias, True, 0.0,
                        bn.eps).to(dtype)


def _slab_of(x, tp) -> torch.Tensor:
    """This model rank's slab of the channels of ``x [B, C, T]``."""
    n = x.shape[1] // tp.size
    return x[:, tp.rank * n:(tp.rank + 1) * n]


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

    def forward(self, x, train: bool = False, group=None):
        """``group``: the data-parallel ranks (train mode). Split convs
        give their slabs to their BatchNorms; the output is gathered."""
        dt = self.dtype
        tp = self.conv1.tp
        h = F.relu(batch_norm(self.conv1(x, gather=False), self.bn1, dt,
                              train, group))
        if tp is not None:
            h = gather_from_model(h, 1, tp.group, tp.comm)
        h = batch_norm(self.conv2(h, gather=False), self.bn2, dt, train,
                       group)
        if self.residual_path is not None:
            res = batch_norm(self.residual_path(x, gather=False),
                             self.res_norm, dt, train, group)
        elif tp is not None:
            res = _slab_of(copy_to_model(x, tp.group, tp.comm), tp)
        else:
            res = x
        out = F.relu(h + res)
        return out if tp is None else gather_from_model(out, 1, tp.group,
                                                        tp.comm)


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
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.5,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.dropout = dropout
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
                relative_positional_distance, dtype, generator,
                moe_experts=moe_experts, moe_top_k=moe_top_k,
                moe_capacity_factor=moe_capacity_factor)
            for _ in range(num_transformer_layers)])
        self.w_out = torch_linear(model_size, num_outs, generator)
        self.w_aux = torch_linear(model_size, num_aux_outs, generator)

    def _frontend(self, x_raw, train: bool, shift: int,
                  group=None) -> torch.Tensor:
        """Shift augmentation, strided ResBlocks and the input projection.
        ``shift = r`` moves every window left by ``r`` samples and fills its
        last ``r`` with zeros, as the JAX roll-and-mask does (reference
        random shift in [0, 8), ste_gan/models/emg_encoder.py:71-75); the
        caller draws ``r``."""
        dt = self.dtype
        x = x_raw.to(dt)
        if train and shift:
            x = F.pad(x[:, shift:], (0, 0, 0, shift))
        x = x.transpose(1, 2)
        for block in self.conv_blocks:
            x = block(x, train, group)
        return linear(x.transpose(1, 2), self.w_raw_in, dt)

    def forward(self, x_raw, train: bool = False, shift: int = 0,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train=True``: shift by ``shift``, batch statistics (running ones
        updated in place) and dropout drawn from ``generator`` (on the
        input's device; required when dropout is on). ``group`` (train
        mode): ``x_raw`` is this rank's equal share of the global batch."""
        if train and self.dropout > 0 and generator is None:
            raise ValueError("a train-mode forward with dropout needs a "
                             "torch.Generator for its masks")
        dt = self.dtype
        rows = rank_and_size(group) if train and group is not None else None
        x = self._frontend(x_raw, train, shift, group if train else None)
        for layer in self.transformer.layers:
            x = layer(x, generator if train else None, train=train,
                      rows=rows, group=group if train else None)
        return self._heads(x)

    def _heads(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        return (linear(x, self.w_out, dt).float(),
                linear(x, self.w_aux, dt).float())

    def pipelined(self, x_raw, mesh, num_microbatches: int,
                  train: bool = False, shift: int = 0,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward with the transformer stack run as a GPipe pipeline
        over ``mesh``'s stage ranks (``parallel/pipeline_parallel.py``);
        the conv frontend and the heads run on every stage rank under data
        parallelism over ``mesh.data``. ``x_raw``: this data rank's rows of
        every microbatch (``pipeline_parallel.microbatch_rows`` of the
        global batch); the predictions are those rows', the same on every
        stage rank. Each rank applies only its stage's layers (it may hold
        no others: ``shard_stages_``).

        Train mode: BatchNorm statistics over the data group (every stage
        rank runs the frontend, so the running statistics move alike on
        each), and every layer's dropout masks drawn from ``generator`` for
        the whole global batch, in the order of a one-device forward, then
        sliced to each microbatch's rows: the masks, and the generator's
        state after the step, are one device's (JAX shares one mask over
        the microbatches instead). MoE layers are not pipelined."""
        from ste_gan_torch.models.transformer import DrawnMasks
        from ste_gan_torch.parallel.pipeline_parallel import (
            pipeline_local, stage_layers, stage_range)

        if self.moe_experts > 0:
            raise NotImplementedError(
                "pipelined execution of MoE layers is unsupported — use "
                "expert parallelism (parallel/expert_parallel.py) instead")
        layers = self.transformer.layers
        own = stage_range(len(layers), mesh.stage_rank, mesh.num_stages)
        if train and self.dropout > 0 and generator is None:
            raise ValueError("a train-mode forward with dropout needs a "
                             "torch.Generator for its masks")
        x = self._frontend(x_raw, train, shift, mesh.data if train else None)
        masks = {}
        if train and self.dropout > 0:
            keep = 1.0 - self.dropout
            batch = x.shape[0] * mesh.data_size
            for i, layer in enumerate(layers):
                for shape in layer.dropout_draw_shapes(batch, x.shape[1]):
                    draw = torch.rand(shape, generator=generator,
                                      device=x.device)
                    if i in own:
                        masks.setdefault(i, []).append(draw < keep)
        local = x.shape[0] // num_microbatches
        stage = stage_layers(self, mesh.stage_rank, mesh.num_stages)

        def stage_fn(h, mb):
            start = (mb * mesh.data_size + mesh.data_rank) * local
            for i, layer in zip(own, stage):
                gen = DrawnMasks(masks[i], start) if i in masks else None
                h = layer(h, gen, train=train)
            return h

        x = pipeline_local(stage_fn, list(stage.parameters()), x, mesh,
                           num_microbatches)
        return self._heads(x)

    def pop_moe_aux_loss(self) -> Optional[torch.Tensor]:
        """The sum of the MoE blocks' load-balancing losses recorded by the
        last training forward (None for a dense encoder), cleared."""
        losses = []
        for layer in self.transformer.layers:
            if layer.moe_ffn is not None and layer.moe_ffn.aux_loss is not None:
                losses.append(layer.moe_ffn.aux_loss)
                layer.moe_ffn.aux_loss = None
        return sum(losses) if losses else None

    def embed(self, x_raw) -> torch.Tensor:
        """Pre-head transformer-stack activations ``[B, T/16, model_size]``
        f32 in eval mode: the embedding space of the Fréchet realism metric
        (no training objective touches it directly)."""
        x = self._frontend(x_raw, False, 0)
        for layer in self.transformer.layers:
            x = layer(x)
        return x.float()


def init_emg_encoder(cfg, dtype=torch.float32,
                     generator: Optional[torch.Generator] = None
                     ) -> EMGEncoderTransformer:
    """Factory from config (counterpart of the JAX factory)."""
    if cfg.emg_encoder.type != "EMGEncoderTransformer":
        raise ValueError(f"Unknown EMG encoder type: {cfg.emg_encoder.type}")
    params = dict(cfg.emg_encoder.params or {})
    return EMGEncoderTransformer(
        num_ins=cfg.data.num_emg_channels, num_outs=C.SPEECH_UNITS_FEAT_SIZE,
        num_aux_outs=C.NUM_PHONEMES, dtype=dtype, generator=generator,
        **params)
