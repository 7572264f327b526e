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

:class:`EMGEncoderLFM2` (``type: EMGEncoderLFM2``, ``configs/emg_encoder/
lfm2_8b_a1b.yaml``) and :class:`EMGEncoderDeepseekV3` (``type:
EMGEncoderDeepseekV3``, ``configs/emg_encoder/kanana_2_30b_a3b.yaml``), both
:class:`SparseBlockEncoder` and without a JAX counterpart, keep the same
front end and heads around LFM2-8B-A1B's block stack (``models/lfm2.py``)
or DeepSeek-V3's as kanana-2-30b-a3b publishes it
(``models/deepseek_v3.py``), on one device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch.models import lfm2
from ste_gan_torch.models.deepseek_v3 import deepseek_v3_layers
from ste_gan_torch.models.lfm2 import (
    LAYER_TYPES, RMSNorm, lfm2_layers, sparse_blocks)
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


def conv_frontend(blocks, x_raw, dtype, train: bool, shift: int,
                  group=None) -> torch.Tensor:
    """Shift augmentation and the strided ResBlocks: EMG ``[B, T, C]`` ->
    ``[B, T/16, model_size]``. ``shift = r`` moves every window left by
    ``r`` samples and fills its last ``r`` with zeros, as the JAX
    roll-and-mask does (reference random shift in [0, 8),
    ste_gan/models/emg_encoder.py:71-75); the caller draws ``r``."""
    x = x_raw.to(dtype)
    if train and shift:
        x = F.pad(x[:, shift:], (0, 0, 0, shift))
    x = x.transpose(1, 2)
    for block in blocks:
        x = block(x, train, group)
    return x.transpose(1, 2)


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
        """:func:`conv_frontend` and the input projection."""
        x = conv_frontend(self.conv_blocks, x_raw, self.dtype, train, shift,
                          group)
        return linear(x, self.w_raw_in, self.dtype)

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


class SparseBlockEncoder(nn.Module):
    """The published encoder's front end around a block stack of a large
    sparse model: EMG ``[B, T, C]`` -> (speech units ``[B, T/16, 256]``,
    phoneme logits ``[B, T/16, 48]``), both f32.

    Four stride-2 BatchNorm ResBlocks at ``model_size`` (f32 with cuDNN's
    TF32, as ``EMGEncoderTransformer``) and ``w_raw_in`` (``model_size ->
    hidden_size``) feed ``layers`` (each ``layer(x, train)``, causal
    within each window), then a final RMSNorm and the unit and phoneme
    heads. No dropout. Parameters are f32; every product from ``w_raw_in``
    on runs in ``models/lfm2.py``'s ``COMPUTE_DTYPE`` (bf16, the published
    precision).

    Single device only: ``group`` (data parallelism), tensor and pipeline
    parallelism are not written for it. A training forward records each
    ``DroplessMoE`` block's loads; :meth:`update_expert_bias` moves the
    expert biases after the optimizer step."""

    def __init__(self, num_ins: int, num_outs: int, num_aux_outs: int,
                 model_size: int, num_extra_res_blocks: int,
                 hidden_size: int, eps: float, num_experts: int, dtype,
                 generator: Optional[torch.Generator], make_layers):
        super().__init__()
        self.dtype = dtype
        self.compute_dtype = lfm2.COMPUTE_DTYPE
        self.moe_experts = num_experts
        self.dropout = 0.0
        blocks, cin = [], num_ins
        for _ in range(1 + num_extra_res_blocks):
            blocks.append(ResBlock(cin, model_size, 2, dtype, generator))
            cin = model_size
        self.conv_blocks = nn.ModuleList(blocks)
        self.w_raw_in = torch_linear(model_size, hidden_size, generator)
        self.layers = make_layers()
        self.final_norm = RMSNorm(hidden_size, eps)
        self.w_out = torch_linear(hidden_size, num_outs, generator)
        self.w_aux = torch_linear(hidden_size, num_aux_outs, generator)

    def _stack(self, x_raw, train: bool, shift: int) -> torch.Tensor:
        x = conv_frontend(self.conv_blocks, x_raw, self.dtype, train, shift)
        x = linear(x, self.w_raw_in, self.compute_dtype).float()
        for layer in self.layers:
            x = layer(x, train)
        return self.final_norm(x)

    def forward(self, x_raw, train: bool = False, shift: int = 0,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train=True``: shift by ``shift``, batch statistics in the front
        end (running ones updated in place) and the sparse blocks' loads
        recorded. ``generator`` is unused (no dropout)."""
        if group is not None:
            raise NotImplementedError(
                f"{type(self).__name__} runs on one device: data "
                "parallelism over its routing and expert biases is not "
                "written")
        x = self._stack(x_raw, train, shift)
        dt = self.compute_dtype
        return (linear(x, self.w_out, dt).float(),
                linear(x, self.w_aux, dt).float())

    def pop_moe_aux_loss(self) -> Optional[torch.Tensor]:
        """None: the sparse blocks balance by their biases, with no
        auxiliary loss."""
        return None

    def update_expert_bias(self) -> None:
        """Each sparse block's bias update over its last training loads."""
        for block in sparse_blocks(self.layers):
            block.update_bias()

    def embed(self, x_raw) -> torch.Tensor:
        """The final norm's output ``[B, T/16, hidden_size]`` f32 in eval
        mode (the Fréchet realism metric's embedding space)."""
        return self._stack(x_raw, False, 0).float()


class EMGEncoderLFM2(SparseBlockEncoder):
    """:class:`SparseBlockEncoder` around LFM2's block stack
    (``models/lfm2.py``; LFM2-8B-A1B,
    https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json):
    ``num_hidden_layers`` LFM2 layers (``layer_types[:num_hidden_layers]``:
    gated short convs and causal GQA attention; the first
    ``num_dense_layers`` feed-forwards dense SwiGLU, the rest
    ``DroplessMoE``)."""

    def __init__(self, num_ins: int = C.NUM_EMG_CHANNELS,
                 num_outs: int = C.SPEECH_UNITS_FEAT_SIZE,
                 num_aux_outs: int = C.NUM_PHONEMES, model_size: int = 768,
                 num_extra_res_blocks: int = 3, hidden_size: int = 2048,
                 num_hidden_layers: int = 8,
                 layer_types=LAYER_TYPES, num_attention_heads: int = 32,
                 num_key_value_heads: int = 8,
                 intermediate_size: int = 7168,
                 moe_intermediate_size: int = 1792,
                 num_dense_layers: int = 2, num_experts: int = 32,
                 num_experts_per_tok: int = 4, conv_L_cache: int = 3,
                 conv_bias: bool = False, norm_eps: float = 1e-5,
                 rope_theta: float = 1e6, norm_topk_prob: bool = True,
                 routed_scaling_factor: float = 1.0,
                 use_expert_bias: bool = True, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        if conv_bias:
            raise ValueError("EMGEncoderLFM2: conv_bias is not written "
                             "(LFM2-8B-A1B has none)")
        if len(layer_types) < num_hidden_layers:
            raise ValueError(f"layer_types names {len(layer_types)} layers, "
                             f"num_hidden_layers is {num_hidden_layers}")
        super().__init__(
            num_ins, num_outs, num_aux_outs, model_size,
            num_extra_res_blocks, hidden_size, norm_eps, num_experts, dtype,
            generator, lambda: lfm2_layers(
                layer_types[:num_hidden_layers], num_dense_layers,
                dim=hidden_size, heads=num_attention_heads,
                kv_heads=num_key_value_heads, dense_hidden=intermediate_size,
                expert_hidden=moe_intermediate_size, num_experts=num_experts,
                top_k=num_experts_per_tok, taps=conv_L_cache, eps=norm_eps,
                theta=rope_theta, norm_topk_prob=norm_topk_prob,
                scaling=routed_scaling_factor,
                use_expert_bias=use_expert_bias, dtype=lfm2.COMPUTE_DTYPE,
                generator=generator))


class EMGEncoderDeepseekV3(SparseBlockEncoder):
    """:class:`SparseBlockEncoder` around DeepSeek-V3's block stack
    (``models/deepseek_v3.py``; kanana-2-30b-a3b,
    https://huggingface.co/kakaocorp/kanana-2-30b-a3b-instruct-2601/blob/main/config.json):
    ``num_hidden_layers`` layers of multi-head latent attention, the first
    ``first_k_dense_replace`` with a dense SwiGLU, the rest ``DroplessMoE``
    with ``n_shared_experts`` shared experts. The keyword arguments are the
    published config's names. The stack is written for that config's
    choices: no query compression (``q_lora_rank`` null), one expert group
    (``n_group`` 1), sigmoid scores steered by the bias (``noaux_tc``),
    interleaved RoPE with no scaling."""

    def __init__(self, num_ins: int = C.NUM_EMG_CHANNELS,
                 num_outs: int = C.SPEECH_UNITS_FEAT_SIZE,
                 num_aux_outs: int = C.NUM_PHONEMES, model_size: int = 768,
                 num_extra_res_blocks: int = 3, hidden_size: int = 2048,
                 num_hidden_layers: int = 5, num_attention_heads: int = 32,
                 kv_lora_rank: int = 512, qk_nope_head_dim: int = 128,
                 qk_rope_head_dim: int = 64, v_head_dim: int = 128,
                 intermediate_size: int = 6144,
                 moe_intermediate_size: int = 768,
                 first_k_dense_replace: int = 1, n_routed_experts: int = 128,
                 num_experts_per_tok: int = 6, n_shared_experts: int = 2,
                 norm_topk_prob: bool = True,
                 routed_scaling_factor: float = 2.448,
                 rms_norm_eps: float = 1e-6, rope_theta: float = 1e6,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            num_ins, num_outs, num_aux_outs, model_size,
            num_extra_res_blocks, hidden_size, rms_norm_eps,
            n_routed_experts, dtype, generator, lambda: deepseek_v3_layers(
                num_hidden_layers, first_k_dense_replace, dim=hidden_size,
                heads=num_attention_heads, kv_lora_rank=kv_lora_rank,
                qk_nope_head_dim=qk_nope_head_dim,
                qk_rope_head_dim=qk_rope_head_dim, v_head_dim=v_head_dim,
                dense_hidden=intermediate_size,
                expert_hidden=moe_intermediate_size,
                num_experts=n_routed_experts, top_k=num_experts_per_tok,
                n_shared_experts=n_shared_experts,
                norm_topk_prob=norm_topk_prob, scaling=routed_scaling_factor,
                eps=rms_norm_eps, theta=rope_theta,
                dtype=lfm2.COMPUTE_DTYPE, generator=generator))


ENCODER_TYPES = {"EMGEncoderTransformer": EMGEncoderTransformer,
                 "EMGEncoderLFM2": EMGEncoderLFM2,
                 "EMGEncoderDeepseekV3": EMGEncoderDeepseekV3}


def init_emg_encoder(cfg, dtype=torch.float32,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
    """Factory from config (counterpart of the JAX factory; the JAX package
    has neither sparse-block encoder)."""
    if cfg.emg_encoder.type not in ENCODER_TYPES:
        raise ValueError(f"Unknown EMG encoder type: {cfg.emg_encoder.type}")
    params = dict(cfg.emg_encoder.params or {})
    return ENCODER_TYPES[cfg.emg_encoder.type](
        num_ins=cfg.data.num_emg_channels, num_outs=C.SPEECH_UNITS_FEAT_SIZE,
        num_aux_outs=C.NUM_PHONEMES, dtype=dtype, generator=generator,
        **params)
