"""Post-norm transformer encoder layer with learned relative positional
logits (counterpart of ``ste_gan_tpu/models/transformer.py``).

Batch-first ``[B, T, D]``. Attention uses per-head projection tensors
``w_q/w_k/w_v`` ``[H, D, Dh]`` and ``w_o`` ``[H, Dh, D]``; logits and softmax
in f32. Relative positions are clipped at ``max_distance``: the learned
table is re-indexed to ``[L, L]`` with the pad/reshape skew, and beyond
``max_distance`` frames the table is zero-padded and offsets outside the
window get a -1e8 logit. The embedding keeps the reference's trailing
singleton dimension, ``[H, 2*max_distance-1, Dh, 1]``.

Dropout is applied where flax applies it (after the attention softmax, on
the attention output, and twice in the FFN) only when a forward is given a
``torch.Generator``: the masks come from that generator and nothing else,
and kept values are scaled by ``1/keep``. Without one (the eval path and
the frozen encoder of the GAN step) no dropout runs. A :class:`DrawnMasks`
in the generator's place replays masks drawn ahead
(:meth:`TransformerEncoderLayer.dropout_draw_shapes`), sliced to a block of
rows: the pipelined encoder draws each layer's masks for the whole batch
and runs them microbatch by microbatch.

``moe_experts > 0`` swaps a layer's dense FFN for the mixture-of-experts
block (``models/moe.py``, path ``moe_ffn``), followed by one dropout, as the
JAX layer does; dense layers are unchanged.

Under tensor parallelism (``parallel/tensor_parallel.py``) a split dense
layer computes its output slab from its ``copy_to_model`` input and
gathers it; ``w_q``/``w_k``/``w_v`` split on ``Dh`` give slabs of q/k/v
that are gathered, so attention runs on full tensors; ``w_o`` splits on
``D``; a split LayerNorm and the split relative-position table are
gathered where they are used. Every dropout then draws its full-size mask
from the same generator on every model rank.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch.models.moe import MoEFeedForward
from ste_gan_torch.parallel.tensor_parallel import (
    copy_to_model, gather_from_model)


def _tp(module: nn.Module):
    """The module's ``ModelShard`` when its leaves are split, else None."""
    return getattr(module, "tp", None)


def linear(x, layer: nn.Linear, dtype):
    """``x @ W.T + b`` in ``dtype``, bias added after the product as in the
    JAX ``Dense``. A split layer computes its slab of outputs and gathers
    them."""
    tp = _tp(layer)
    if tp is not None:
        x = copy_to_model(x, tp.group, tp.comm)
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).T)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y if tp is None else gather_from_model(y, -1, tp.group, tp.comm)


def torch_linear(fan_in: int, fan_out: int, generator=None) -> nn.Linear:
    """nn.Linear with PyTorch's default U(+-1/sqrt(fan_in)) init drawn from
    ``generator``."""
    layer = nn.Linear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class DrawnMasks:
    """Dropout keep-masks drawn ahead for a whole batch, replayed in the
    order the forward asks for them, each sliced to rows ``[start, start +
    n)`` of its leading axis (``n``: the rows of the tensor it masks)."""

    def __init__(self, masks, start: int = 0):
        self._masks = iter(masks)
        self.start = start

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return next(self._masks)[self.start:self.start + x.shape[0]]


def dropout(x, rate: float, generator: Optional[torch.Generator],
            rows: Optional[Tuple[int, int]] = None):
    """flax's ``nn.Dropout``: keep each value with probability ``1 - rate``
    and scale it by ``1/(1 - rate)``; masks drawn from ``generator``. The
    identity when ``generator`` is None or ``rate`` is 0. ``rows = (rank,
    ranks)``: ``x`` is a rank's equal share of the leading axis; the mask
    is drawn for the whole axis and sliced, so every rank advances the
    generator alike and the masks equal one device's. A
    :class:`DrawnMasks` generator gives its next mask instead."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, DrawnMasks):
        return torch.where(generator.take(x), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    if rows is None:
        draw = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        rank, size = rows
        n = x.shape[0]
        draw = torch.rand((size * n,) + tuple(x.shape[1:]),
                          generator=generator,
                          device=x.device)[rank * n:(rank + 1) * n]
    mask = draw < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def layer_norm(x, norm: nn.LayerNorm, dtype):
    """LayerNorm with statistics in f32, result in ``dtype``; split
    parameters are gathered first."""
    tp = _tp(norm)
    if tp is None:
        return norm(x.float()).to(dtype)
    weight = gather_from_model(norm.weight, 0, tp.group, tp.comm)
    bias = gather_from_model(norm.bias, 0, tp.group, tp.comm)
    return F.layer_norm(x.float(), norm.normalized_shape, weight, bias,
                        norm.eps).to(dtype)


class RelativePositionalLogits(nn.Module):
    def __init__(self, max_distance: int = 100, num_heads: int = 8,
                 head_dim: int = 96, dtype=torch.float32, generator=None):
        super().__init__()
        self.max_distance = max_distance
        self.dtype = dtype
        emb = torch.empty(num_heads, 2 * max_distance - 1, head_dim, 1)
        emb.normal_(0.0, head_dim ** -0.5, generator=generator)
        self.embeddings = nn.Parameter(emb)

    def forward(self, q):
        """q ``[B, H, L, Dh]`` -> positional logits ``[B, H, L, L]``."""
        length = q.shape[2]
        emb = self.embeddings[..., 0]
        if _tp(self) is not None:
            emb = gather_from_model(emb, 2, self.tp.group, self.tp.comm)
        if length >= self.max_distance:
            pad = length - self.max_distance
            table = F.pad(emb, (0, 0, pad, pad))
        else:
            start = self.max_distance - length
            table = emb[:, start:start + 2 * length - 1]
        logits = torch.einsum("bhld,hmd->bhlm", q.to(self.dtype),
                              table.to(self.dtype))
        b, h = logits.shape[:2]
        x = F.pad(logits, (0, 1)).reshape(b, h, length * 2 * length)
        x = F.pad(x, (0, length - 1)).reshape(b, h, length + 1, 2 * length - 1)
        out = x[:, :, :length, length - 1:]
        if length > self.max_distance:
            pos = torch.arange(length, device=q.device)
            offset = pos[None, :] - pos[:, None]
            out = out + torch.where(offset.abs() >= self.max_distance,
                                    -1e8, 0.0).to(out.dtype)
        return out


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1,
                 relative_positional: bool = True,
                 relative_positional_distance: int = 100,
                 dtype=torch.float32, generator=None):
        super().__init__()
        d_qkv = d_model // num_heads
        assert d_qkv * num_heads == d_model
        self.d_qkv = d_qkv
        self.dtype = dtype
        std = math.sqrt(2.0 / ((d_model + num_heads) * d_qkv))
        std_o = math.sqrt(2.0 / ((d_qkv + num_heads) * d_model))

        def param(shape, s):
            return nn.Parameter(torch.empty(shape).normal_(0.0, s,
                                                           generator=generator))

        self.w_q = param((num_heads, d_model, d_qkv), std)
        self.w_k = param((num_heads, d_model, d_qkv), std)
        self.w_v = param((num_heads, d_model, d_qkv), std)
        self.w_o = param((num_heads, d_qkv, d_model), std_o)
        self.dropout_rate = dropout
        self.relative_positional = (
            RelativePositionalLogits(relative_positional_distance, num_heads,
                                     d_qkv, dtype, generator)
            if relative_positional else None)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None):
        dt = self.dtype
        tp = _tp(self)
        split = tp.split if tp is not None else frozenset()
        xc = x.to(dt)
        if "w_q" in split:
            xc = copy_to_model(xc, tp.group, tp.comm)

        def project(w):
            y = torch.einsum("btf,hfa->bhta", xc, w.to(dt))
            if "w_q" not in split:
                return y
            return gather_from_model(y, -1, tp.group, tp.comm)

        q, k, v = project(self.w_q), project(self.w_k), project(self.w_v)
        logits = torch.einsum("bhqa,bhka->bhqk", q, k).float() / math.sqrt(
            self.d_qkv)
        if self.relative_positional is not None:
            logits = logits + self.relative_positional(q).float()
        probs = dropout(torch.softmax(logits, dim=-1).to(dt),
                        self.dropout_rate, generator, rows)
        o = torch.einsum("bhqk,bhka->bhqa", probs, v)
        if "w_o" not in split:
            return torch.einsum("bhta,haf->btf", o, self.w_o.to(dt))
        out = torch.einsum("bhta,haf->btf",
                           copy_to_model(o, tp.group, tp.comm),
                           self.w_o.to(dt))
        return gather_from_model(out, -1, tp.group, tp.comm)


class TransformerEncoderLayer(nn.Module):
    """Post-norm layer: LN(x + MHA(x)), then LN(x + FFN(x)) with ReLU."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 relative_positional: bool = True,
                 relative_positional_distance: int = 100,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.5):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, dropout, relative_positional,
            relative_positional_distance, dtype, generator)
        self.moe_ffn = None
        if moe_experts > 0:
            self.moe_ffn = MoEFeedForward(d_model, moe_experts, dim_feedforward,
                                          moe_top_k, moe_capacity_factor, dtype,
                                          generator)
        else:
            self.linear1 = torch_linear(d_model, dim_feedforward, generator)
            self.linear2 = torch_linear(dim_feedforward, d_model, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout_rate = dropout
        self.num_heads = num_heads
        self.d_model = d_model
        self.dim_feedforward = dim_feedforward

    def dropout_draw_shapes(self, batch: int, length: int):
        """The shapes of the masks a training forward of ``[batch, length,
        D]`` draws, in the order it draws them (none at rate 0)."""
        if self.dropout_rate == 0.0:
            return []
        b, t, d = batch, length, self.d_model
        ffn = ([(b, t, d)] if self.moe_ffn is not None
               else [(b, t, self.dim_feedforward), (b, t, d)])
        return [(b, self.num_heads, t, t), (b, t, d)] + ffn

    def forward(self, x, generator: Optional[torch.Generator] = None,
                train: bool = False, rows: Optional[Tuple[int, int]] = None,
                group=None):
        """``generator`` given: training-mode dropout drawn from it.
        ``train``: an MoE block records its load-balancing loss. ``rows``:
        see :func:`dropout`. ``group``: the data-parallel ranks whose tokens
        an MoE block routes together (``models/moe.py``)."""
        dt, p = self.dtype, self.dropout_rate
        attn = dropout(self.self_attn(x, generator, rows), p, generator, rows)
        x = layer_norm(x + attn, self.norm1, dt)
        if self.moe_ffn is not None:
            h = dropout(self.moe_ffn(x, train, group), p, generator, rows)
        else:
            h = dropout(F.relu(linear(x, self.linear1, dt)), p, generator,
                        rows)
            h = dropout(linear(h, self.linear2, dt), p, generator, rows)
        return layer_norm(x + h, self.norm2, dt)
