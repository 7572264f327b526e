"""Post-norm transformer encoder layer with learned relative positional
logits (counterpart of ``ste_gan_tpu/models/transformer.py``).

Batch-first ``[B, T, D]``. Attention uses per-head projection tensors
``w_q/w_k/w_v`` ``[H, D, Dh]`` and ``w_o`` ``[H, Dh, D]``; logits and softmax
in f32. Relative positions are clipped at ``max_distance``: the learned
table is re-indexed to ``[L, L]`` with the pad/reshape skew, and beyond
``max_distance`` frames the table is zero-padded and offsets outside the
window get a -1e8 logit. The embedding keeps the reference's trailing
singleton dimension, ``[H, 2*max_distance-1, Dh, 1]``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x, layer: nn.Linear, dtype):
    """``x @ W.T + b`` in ``dtype``, bias added after the product as in the
    JAX ``Dense``."""
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).T)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


def torch_linear(fan_in: int, fan_out: int, generator=None) -> nn.Linear:
    """nn.Linear with PyTorch's default U(+-1/sqrt(fan_in)) init drawn from
    ``generator``."""
    layer = nn.Linear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def layer_norm(x, norm: nn.LayerNorm, dtype):
    """LayerNorm with statistics in f32, result in ``dtype``."""
    return norm(x.float()).to(dtype)


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
        self.dropout = nn.Dropout(dropout)
        self.relative_positional = (
            RelativePositionalLogits(relative_positional_distance, num_heads,
                                     d_qkv, dtype, generator)
            if relative_positional else None)

    def forward(self, x):
        dt = self.dtype
        xc = x.to(dt)
        q = torch.einsum("btf,hfa->bhta", xc, self.w_q.to(dt))
        k = torch.einsum("btf,hfa->bhta", xc, self.w_k.to(dt))
        v = torch.einsum("btf,hfa->bhta", xc, self.w_v.to(dt))
        logits = torch.einsum("bhqa,bhka->bhqk", q, k).float() / math.sqrt(
            self.d_qkv)
        if self.relative_positional is not None:
            logits = logits + self.relative_positional(q).float()
        probs = self.dropout(torch.softmax(logits, dim=-1).to(dt))
        o = torch.einsum("bhqk,bhka->bhqa", probs, v)
        return torch.einsum("bhta,haf->btf", o, self.w_o.to(dt))


class TransformerEncoderLayer(nn.Module):
    """Post-norm layer: LN(x + MHA(x)), then LN(x + FFN(x)) with ReLU."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 relative_positional: bool = True,
                 relative_positional_distance: int = 100,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(
            d_model, num_heads, dropout, relative_positional,
            relative_positional_distance, dtype, generator)
        self.linear1 = torch_linear(d_model, dim_feedforward, generator)
        self.linear2 = torch_linear(dim_feedforward, d_model, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        dt = self.dtype
        x = layer_norm(x + self.dropout(self.self_attn(x)), self.norm1, dt)
        h = self.dropout(F.relu(linear(x, self.linear1, dt)))
        h = self.dropout(linear(h, self.linear2, dt))
        return layer_norm(x + h, self.norm2, dt)
