"""LFM2's block stack (Liquid AI, LFM2-8B-A1B,
https://huggingface.co/LiquidAI/LFM2-8B-A1B) for the EMG encoder
(``models/emg_encoder.py`` ``EMGEncoderLFM2``). No counterpart in the JAX
package.

Each layer is ``h = x + mixer(RMSNorm(x))``, ``out = h + ffn(RMSNorm(h))``
on a residual stream kept in f32. ``layer_types`` picks the mixer:

* ``conv``: the gated short convolution. ``in_proj`` gives ``B``, ``C``
  and ``x``; then ``y = C * conv(B * x)`` with a causal depthwise conv of
  ``conv_L_cache`` taps, and ``out_proj``;
* ``full_attention``: grouped-query attention with per-head RMSNorm of q
  and k, RoPE (``rope_theta``) and a causal mask
  (``F.scaled_dot_product_attention``).

The first ``num_dense_layers`` layers' feed-forward is a SwiGLU
``w2 (silu(w1 x) * w3 x)``; every later one is the dropless sparse block
(``models/moe.py`` ``DroplessMoE``). Nothing has a bias.

Precision: the parameters are f32 (the optimizer's masters) and every
product runs in :data:`COMPUTE_DTYPE` (bf16, LFM2-8B-A1B's published
dtype), its operands cast where it is computed; the norms' statistics, the
router and the residual stream are f32.

Spans: ``enc/lfm2/short_conv`` around the gated conv (``B * x``, the conv,
``C *``) and ``enc/lfm2/attention`` around q/k norm, RoPE and attention,
each in the forward and, from inside its autograd function, in the
backward.

Windows are independent sequences: positions restart at 0 in each, and a
frame sees only itself and earlier frames of its window.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch.models.moe import DroplessMoE
from ste_gan_torch.utils.profiling import span

#: The published stack's mixer at each depth (LFM2-8B-A1B ``layer_types``).
LAYER_TYPES = ("conv", "conv", "full_attention", "conv", "conv", "conv",
               "full_attention", "conv", "conv", "conv", "full_attention",
               "conv", "conv", "conv", "full_attention", "conv", "conv",
               "conv", "full_attention", "conv", "conv", "full_attention",
               "conv", "conv")

#: The products' precision: LFM2-8B-A1B's published dtype. ``EMGEncoderLFM2``
#: reads it when it is built.
COMPUTE_DTYPE = torch.bfloat16


def _normal_linear(fan_in: int, fan_out: int, generator) -> nn.Linear:
    """A bias-free linear layer drawn from N(0, 0.02)."""
    layer = nn.Linear(fan_in, fan_out, bias=False)
    with torch.no_grad():
        layer.weight.normal_(0.0, 0.02, generator=generator)
    return layer


def product(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``x @ W^T`` with both operands in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps) * weight`` over the last axis, in f32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                            + eps) * weight


class RMSNorm(nn.Module):
    """:func:`rms_norm` with its own ``weight``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def causal_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal depthwise conv of channel-last ``x [B, T, D]`` with taps
    ``w [D, L]``: ``out[t] = sum_j w[:, j] x[t + j - (L - 1)]``, earlier
    frames than the first taken as zero (PyTorch's ``conv1d`` with
    ``groups=D`` and ``L - 1`` frames of padding, cut to ``T``)."""
    taps, length = w.shape[1], x.shape[1]
    out = x * w[:, taps - 1]
    for s in range(1, min(taps, length)):
        out[:, s:] += x[:, :length - s] * w[:, taps - 1 - s]
    return out


def anticausal_taps(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`causal_taps`: ``out[t] = sum_j w[:, j]
    g[t + (L - 1) - j]``."""
    taps, length = w.shape[1], g.shape[1]
    out = g * w[:, taps - 1]
    for s in range(1, min(taps, length)):
        out[:, :length - s] += g[:, s:] * w[:, taps - 1 - s]
    return out


class _GatedConv(torch.autograd.Function):
    """``C * conv(B * x)`` of ``bcx = [B | C | x]`` (``[N, T, 3D]``) and the
    taps ``[D, L]``; the backward recomputes ``B * x`` and the conv."""

    @staticmethod
    def forward(ctx, bcx, w):
        with span("enc/lfm2/short_conv"):
            b, c, x = bcx.chunk(3, dim=-1)
            y = c * causal_taps(b * x, w)
        ctx.save_for_backward(bcx, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        bcx, w = ctx.saved_tensors
        with span("enc/lfm2/short_conv"):
            b, c, x = bcx.chunk(3, dim=-1)
            bx = b * x
            dz = dy * c
            dbx = anticausal_taps(dz, w)
            taps, length = w.shape[1], bx.shape[1]
            dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            for s in range(min(taps, length)):
                dw[:, taps - 1 - s] = (dz[:, s:].float()
                                       * bx[:, :length - s].float()
                                       ).sum(dim=(0, 1))
            dbcx = torch.cat([dbx * x, dy * causal_taps(bx, w), dbx * b],
                             dim=-1)
        return dbcx, dw.to(w.dtype)


class ShortConv(nn.Module):
    """LFM2's gated short convolution (``Lfm2ShortConv``): ``in_proj`` to
    ``B``, ``C``, ``x`` (in that order), ``C * conv(B * x)``, ``out_proj``.
    ``conv.weight`` ``[D, 1, L]`` is ``nn.Conv1d``'s depthwise layout."""

    def __init__(self, dim: int, taps: int, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.in_proj = _normal_linear(dim, 3 * dim, generator)
        self.conv = nn.Conv1d(dim, dim, taps, groups=dim, padding=taps - 1,
                              bias=False)
        with torch.no_grad():
            self.conv.weight.normal_(0.0, 0.02, generator=generator)
        self.out_proj = _normal_linear(dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bcx = product(x, self.in_proj, dt)
        y = _GatedConv.apply(bcx, self.conv.weight[:, 0].to(dt))
        return product(y, self.out_proj, dt)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on ``x [B, H, T, Dh]`` (f32): the half-split
    rotation with frequencies ``theta^(-2i/Dh)``, positions ``0..T-1``."""
    dh, length = x.shape[-1], x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, device=x.device,
                                        dtype=torch.float32) / dh))
    freqs = torch.outer(torch.arange(length, device=x.device,
                                     dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * emb.cos() + torch.cat([-x2, x1], dim=-1) * emb.sin()


class _Spanned(torch.autograd.Function):
    """``fn(*inputs)`` as one autograd node whose forward and backward both
    run inside the span ``name``: the forward builds ``fn``'s own graph on
    detached copies of the inputs and the backward differentiates it."""

    @staticmethod
    def forward(ctx, name, fn, *inputs):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        with torch.enable_grad(), span(name):
            out = fn(*leaves)
        ctx.name, ctx.leaves, ctx.out = name, leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        leaves, out = ctx.leaves, ctx.out
        ctx.leaves = ctx.out = None
        wanted = [t for t in leaves if t.requires_grad]
        with span(ctx.name):
            got = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, *[next(got) if t.requires_grad else None
                              for t in leaves])


def spanned(name: str, fn, *inputs) -> torch.Tensor:
    """``fn(*inputs)`` with its forward and, where it is differentiated,
    its backward inside span ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Spanned.apply(name, fn, *inputs)
    with span(name):
        return fn(*inputs)


class Attention(nn.Module):
    """LFM2's attention (``Lfm2Attention``): ``q_proj``, ``k_proj``,
    ``v_proj`` to ``H`` query and ``KV`` key-value heads of ``Dh``, RMSNorm
    of each head's q and k (``q_layernorm``, ``k_layernorm``), RoPE, causal
    attention scaled by ``Dh^-1/2`` with each key-value head shared by
    ``H / KV`` query heads, ``out_proj``."""

    def __init__(self, dim: int, heads: int, kv_heads: int, theta: float,
                 eps: float, dtype, generator=None):
        super().__init__()
        self.heads, self.kv_heads = heads, kv_heads
        self.head_dim = dim // heads
        self.theta, self.dtype = float(theta), dtype
        self.q_proj = _normal_linear(dim, heads * self.head_dim, generator)
        self.k_proj = _normal_linear(dim, kv_heads * self.head_dim, generator)
        self.v_proj = _normal_linear(dim, kv_heads * self.head_dim, generator)
        self.out_proj = _normal_linear(heads * self.head_dim, dim, generator)
        self.q_layernorm = RMSNorm(self.head_dim, eps)
        self.k_layernorm = RMSNorm(self.head_dim, eps)

    def _core(self, q, k, v, wq, wk):
        """Norms, RoPE and attention of the projections ``[B, T, *]``."""
        b, t = q.shape[:2]
        dh, dt = self.head_dim, self.dtype

        def heads(z, n, norm=None, w=None):
            z = z.view(b, t, n, dh)
            if norm is None:
                return z.transpose(1, 2)
            zf = z.float()
            zf = zf * torch.rsqrt(zf.square().mean(dim=-1, keepdim=True)
                                  + norm.eps) * w
            return rope(zf.transpose(1, 2), self.theta).to(dt)

        out = F.scaled_dot_product_attention(
            heads(q, self.heads, self.q_layernorm, wq),
            heads(k, self.kv_heads, self.k_layernorm, wk),
            heads(v, self.kv_heads), is_causal=True,
            enable_gqa=self.heads != self.kv_heads)
        return out.transpose(1, 2).reshape(b, t, self.heads * dh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        q, k, v = (product(x, self.q_proj, dt), product(x, self.k_proj, dt),
                   product(x, self.v_proj, dt))
        o = spanned("enc/lfm2/attention", self._core, q, k, v,
                    self.q_layernorm.weight, self.k_layernorm.weight)
        return product(o, self.out_proj, dt)


class SwiGLU(nn.Module):
    """``w2 (silu(w1 x) * w3 x)`` (``Lfm2MoeMLP``), products in ``dtype``."""

    def __init__(self, dim: int, hidden: int, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.w1 = _normal_linear(dim, hidden, generator)
        self.w3 = _normal_linear(dim, hidden, generator)
        self.w2 = _normal_linear(hidden, dim, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        return product(F.silu(product(x, self.w1, dt))
                       * product(x, self.w3, dt), self.w2, dt)


class LFM2Layer(nn.Module):
    """One layer: ``operator_norm``, the mixer (``conv`` or ``self_attn``),
    ``ffn_norm`` and ``feed_forward`` (SwiGLU or ``DroplessMoE``)."""

    def __init__(self, kind: str, sparse: bool, dim: int, heads: int,
                 kv_heads: int, dense_hidden: int, expert_hidden: int,
                 num_experts: int, top_k: int, taps: int, eps: float,
                 theta: float, norm_topk_prob: bool, scaling: float,
                 use_expert_bias: bool, dtype, generator=None):
        super().__init__()
        if kind not in ("conv", "full_attention"):
            raise ValueError(f"unknown LFM2 layer type {kind!r}")
        self.kind = kind
        self.operator_norm = RMSNorm(dim, eps)
        if kind == "conv":
            self.conv = ShortConv(dim, taps, dtype, generator)
        else:
            self.self_attn = Attention(dim, heads, kv_heads, theta, eps,
                                       dtype, generator)
        self.ffn_norm = RMSNorm(dim, eps)
        self.feed_forward = (
            DroplessMoE(dim, num_experts, expert_hidden, top_k,
                        norm_topk_prob, scaling, use_expert_bias, dtype,
                        generator)
            if sparse else SwiGLU(dim, dense_hidden, dtype, generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        mixer = self.conv if self.kind == "conv" else self.self_attn
        h = x + mixer(self.operator_norm(x)).float()
        return h + self.feed_forward(self.ffn_norm(h), train).float()


def lfm2_layers(layer_types: Sequence[str], num_dense_layers: int, **kw
                ) -> nn.ModuleList:
    """The stack: one :class:`LFM2Layer` per entry of ``layer_types``, the
    first ``num_dense_layers`` with a dense feed-forward."""
    return nn.ModuleList([LFM2Layer(kind, i >= num_dense_layers, **kw)
                          for i, kind in enumerate(layer_types)])


def sparse_blocks(layers: nn.ModuleList) -> list:
    """The stack's ``DroplessMoE`` blocks, in order."""
    return [m for m in layers.modules() if isinstance(m, DroplessMoE)]

