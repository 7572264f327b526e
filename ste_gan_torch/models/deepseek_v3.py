"""DeepSeek-V3's block stack, as kanana-2-30b-a3b publishes it (Kakao,
https://huggingface.co/kakaocorp/kanana-2-30b-a3b-instruct-2601,
``model_type`` ``deepseek_v3``), for the EMG encoder
(``models/emg_encoder.py`` ``EMGEncoderDeepseekV3``). No counterpart in
the JAX package.

Each layer is ``h = x + MLA(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``
on a residual stream kept in f32 (``input_layernorm``, ``self_attn``,
``post_attention_layernorm``, ``mlp``). The first
``first_k_dense_replace`` layers' FFN is a SwiGLU ``w2 (silu(w1 x) *
w3 x)``; every later one is ``models/moe.py``'s ``DroplessMoE`` with
``n_shared_experts`` experts' worth of shared SwiGLU (one SwiGLU of
``n_shared_experts * moe_intermediate_size``) added to the routed sum, and
DeepSeek-V3's gate normaliser (:data:`GATE_EPS`). Nothing has a bias.

Multi-head latent attention (:class:`MLA`, transformers'
``DeepseekV3Attention`` without query compression), ``H`` heads:

* ``q_proj`` to ``[H, nope + rope]``, split into ``q_nope`` and ``q_pe``;
* ``kv_a_proj_with_mqa`` to a latent ``c`` of ``kv_lora_rank`` and one
  ``k_pe`` of ``rope`` shared by all heads; ``c`` through RMSNorm
  (``kv_a_layernorm``);
* ``kv_b_proj(c)`` to ``[H, nope + v]``, split into ``k_nope`` and ``v``;
* ``q_pe`` and ``k_pe`` rotated in the interleaved convention
  (:func:`interleaved_rope`);
* causal attention of ``[q_nope | q_pe]`` on ``[k_nope | k_pe]`` scaled by
  ``(nope + rope)^-1/2``, values ``v``; ``o_proj`` from ``[H v]``.

Precision: as ``models/lfm2.py``: f32 parameters, every product in
``lfm2.COMPUTE_DTYPE`` (bf16), norms' statistics, RoPE, router and residual
in f32.

Spans: ``enc/mla/project`` around the four projections (forward);
``enc/mla/attention`` around the latent norm and around RoPE and the
attention core, in the forward and, through ``lfm2.spanned``, in the
backward; the shared expert's ``enc/moe/shared`` is ``DroplessMoE``'s.

Windows are independent sequences: positions restart at 0 in each, and a
frame sees only itself and earlier frames of its window.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch.models.lfm2 import (
    RMSNorm, SwiGLU, _normal_linear, product, rms_norm, rope, spanned)
from ste_gan_torch.models.moe import DroplessMoE
from ste_gan_torch.utils.profiling import span

#: DeepSeek-V3's normaliser of the chosen gates' sum (``DeepseekV3MoE``).
GATE_EPS = 1e-20


def interleaved_rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE in DeepSeek-V3's interleaved convention (``rope_interleave``)
    on ``x [B, H, T, R]`` (f32): each ``R``-vector reordered as
    ``view(R/2, 2).transpose(-1, -2).reshape(R)`` (even entries, then odd),
    then rotated as ``lfm2.rope`` (the half split), positions ``0..T-1``."""
    r = x.shape[-1]
    return rope(x.unflatten(-1, (r // 2, 2)).transpose(-1, -2).reshape(
        x.shape), theta)


class MLA(nn.Module):
    """Multi-head latent attention without query compression
    (``q_lora_rank`` null); see the module docstring."""

    def __init__(self, dim: int, heads: int, kv_lora_rank: int,
                 qk_nope_head_dim: int, qk_rope_head_dim: int,
                 v_head_dim: int, theta: float, eps: float, dtype,
                 generator=None):
        super().__init__()
        self.heads, self.rank = heads, kv_lora_rank
        self.nope, self.rope, self.v = (qk_nope_head_dim, qk_rope_head_dim,
                                        v_head_dim)
        self.theta, self.dtype = float(theta), dtype
        qk = qk_nope_head_dim + qk_rope_head_dim
        self.q_proj = _normal_linear(dim, heads * qk, generator)
        self.kv_a_proj_with_mqa = _normal_linear(
            dim, kv_lora_rank + qk_rope_head_dim, generator)
        self.kv_a_layernorm = RMSNorm(kv_lora_rank, eps)
        self.kv_b_proj = _normal_linear(
            kv_lora_rank, heads * (qk_nope_head_dim + v_head_dim), generator)
        self.o_proj = _normal_linear(heads * v_head_dim, dim, generator)

    def _latent(self, c, w):
        """The latent's RMSNorm, rounded for ``kv_b_proj``."""
        return rms_norm(c, w, self.kv_a_layernorm.eps).to(self.dtype)

    def _core(self, q, kv, k_pe):
        """RoPE and causal attention of ``q [B, T, H (nope + rope)]``,
        ``kv [B, T, H (nope + v)]`` and ``k_pe [B, T, rope]``; ``[B, T, H
        v]`` out."""
        b, t = q.shape[:2]
        h, dt = self.heads, self.dtype
        q_nope, q_pe = q.view(b, t, h, -1).transpose(1, 2).split(
            [self.nope, self.rope], dim=-1)
        k_nope, v = kv.view(b, t, h, -1).transpose(1, 2).split(
            [self.nope, self.v], dim=-1)
        q_pe = interleaved_rope(q_pe.float(), self.theta).to(dt)
        k_pe = interleaved_rope(k_pe.view(b, 1, t, self.rope).float(),
                                self.theta).to(dt)
        out = F.scaled_dot_product_attention(
            torch.cat([q_nope, q_pe], dim=-1),
            torch.cat([k_nope, k_pe.expand(b, h, t, self.rope)], dim=-1),
            v, is_causal=True)
        return out.transpose(1, 2).reshape(b, t, h * self.v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        with span("enc/mla/project"):
            q = product(x, self.q_proj, dt)
            c, k_pe = product(x, self.kv_a_proj_with_mqa, dt).split(
                [self.rank, self.rope], dim=-1)
        c = spanned("enc/mla/attention", self._latent, c,
                    self.kv_a_layernorm.weight)
        with span("enc/mla/project"):
            kv = product(c, self.kv_b_proj, dt)
        o = spanned("enc/mla/attention", self._core, q, kv, k_pe)
        with span("enc/mla/project"):
            return product(o, self.o_proj, dt)


class DeepseekV3Layer(nn.Module):
    """One layer: ``input_layernorm``, ``self_attn`` (:class:`MLA`),
    ``post_attention_layernorm`` and ``mlp`` (SwiGLU, or ``DroplessMoE``
    with its shared experts)."""

    def __init__(self, sparse: bool, dim: int, heads: int,
                 kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, dense_hidden: int,
                 expert_hidden: int, num_experts: int, top_k: int,
                 n_shared_experts: int, norm_topk_prob: bool,
                 scaling: float, eps: float, theta: float, dtype,
                 generator=None):
        super().__init__()
        self.input_layernorm = RMSNorm(dim, eps)
        self.self_attn = MLA(dim, heads, kv_lora_rank, qk_nope_head_dim,
                             qk_rope_head_dim, v_head_dim, theta, eps, dtype,
                             generator)
        self.post_attention_layernorm = RMSNorm(dim, eps)
        if sparse:
            shared = SwiGLU(dim, n_shared_experts * expert_hidden, dtype,
                            generator)
            self.mlp = DroplessMoE(dim, num_experts, expert_hidden, top_k,
                                   norm_topk_prob, scaling, True, dtype,
                                   generator, shared=shared,
                                   gate_eps=GATE_EPS)
        else:
            self.mlp = SwiGLU(dim, dense_hidden, dtype, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x + self.self_attn(self.input_layernorm(x)).float()
        return h + self.mlp(self.post_attention_layernorm(h), train).float()


def deepseek_v3_layers(num_layers: int, first_k_dense_replace: int, **kw
                       ) -> nn.ModuleList:
    """The stack: ``num_layers`` :class:`DeepseekV3Layer`, the first
    ``first_k_dense_replace`` with a dense FFN."""
    return nn.ModuleList([DeepseekV3Layer(i >= first_k_dense_replace, **kw)
                          for i in range(num_layers)])
