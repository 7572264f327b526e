"""The EMG encoder with kanana-2-30b-a3b's DeepSeek-V3 block stack, in
plain PyTorch.

Kakao, kanana-2-30b-a3b-instruct-2601,
https://huggingface.co/kakaocorp/kanana-2-30b-a3b-instruct-2601
(``config.json``, ``model_type`` ``deepseek_v3``; the layer equations of
``transformers``' ``modeling_deepseek_v3.py`` and DeepSeek-V3,
arXiv:2412.19437 §2.1):

* each layer: ``h = x + MLA(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``;
  RMSNorm ``x / sqrt(mean(x^2) + eps) * weight``;
* multi-head latent attention, ``H`` heads, no query compression:
  ``q = q_proj(x)`` per head ``[q_nope | q_pe]``; ``kv_a_proj_with_mqa(x)
  = [c | k_pe]``; ``c`` through RMSNorm; ``kv_b_proj(c)`` per head
  ``[k_nope | v]``; ``q_pe`` and the one ``k_pe`` that every head shares
  rotated: each pair ``(x_2i, x_2i+1)`` turned by ``pos *
  theta^(-2i/R)`` (DeepSeek-V3's complex form; ``rope_interleave`` is
  this pairing); per head, softmax of ``[q_nope | q_pe] . [k_nope |
  k_pe] / sqrt(nope + rope)`` under a causal mask, times ``v``;
  ``o_proj`` of the heads side by side;
* FFN: SwiGLU ``w2 (silu(w1 x) * w3 x)``, dense in the first
  ``first_k_dense_replace`` layers; after them the sparse block: scores
  ``sigmoid(x gate^T)``, each token's top-k experts chosen on ``score +
  expert_bias`` (one group), gates the chosen scores over their sum +
  1e-20, times ``routed_scaling_factor``; each chosen expert's SwiGLU
  weighted by its gate and summed, plus the shared experts (one SwiGLU of
  ``n_shared_experts`` times the expert width) on every token; no
  capacity, no auxiliary loss.

The encoder around the stack: the published encoder's front end
(``nets.ResBlock``, four stride-2 BatchNorm ResBlocks) and an input
projection to the hidden width, the stack, a final RMSNorm, and the unit
and phoneme heads.

Departures from the published model:

* the 128,256-row embedding and the LM head are replaced by the front end
  and the two heads (the task has no vocabulary);
* 5 of the 48 layers (the leading dense one and 4 sparse ones);
* windows are independent sequences, positions restarting at 0;
* the expert bias moves after each optimizer step by ``b_e += BIAS_RATE
  * sign(mean load - load_e)`` (DeepSeek-V3 §2.1.2; the config names
  ``noaux_tc`` but not the rate);
* everything is f32 (the model is published in bf16); products round as
  the :class:`~portbench.reference.precision.Precision` given says (its
  ``mm()``), the front end's convolutions as ``Precision`` itself;
* the rotated halves keep DeepSeek-V3's pairs in place, where
  transformers' form moves them apart first: the same permutation of
  ``q_pe`` and ``k_pe``, which leaves every ``q . k`` as it is.

The attention is a loop over the heads and the experts a loop over the
experts: no kernel of the program, no cache, no batching beyond the
folded windows. :class:`Variant` holds the stand-ins the controls use
(``reference/lfm2.py``'s routing ones, RoPE without the pairing, the
latent's normalisation left out); the default is the published model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference.lfm2 import _mm, RMSNorm, Routing, SwiGLU
from portbench.reference.precision import F32, Precision


@dataclass(frozen=True)
class Variant(Routing):
    """The published model by default; each other value a control's
    stand-in: the routing's (``Routing``), the rotation's pairs
    ``(x_i, x_i+R/2)`` instead of ``(x_2i, x_2i+1)``, the latent's
    normalisation left out (its scale kept)."""

    rope_interleave: bool = True
    latent_norm: bool = True


PUBLISHED = Variant()

#: The expert bias's step after each optimizer step (assumed: DeepSeek-V3's
#: gamma, arXiv:2412.19437 §2.1.2).
BIAS_RATE = 1e-3
#: DeepSeek-V3's floor under the chosen gates' sum.
GATE_EPS = 1e-20


def rotate(x: torch.Tensor, theta: float, interleave: bool = True
           ) -> torch.Tensor:
    """``x [..., T, R]`` with its pairs turned by ``t * theta^(-2i/R)`` at
    position ``t``: pairs ``(x_2i, x_2i+1)``, or with ``interleave``
    False ``(x_i, x_i+R/2)``."""
    r, length = x.shape[-1], x.shape[-2]
    inv = theta ** (-torch.arange(0, r, 2, dtype=torch.float32,
                                  device=x.device) / r)
    angle = torch.arange(length, dtype=torch.float32,
                         device=x.device)[:, None] * inv[None, :]
    cos, sin = angle.cos(), angle.sin()
    if interleave:
        a, b = x[..., 0::2], x[..., 1::2]
    else:
        a, b = x[..., :r // 2], x[..., r // 2:]
    ra, rb = a * cos - b * sin, a * sin + b * cos
    if interleave:
        return torch.stack([ra, rb], dim=-1).flatten(-2)
    return torch.cat([ra, rb], dim=-1)


class MLA(nn.Module):
    def __init__(self, dim: int, heads: int, rank: int, nope: int,
                 rope: int, v: int, eps: float, theta: float):
        super().__init__()
        self.heads, self.rank, self.theta = heads, rank, theta
        self.nope, self.rope, self.v = nope, rope, v
        self.q_proj = nn.Linear(dim, heads * (nope + rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(dim, rank + rope, bias=False)
        self.kv_a_layernorm = RMSNorm(rank, eps)
        self.kv_b_proj = nn.Linear(rank, heads * (nope + v), bias=False)
        self.o_proj = nn.Linear(heads * v, dim, bias=False)

    def forward(self, x, p: Precision, variant: Variant = PUBLISHED):
        pm = p.mm()
        b, t, _ = x.shape
        nope, rope = self.nope, self.rope
        q = _mm(x, self.q_proj.weight, pm).float().view(b, t, self.heads, -1)
        ckv = _mm(x, self.kv_a_proj_with_mqa.weight, pm).float()
        c, k_pe = ckv[..., :self.rank], ckv[..., self.rank:]
        c = (self.kv_a_layernorm(c) if variant.latent_norm
             else c * self.kv_a_layernorm.weight)
        kv = _mm(c, self.kv_b_proj.weight, pm).float().view(
            b, t, self.heads, -1)
        k_pe = rotate(k_pe, self.theta, variant.rope_interleave)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        heads = []
        for h in range(self.heads):
            qh = torch.cat([q[:, :, h, :nope], rotate(
                q[:, :, h, nope:], self.theta, variant.rope_interleave)],
                dim=-1)
            kh = torch.cat([kv[:, :, h, :nope], k_pe], dim=-1)
            vh = kv[:, :, h, nope:]
            logits = torch.matmul(pm.operand(qh), pm.operand(kh).transpose(
                1, 2)).float() / (nope + rope) ** 0.5
            probs = torch.softmax(logits.masked_fill(~causal, float("-inf")),
                                  dim=-1)
            heads.append(torch.matmul(pm.operand(probs),
                                      pm.operand(vh)).float())
        return _mm(torch.cat(heads, dim=-1), self.o_proj.weight, pm).float()


class SparseMoE(nn.Module):
    """The sparse block with its shared experts. ``w1``, ``w3`` ``[E, F,
    D]`` and ``w2`` ``[E, D, F]``: each expert's weights in
    ``nn.Linear``'s ``[out, in]`` layout. ``load`` keeps the last forward's
    picks per expert."""

    def __init__(self, dim: int, experts: int, hidden: int, top_k: int,
                 shared_hidden: int, scaling: float, norm_topk: bool = True):
        super().__init__()
        self.top_k, self.norm_topk, self.scaling = top_k, norm_topk, scaling
        self.gate = nn.Linear(dim, experts, bias=False)
        self.w1 = nn.Parameter(torch.empty(experts, hidden, dim))
        self.w3 = nn.Parameter(torch.empty(experts, hidden, dim))
        self.w2 = nn.Parameter(torch.empty(experts, dim, hidden))
        self.register_buffer("expert_bias", torch.zeros(experts))
        self.shared_experts = SwiGLU(dim, shared_hidden)
        self.load = None

    def rows(self, chosen: torch.Tensor, e: int):
        """The tokens that chose expert ``e`` and the slot of the pick."""
        return torch.nonzero(chosen == e, as_tuple=True)

    def route(self, tokens, routing: Routing = PUBLISHED):
        """``(chosen [S, k], gates [S, k])`` of the tokens ``[S, D]``."""
        logits = _mm(tokens, self.gate.weight, routing.router or F32).float()
        scores = (torch.sigmoid(logits) if routing.scores == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        choice = scores.detach()
        if routing.use_bias:
            choice = choice + self.expert_bias
        chosen = torch.topk(choice, self.top_k, dim=-1).indices
        gates = scores.gather(1, chosen)
        if self.norm_topk:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + GATE_EPS)
        return chosen, gates * self.scaling

    def forward(self, x, p: Precision, routing: Routing = PUBLISHED):
        shape = x.shape
        tokens = x.reshape(-1, shape[-1]).float()
        chosen, gates = self.route(tokens, routing)
        experts = self.w1.shape[0]
        flat = chosen.reshape(-1)
        self.load = torch.zeros(experts, device=x.device).scatter_add_(
            0, flat, torch.ones(flat.shape, device=x.device))
        pe = routing.experts or p.mm()
        out = torch.zeros_like(tokens)
        for e in range(experts):
            tok, slot = self.rows(chosen, e)
            xe = tokens[tok]
            h = (F.silu(_mm(xe, self.w1[e], pe).float())
                 * _mm(xe, self.w3[e], pe).float())
            y = _mm(h, self.w2[e], pe).float()
            out = out.index_add(0, tok, gates[tok, slot][:, None] * y)
        out = out + self.shared_experts(tokens, p)
        return out.view(shape)

    @torch.no_grad()
    def update_bias(self, rate: float = BIAS_RATE) -> None:
        if self.load is not None:
            self.expert_bias.add_(torch.sign(self.load.mean() - self.load),
                                  alpha=rate)


class Layer(nn.Module):
    def __init__(self, sparse: bool, dim: int, heads: int, rank: int,
                 nope: int, rope: int, v: int, dense: int, expert: int,
                 experts: int, top_k: int, shared: int, scaling: float,
                 eps: float, theta: float):
        super().__init__()
        self.input_layernorm = RMSNorm(dim, eps)
        self.self_attn = MLA(dim, heads, rank, nope, rope, v, eps, theta)
        self.post_attention_layernorm = RMSNorm(dim, eps)
        self.mlp = (SparseMoE(dim, experts, expert, top_k, shared * expert,
                              scaling) if sparse else SwiGLU(dim, dense))

    def forward(self, x, p: Precision, variant: Variant):
        h = x + self.self_attn(self.input_layernorm(x), p, variant)
        return h + self.mlp(self.post_attention_layernorm(h), p, variant)


class KananaEncoder(nn.Module):
    """EMG ``[B, T, 8]`` -> (units ``[B, T/16, 256]``, phoneme logits
    ``[B, T/16, 48]``), both f32. Names as the program's
    ``EMGEncoderDeepseekV3``."""

    def __init__(self, num_ins: int = 8, num_outs: int = nets.UNIT_DIM,
                 num_aux: int = nets.PHONEMES, model_size: int = 768,
                 extra_blocks: int = 3, hidden: int = 2048, layers: int = 5,
                 heads: int = 32, rank: int = 512, nope: int = 128,
                 rope: int = 64, v: int = 128, dense: int = 6144,
                 expert: int = 768, num_dense: int = 1, experts: int = 128,
                 top_k: int = 6, shared: int = 2, scaling: float = 2.448,
                 eps: float = 1e-6, theta: float = 1e6):
        super().__init__()
        blocks, cin = [], num_ins
        for _ in range(1 + extra_blocks):
            blocks.append(nets.ResBlock(cin, model_size))
            cin = model_size
        self.conv_blocks = nn.ModuleList(blocks)
        self.w_raw_in = nn.Linear(model_size, hidden)
        self.layers = nn.ModuleList([
            Layer(i >= num_dense, hidden, heads, rank, nope, rope, v, dense,
                  expert, experts, top_k, shared, scaling, eps, theta)
            for i in range(layers)])
        self.final_norm = RMSNorm(hidden, eps)
        self.w_out = nn.Linear(hidden, num_outs)
        self.w_aux = nn.Linear(hidden, num_aux)

    def sparse(self) -> List[SparseMoE]:
        return [layer.mlp for layer in self.layers
                if isinstance(layer.mlp, SparseMoE)]

    def forward(self, emg, p: Precision = F32, train: bool = False,
                shift: int = 0, routing: Variant = PUBLISHED
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = emg.to(p.dtype)
        if train and shift:
            x = F.pad(x[:, shift:], (0, 0, 0, shift))
        x = x.transpose(1, 2)
        for block in self.conv_blocks:
            x = block(x, p, train)
        x = nets.linear(x.transpose(1, 2), self.w_raw_in, p).float()
        for layer in self.layers:
            x = layer(x, p, routing)
        x = self.final_norm(x)
        return (nets.linear(x, self.w_out, p).float(),
                nets.linear(x, self.w_aux, p).float())


def config_sizes(params: Dict, channels: int = 8) -> Dict:
    """:class:`KananaEncoder`'s arguments from the program's encoder
    parameters (``EMGEncoderDeepseekV3``'s keyword arguments, the
    published config's names)."""
    return dict(num_ins=channels, model_size=params["model_size"],
                extra_blocks=params["num_extra_res_blocks"],
                hidden=params["hidden_size"],
                layers=params["num_hidden_layers"],
                heads=params["num_attention_heads"],
                rank=params["kv_lora_rank"],
                nope=params["qk_nope_head_dim"],
                rope=params["qk_rope_head_dim"], v=params["v_head_dim"],
                dense=params["intermediate_size"],
                expert=params["moe_intermediate_size"],
                num_dense=params["first_k_dense_replace"],
                experts=params["n_routed_experts"],
                top_k=params["num_experts_per_tok"],
                shared=params["n_shared_experts"],
                scaling=float(params["routed_scaling_factor"]),
                eps=params["rms_norm_eps"], theta=float(params["rope_theta"]))
