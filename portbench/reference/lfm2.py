"""The EMG encoder with LFM2-8B-A1B's block stack, in plain PyTorch.

Liquid AI, LFM2-8B-A1B, https://huggingface.co/LiquidAI/LFM2-8B-A1B
(``config.json``; the layer equations of ``transformers``'
``modeling_lfm2_moe.py``):

* each layer: ``h = x + mixer(RMSNorm(x))``, ``out = h +
  ffn(RMSNorm(h))``; RMSNorm ``x / sqrt(mean(x^2) + eps) * weight``;
* ``conv`` mixer: ``in_proj`` (``D -> 3D``) split into ``B``, ``C``,
  ``x``; ``C * conv(B * x)`` with a depthwise ``Conv1d`` of ``L`` taps,
  ``L - 1`` frames of padding, cut to the first ``T`` outputs (causal);
  ``out_proj``;
* ``full_attention`` mixer: ``q_proj``, ``k_proj``, ``v_proj``; RMSNorm of
  each head's q and k; RoPE (half-split rotation, ``theta^(-2i/Dh)``);
  each key-value head repeated for its ``H / KV`` query heads; softmax of
  ``q k^T / sqrt(Dh)`` under a causal mask; ``out_proj``;
* feed-forward: SwiGLU ``w2 (silu(w1 x) * w3 x)``, dense in the first
  ``num_dense_layers`` layers; after them the sparse block: scores
  ``sigmoid(x gate^T)``, each token's top-k experts chosen on ``score +
  expert_bias``, gates the chosen scores over their sum + 1e-6 (times the
  routed scaling factor, 1), each chosen expert's SwiGLU weighted by its
  gate and summed; no capacity, no auxiliary loss.

The encoder around the stack: the published encoder's front end
(``nets.ResBlock``, four stride-2 BatchNorm ResBlocks) and an input
projection to the hidden width, the stack, a final RMSNorm, and the unit
and phoneme heads.

Departures from the published description:

* the 65,536-row embedding and the LM head are replaced by the front end
  and the two heads (the task has no vocabulary);
* 8 of the 24 layers (``layer_types[:8]``);
* windows are independent sequences, positions restarting at 0;
* the expert bias moves after each optimizer step by ``b_e += BIAS_RATE
  * sign(mean load - load_e)`` (DeepSeek-V3, arXiv:2412.19437 §2.1.2): the
  published config says only ``use_expert_bias``;
* everything is f32 (the model is published in bf16); products round as
  the :class:`~portbench.reference.precision.Precision` given says (its
  ``mm()``), the front end's convolutions as ``Precision`` itself.

The routing is the published equations with one loop over the experts;
no kernel of the program, no cache, no batching beyond the folded
windows. :class:`Routing` holds the stand-ins the controls use (a
precision for the router or the experts alone, softmax scores, the bias
left out of the choice); the default is the published rule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.reference.precision import F32, Precision

#: LFM2-8B-A1B's ``layer_types``.
LAYER_TYPES = ("conv", "conv", "full_attention", "conv", "conv", "conv",
               "full_attention", "conv", "conv", "conv", "full_attention",
               "conv", "conv", "conv", "full_attention", "conv", "conv",
               "conv", "full_attention", "conv", "conv", "full_attention",
               "conv", "conv")


@dataclass(frozen=True)
class Routing:
    """How the sparse blocks route and where they round. The default is
    the published rule; each other value is a control's stand-in."""

    scores: str = "sigmoid"
    use_bias: bool = True
    #: Precision of the router's product (default f32).
    router: Optional[Precision] = None
    #: Precision of the experts' products (default the products').
    experts: Optional[Precision] = None


PUBLISHED = Routing()

#: The expert bias's step after each optimizer step (assumed: DeepSeek-V3's
#: gamma, arXiv:2412.19437 §2.1.2).
BIAS_RATE = 1e-3


def _mm(x, w, p: Precision):
    """``x @ w^T`` with both operands as ``p`` rounds them."""
    return torch.matmul(p.operand(x), p.operand(w).T)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        return (x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True)
                                + self.eps) * self.weight)


class ShortConv(nn.Module):
    def __init__(self, dim: int, taps: int):
        super().__init__()
        self.in_proj = nn.Linear(dim, 3 * dim, bias=False)
        self.conv = nn.Conv1d(dim, dim, taps, groups=dim, padding=taps - 1,
                              bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x, p: Precision):
        pm = p.mm()
        length = x.shape[1]
        bcx = _mm(x, self.in_proj.weight, pm).float().transpose(1, 2)
        b, c, xx = bcx.chunk(3, dim=1)
        conv = F.conv1d(pm.operand(b * xx), pm.operand(self.conv.weight),
                        padding=self.conv.padding[0],
                        groups=self.conv.groups).float()[..., :length]
        y = (c * conv).transpose(1, 2)
        return _mm(y, self.out_proj.weight, pm).float()


def _rope(x, theta: float):
    dh, length = x.shape[-1], x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    freqs = torch.arange(length, dtype=torch.float32,
                         device=x.device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    half = dh // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_heads: int, eps: float,
                 theta: float):
        super().__init__()
        self.heads, self.kv_heads, self.theta = heads, kv_heads, theta
        self.head_dim = dim // heads
        self.q_proj = nn.Linear(dim, heads * self.head_dim, bias=False)
        self.k_proj = nn.Linear(dim, kv_heads * self.head_dim, bias=False)
        self.v_proj = nn.Linear(dim, kv_heads * self.head_dim, bias=False)
        self.out_proj = nn.Linear(heads * self.head_dim, dim, bias=False)
        self.q_layernorm = RMSNorm(self.head_dim, eps)
        self.k_layernorm = RMSNorm(self.head_dim, eps)

    def forward(self, x, p: Precision):
        pm = p.mm()
        b, t, _ = x.shape
        dh = self.head_dim

        def split(w, n):
            return _mm(x, w, pm).float().view(b, t, n, dh)

        q = _rope(self.q_layernorm(split(self.q_proj.weight, self.heads))
                  .transpose(1, 2), self.theta)
        k = _rope(self.k_layernorm(split(self.k_proj.weight, self.kv_heads))
                  .transpose(1, 2), self.theta)
        v = split(self.v_proj.weight, self.kv_heads).transpose(1, 2)
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        logits = torch.matmul(pm.operand(q), pm.operand(k).transpose(2, 3)
                              ).float() / dh ** 0.5
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(logits.masked_fill(~causal, float("-inf")),
                              dim=-1)
        o = torch.matmul(pm.operand(probs), pm.operand(v)).float()
        return _mm(o.transpose(1, 2).reshape(b, t, self.heads * dh),
                   self.out_proj.weight, pm).float()


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden, bias=False)
        self.w3 = nn.Linear(dim, hidden, bias=False)
        self.w2 = nn.Linear(hidden, dim, bias=False)

    def forward(self, x, p: Precision, routing: Routing = PUBLISHED):
        pm = p.mm()
        h = (F.silu(_mm(x, self.w1.weight, pm).float())
             * _mm(x, self.w3.weight, pm).float())
        return _mm(h, self.w2.weight, pm).float()


class SparseMoE(nn.Module):
    """The sparse block. ``w1``, ``w3`` ``[E, F, D]`` and ``w2`` ``[E, D,
    F]``: each expert's weights in ``nn.Linear``'s ``[out, in]``
    layout. ``load`` keeps the last forward's picks per expert."""

    def __init__(self, dim: int, experts: int, hidden: int, top_k: int,
                 norm_topk: bool = True, scaling: float = 1.0):
        super().__init__()
        self.top_k, self.norm_topk, self.scaling = top_k, norm_topk, scaling
        self.gate = nn.Linear(dim, experts, bias=False)
        self.w1 = nn.Parameter(torch.empty(experts, hidden, dim))
        self.w3 = nn.Parameter(torch.empty(experts, hidden, dim))
        self.w2 = nn.Parameter(torch.empty(experts, dim, hidden))
        self.register_buffer("expert_bias", torch.zeros(experts))
        self.load: Optional[torch.Tensor] = None

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
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-6)
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
        return out.view(shape)

    @torch.no_grad()
    def update_bias(self, rate: float = BIAS_RATE) -> None:
        if self.load is not None:
            self.expert_bias.add_(torch.sign(self.load.mean() - self.load),
                                  alpha=rate)


class Layer(nn.Module):
    def __init__(self, kind: str, sparse: bool, dim: int, heads: int,
                 kv_heads: int, dense: int, expert: int, experts: int,
                 top_k: int, taps: int, eps: float, theta: float):
        super().__init__()
        self.kind = kind
        self.operator_norm = RMSNorm(dim, eps)
        if kind == "conv":
            self.conv = ShortConv(dim, taps)
        else:
            self.self_attn = Attention(dim, heads, kv_heads, eps, theta)
        self.ffn_norm = RMSNorm(dim, eps)
        self.feed_forward = (SparseMoE(dim, experts, expert, top_k) if sparse
                             else SwiGLU(dim, dense))

    def forward(self, x, p: Precision, routing: Routing):
        mixer = self.conv if self.kind == "conv" else self.self_attn
        h = x + mixer(self.operator_norm(x), p)
        return h + self.feed_forward(self.ffn_norm(h), p, routing)


class LFM2Encoder(nn.Module):
    """EMG ``[B, T, 8]`` -> (units ``[B, T/16, 256]``, phoneme logits
    ``[B, T/16, 48]``), both f32. Names as the program's
    ``EMGEncoderLFM2``."""

    def __init__(self, num_ins: int = 8, num_outs: int = nets.UNIT_DIM,
                 num_aux: int = nets.PHONEMES, model_size: int = 768,
                 extra_blocks: int = 3, hidden: int = 2048,
                 layers: int = 8, layer_types: Sequence[str] = LAYER_TYPES,
                 heads: int = 32, kv_heads: int = 8, dense: int = 7168,
                 expert: int = 1792, num_dense: int = 2, experts: int = 32,
                 top_k: int = 4, taps: int = 3, eps: float = 1e-5,
                 theta: float = 1e6):
        super().__init__()
        blocks, cin = [], num_ins
        for _ in range(1 + extra_blocks):
            blocks.append(nets.ResBlock(cin, model_size))
            cin = model_size
        self.conv_blocks = nn.ModuleList(blocks)
        self.w_raw_in = nn.Linear(model_size, hidden)
        self.layers = nn.ModuleList([
            Layer(kind, i >= num_dense, hidden, heads, kv_heads, dense,
                  expert, experts, top_k, taps, eps, theta)
            for i, kind in enumerate(layer_types[:layers])])
        self.final_norm = RMSNorm(hidden, eps)
        self.w_out = nn.Linear(hidden, num_outs)
        self.w_aux = nn.Linear(hidden, num_aux)

    def sparse(self) -> List[SparseMoE]:
        return [layer.feed_forward for layer in self.layers
                if isinstance(layer.feed_forward, SparseMoE)]

    def forward(self, emg, p: Precision = F32, train: bool = False,
                shift: int = 0, routing: Routing = PUBLISHED
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
    """:class:`LFM2Encoder`'s arguments from the program's encoder
    parameters (``EMGEncoderLFM2``'s keyword arguments)."""
    return dict(num_ins=channels, model_size=params["model_size"],
                extra_blocks=params["num_extra_res_blocks"],
                hidden=params["hidden_size"],
                layers=params["num_hidden_layers"],
                layer_types=tuple(params["layer_types"]),
                heads=params["num_attention_heads"],
                kv_heads=params["num_key_value_heads"],
                dense=params["intermediate_size"],
                expert=params["moe_intermediate_size"],
                num_dense=params["num_dense_layers"],
                experts=params["num_experts"],
                top_k=params["num_experts_per_tok"],
                taps=params["conv_L_cache"], eps=params["norm_eps"],
                theta=float(params["rope_theta"]))


def lfm2_steps(enc: LFM2Encoder, batches: Sequence[Sequence[
        ref_train.Utterance]], shifts: Sequence[int],
        hyper: ref_train.EncHyper, p: Precision, windows: int,
        routing: Routing = PUBLISHED) -> ref_train.Record:
    """The encoder's training step once per batch (the shift, the front
    end's batch statistics, the loss of ``train.encoder_loss``, AdamW),
    each followed by the expert biases' update."""
    names = [n for n, _ in enc.named_parameters()]
    params = list(enc.parameters())
    opt = ref_train.AdamW(params, hyper.lrs[0], hyper.b1, hyper.b2,
                          hyper.eps, hyper.wd)
    losses, grads, outputs = [], {}, {}
    with p.active():
        for step, (utts, shift) in enumerate(zip(batches, shifts)):
            x = ref_train.fold_windows(utts, windows).float()
            su, ph = enc(x, p, train=True, shift=shift, routing=routing)
            if step == 0:
                outputs = {"units": su.detach().float().cpu(),
                           "phonemes": ph.detach().float().cpu()}
            loss = ref_train.encoder_loss(su, ph, utts)
            g = torch.autograd.grad(loss, params)
            opt.lr = hyper.lrs[step]
            opt.step(g)
            for block in enc.sparse():
                block.update_bias()
            if step == 0:
                vals = torch.stack([t.detach().float().norm() for t in g])
                grads = {"enc": dict(zip(names, vals.cpu().tolist()))}
            del g
            losses.append({"loss": loss.item()})
    stats = {n: b.detach().float().cpu() for n, b in enc.named_buffers()
             if n.endswith("running_var")}
    return ref_train.Record(
        losses, grads, {"enc": {n: q.detach() for n, q in zip(names, params)}},
        outputs, stats)
