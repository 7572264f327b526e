"""Mixture-of-experts feed-forward block of the encoder's transformer
layers. Counterpart of ``ste_gan_tpu/models/moe.py`` (a scaling extension
with no reference counterpart).

Routing is exactly the JAX block's:

* a router ``[D, E]`` projects each token to ``E`` logits; softmax gates in
  f32;
* ``k`` rounds of ``argmax`` over the gates not yet taken (the first
  maximal index on ties), each token's position at its expert from a
  cumulative count that carries across the rounds, so round 0 fills first;
* a fixed capacity ``C = min(S, max(1, ceil(capacity_factor * k * S /
  E)))``: a pick at position ``>= C`` is dropped (zero combine weight, so
  the caller's residual passes the token through);
* the kept picks' gates normalised over the token's ``k`` gates (floor
  ``1e-9``);
* the Switch load-balancing loss ``E * sum(f_e * p_e)`` on the
  pre-capacity top-1 assignment, recorded on the block in a training
  forward (``aux_loss``), where the JAX block sows it into ``"losses"``.

The JAX block builds one-hot dispatch and combine tensors ``[S, E, C]`` and
contracts them in einsums; at the encoder's full budget that is 768 MB per
tensor and ~295 GFLOP per einsum and layer. This block computes the same
function by index: the kept tokens are copied into ``[E, C, D]`` at their
``(expert, position)`` slots (empty slots stay zero, as in the einsum), the
expert FFN is two batched products (``torch.bmm``; the JAX package leaves
these plain products to XLA outside any Pallas kernel), and each pick's
``gate / denom * ye[e, pos]`` is added back to its token (``index_add``).
Equal to the einsums up to summation order, with gradients to the tokens,
the gates and all five parameters.

Parameters are in the JAX layout (``router [D, E]``, ``w1 [E, D, F]``,
``b1 [E, F]``, ``w2 [E, F, D]``, ``b2 [E, D]``), so the weight bridge copies
them without a transpose.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _uniform(shape, fan_in: int, generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound,
                                                    generator=generator))


class MoEFeedForward(nn.Module):
    """Token-routed mixture of ReLU FFN experts; ``[B, T, D]`` in and out."""

    def __init__(self, d_model: int, num_experts: int, dim_feedforward: int,
                 top_k: int = 2, capacity_factor: float = 1.5,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, e, f = d_model, num_experts, dim_feedforward
        self.num_experts = e
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(d, e).normal_(
            0.0, d ** -0.5, generator=generator))
        self.w1 = _uniform((e, d, f), d, generator)
        self.b1 = _uniform((e, f), d, generator)
        self.w2 = _uniform((e, f, d), f, generator)
        self.b2 = _uniform((e, d), f, generator)
        #: The last training forward's load-balancing loss (f32 scalar).
        self.aux_loss: Optional[torch.Tensor] = None

    def capacity(self, num_tokens: int) -> int:
        k = min(self.top_k, self.num_experts)
        return min(num_tokens, max(1, int(math.ceil(
            self.capacity_factor * k * num_tokens / self.num_experts))))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, t, d = x.shape
        s, e = b * t, self.num_experts
        k = min(self.top_k, e)
        cap = self.capacity(s)
        dt = self.dtype
        tokens = x.reshape(s, d).to(dt)

        # Router in f32: gate quality is precision-sensitive.
        gates = torch.softmax(tokens.float() @ self.router.float(), dim=-1)

        counts = torch.zeros(e, dtype=torch.long, device=x.device)
        remaining = gates.detach()
        picks = []  # per round: (expert [S], position [S], gate [S])
        top1 = None
        for _ in range(k):
            idx = torch.argmax(remaining, dim=-1)
            mask = F.one_hot(idx, e)  # [S, E], no [S, E, C] anywhere
            remaining = remaining * (1 - mask)
            if top1 is None:
                top1 = mask
            # Position of each token among its expert's picks so far.
            pos = (torch.cumsum(mask, dim=0) - mask + counts)[
                torch.arange(s, device=x.device), idx]
            counts = counts + mask.sum(dim=0)
            picks.append((idx, pos, gates.gather(1, idx[:, None])[:, 0]))
        denom = torch.clamp(sum(g for _, _, g in picks), min=1e-9)

        expert = torch.cat([idx for idx, _, _ in picks])
        slot = torch.cat([pos for _, pos, _ in picks])
        weight = torch.cat([g / denom for _, _, g in picks])
        token = torch.arange(s, device=x.device).repeat(k)
        kept = slot < cap
        expert, slot, weight, token = (expert[kept], slot[kept], weight[kept],
                                       token[kept])
        flat = expert * cap + slot  # each (expert, position) at most once

        xe = tokens.new_zeros(e * cap, d).index_copy(0, flat, tokens[token])
        xe = xe.view(e, cap, d)
        h = F.relu(torch.bmm(xe, self.w1.to(dt)) + self.b1.to(dt)[:, None, :])
        ye = torch.bmm(h, self.w2.to(dt)) + self.b2.to(dt)[:, None, :]
        # Gate-weighted return in f32, rounded to the block's type once.
        contrib = weight.to(dt).float()[:, None] * ye.reshape(e * cap, d)[
            flat].float()
        y = torch.zeros(s, d, dtype=torch.float32, device=x.device).index_add(
            0, token, contrib).to(dt)

        if train:
            f_frac = top1.float().mean(dim=0)
            p_frac = gates.mean(dim=0)
            self.aux_loss = e * torch.sum(f_frac * p_frac)
        return y.reshape(b, t, d)
