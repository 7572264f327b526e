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

Over ranks, what GSPMD does for the JAX block is written out:

* data parallelism (``group``: each rank routes its rows of the batch):
  capacity and dropping stay those of the whole batch. One all-gather of
  the ``[k, E]`` pick counts per forward gives a pick its global slot
  (every pick of earlier rounds, then this round's picks on earlier ranks,
  then this rank's earlier tokens), the capacity is that of the global
  token count, and the load-balancing fractions are all-reduced;
* expert parallelism (``parallel/expert_parallel.py`` splits the expert
  axis of ``w1``..``b2`` and sets ``tp``): the tokens are replicated over
  the expert ranks, each runs its own experts on the picks routed there,
  and the combine is summed over the expert group (the tokens and the gates
  enter it through ``copy_to_model``, the sum is a ``replicated_sum``). An
  all-to-all dispatch is not written yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ste_gan_torch.parallel.mesh import rank_and_size
from ste_gan_torch.parallel.tensor_parallel import (
    CommStats, _run, copy_to_model, replicated_sum)


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
        #: Picks over capacity in the last forward, over the whole batch.
        self.dropped: Optional[torch.Tensor] = None
        #: Counts this block's collectives when set (a split block counts
        #: them in its shard's counters).
        self.comm: Optional[CommStats] = None

    def capacity(self, num_tokens: int) -> int:
        k = min(self.top_k, self.num_experts)
        return min(num_tokens, max(1, int(math.ceil(
            self.capacity_factor * k * num_tokens / self.num_experts))))

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None) -> torch.Tensor:
        """``group``: the data-parallel ranks, each with its equal share of
        the batch's rows; routing is that of the whole batch. A split block
        (``tp``: ``parallel/expert_parallel.py``) runs its own experts on
        tokens replicated over ``tp.group`` and sums the combine there."""
        b, t, d = x.shape
        s, e = b * t, self.num_experts
        k = min(self.top_k, e)
        rank, ranks = rank_and_size(group)
        cap = self.capacity(s * ranks)
        dt = self.dtype
        tokens = x.reshape(s, d).to(dt)
        shard = getattr(self, "tp", None)
        comm = self.comm if shard is None else shard.comm

        # Router in f32: gate quality is precision-sensitive.
        gates = torch.softmax(tokens.float() @ self.router.float(), dim=-1)

        remaining = gates.detach()
        rounds = []  # per round: (expert [S], one-hot [S, E])
        for _ in range(k):
            idx = torch.argmax(remaining, dim=-1)
            mask = F.one_hot(idx, e)  # [S, E], no [S, E, C] anywhere
            remaining = remaining * (1 - mask)
            rounds.append((idx, mask))
        top1 = rounds[0][1]
        # Each round's picks per expert on every data rank, [ranks, k, E]:
        # a pick's slot counts every pick of earlier rounds, then this
        # round's on earlier ranks, then this rank's earlier tokens.
        counts = torch.stack([mask.sum(dim=0) for _, mask in rounds])
        every = _gather(counts, group, comm)
        per_round = every.sum(dim=0)
        offsets = (torch.cumsum(per_round, dim=0) - per_round
                   + every[:rank].sum(dim=0))
        self.dropped = torch.clamp(per_round.sum(dim=0) - cap, min=0).sum()

        if shard is not None:
            # Each expert rank adds only its experts' share of the combine.
            gates_c = copy_to_model(gates, shard.group, comm)
            tokens_c = copy_to_model(tokens, shard.group, comm)
        else:
            gates_c, tokens_c = gates, tokens
        picks = []  # per round: (expert [S], position [S], gate [S])
        arange = torch.arange(s, device=x.device)
        for j, (idx, mask) in enumerate(rounds):
            pos = (torch.cumsum(mask, dim=0) - mask + offsets[j])[arange, idx]
            picks.append((idx, pos, gates_c.gather(1, idx[:, None])[:, 0]))
        denom = torch.clamp(sum(g for _, _, g in picks), min=1e-9)

        expert = torch.cat([idx for idx, _, _ in picks])
        slot = torch.cat([pos for _, pos, _ in picks])
        weight = torch.cat([g / denom for _, _, g in picks])
        token = arange.repeat(k)
        kept = slot < cap
        local_e, first = e, 0
        if shard is not None:
            local_e = e // shard.size
            first = shard.rank * local_e
            kept = kept & (expert >= first) & (expert < first + local_e)
        expert, slot, weight, token = (expert[kept] - first, slot[kept],
                                       weight[kept], token[kept])
        local_cap = cap
        if group is not None:
            # This rank's kept picks in compact slots (their results do not
            # depend on the slot): at most min(C, S) per expert.
            local_cap = min(cap, s)
            one = F.one_hot(expert, local_e)
            slot = (torch.cumsum(one, dim=0) - one)[
                torch.arange(len(expert), device=x.device), expert]
        flat = expert * local_cap + slot  # each (expert, slot) at most once

        xe = tokens.new_zeros(local_e * local_cap, d).index_copy(
            0, flat, tokens_c[token]).view(local_e, local_cap, d)
        h = F.relu(torch.bmm(xe, self.w1.to(dt)) + self.b1.to(dt)[:, None, :])
        ye = torch.bmm(h, self.w2.to(dt)) + self.b2.to(dt)[:, None, :]
        # Gate-weighted return in f32, rounded to the block's type once.
        contrib = weight.to(dt).float()[:, None] * ye.reshape(
            local_e * local_cap, d)[flat].float()
        y = torch.zeros(s, d, dtype=torch.float32, device=x.device).index_add(
            0, token, contrib)
        if shard is not None:
            y = replicated_sum(y, shard.group, comm)
        y = y.to(dt)

        if train:
            if group is None:
                f_frac = top1.float().mean(dim=0)
                p_frac = gates.mean(dim=0)
            else:
                # Fractions over the whole batch; every data rank adds the
                # same loss, so the sum's backward is the identity.
                sums = replicated_sum(torch.stack(
                    [top1.float().sum(dim=0), gates.sum(dim=0)]), group, comm)
                f_frac, p_frac = sums / float(s * ranks)
            self.aux_loss = e * torch.sum(f_frac * p_frac)
        return y.reshape(b, t, d)


def _gather(counts: torch.Tensor, group, comm) -> torch.Tensor:
    """``counts`` of every rank of ``group``, stacked in rank order."""
    if group is None:
        return counts[None]
    _, ranks = rank_and_size(group)
    out = counts.new_empty((ranks * counts.shape[0],) + tuple(
        counts.shape[1:]))
    _run(lambda: dist.all_gather_into_tensor(out, counts.contiguous(),
                                             group=group), out, comm)
    return out.view((ranks,) + tuple(counts.shape))
