"""Mixture-of-experts feed-forward blocks of the EMG encoders.

:class:`DroplessMoE` is LFM2-8B-A1B's and DeepSeek-V3's sparse block
(sigmoid scores, top-k chosen with an expert bias, no capacity, SwiGLU
experts as grouped products, DeepSeek-V3's shared experts); the LFM2 and
DeepSeek-V3 encoders (``models/lfm2.py``, ``models/deepseek_v3.py``) use
it and the JAX package has no counterpart. The rest of this docstring is
about :class:`MoEFeedForward`.

:class:`MoEFeedForward`, the encoder's transformer layers' block:
counterpart of ``ste_gan_tpu/models/moe.py`` (a scaling extension with no
reference counterpart).

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
from ste_gan_torch.utils.profiling import add, span


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

        with span("enc/moe/route"):
            # Router in f32: gate quality is precision-sensitive.
            gates = torch.softmax(tokens.float() @ self.router.float(),
                                  dim=-1)

            remaining = gates.detach()
            rounds = []  # per round: (expert [S], one-hot [S, E])
            for _ in range(k):
                idx = torch.argmax(remaining, dim=-1)
                mask = F.one_hot(idx, e)  # [S, E], no [S, E, C] anywhere
                remaining = remaining * (1 - mask)
                rounds.append((idx, mask))
            top1 = rounds[0][1]
            # Each round's picks per expert on every data rank, [ranks, k,
            # E]: a pick's slot counts every pick of earlier rounds, then
            # this round's on earlier ranks, then this rank's earlier
            # tokens.
            counts = torch.stack([mask.sum(dim=0) for _, mask in rounds])
            every = _gather(counts, group, comm)
            per_round = every.sum(dim=0)
            offsets = (torch.cumsum(per_round, dim=0) - per_round
                       + every[:rank].sum(dim=0))
            self.dropped = torch.clamp(per_round.sum(dim=0) - cap,
                                       min=0).sum()
            # Over the whole batch, as the capacity is.
            add("moe/picks", float(s * ranks * k))
            add("moe/max_load", per_round.sum(dim=0).max())
            add("moe/dropped", self.dropped)

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
        with span("enc/moe/experts"):
            h = F.relu(torch.bmm(xe, self.w1.to(dt))
                       + self.b1.to(dt)[:, None, :])
            ye = torch.bmm(h, self.w2.to(dt)) + self.b2.to(dt)[:, None, :]
        with span("enc/moe/combine"):
            # Gate-weighted return in f32, rounded to the block's type once.
            contrib = weight.to(dt).float()[:, None] * ye.reshape(
                local_e * local_cap, d)[flat].float()
            y = torch.zeros(s, d, dtype=torch.float32,
                            device=x.device).index_add(0, token, contrib)
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


#: The step of ``DroplessMoE``'s expert-bias update (DeepSeek-V3's
#: gamma; LFM2-8B-A1B's config gives only ``use_expert_bias``).
EXPERT_BIAS_RATE = 1e-3


class DroplessMoE(nn.Module):
    """LFM2-MoE's and DeepSeek-V3's sparse block: ``[B, T, D]`` in (f32)
    and out (f32).

    Routing, as Liquid AI's ``Lfm2MoeSparseMoeBlock`` and ``DeepseekV3MoE``
    with one expert group:

    * scores ``sigmoid(x @ gate^T)`` in f32;
    * each token's ``top_k`` experts chosen on ``score + expert_bias``; the
      bias steers the choice only;
    * gates are the chosen experts' scores, over their sum plus
      ``gate_eps`` (LFM2 1e-6, DeepSeek-V3 1e-20) where ``norm_topk_prob``,
      times ``routed_scaling_factor``;
    * no capacity: every pick is computed.

    ``shared`` (DeepSeek-V3's ``shared_experts``, a module ``[S, D] ->
    [S, D]``) runs on every token and is added to the routed sum; without
    it the block launches nothing more.

    The experts are SwiGLU without biases, ``w2 (silu(w1 x) * w3 x)``, each
    weight in ``nn.Linear``'s ``[out, in]`` layout (``w1``, ``w3`` ``[E, F,
    D]``, ``w2`` ``[E, D, F]``). The picks are sorted by expert (a stable
    sort, so an expert's rows keep the tokens' order) and the three
    products run as grouped products over the experts' uneven row counts
    (:func:`grouped_swiglu`), with the groups' ends (a cumulative count)
    left on the device: no padding, no loop over experts, no wait for the
    host. Each token's ``top_k`` results are gathered back and summed with
    their gates in f32.

    ``expert_bias`` (f32 buffer) moves after each optimizer step by the
    auxiliary-loss-free rule ``b_e += EXPERT_BIAS_RATE * sign(mean load -
    load_e)`` (DeepSeek-V3, arXiv:2412.19437 §2.1.2) over the last training
    forward's loads (:meth:`update_bias`); there is no auxiliary loss.

    Spans ``enc/moe/route``, ``enc/moe/experts`` (forward and backward),
    ``enc/moe/combine`` and, with ``shared``, ``enc/moe/shared``; counters
    ``moe/picks`` and ``moe/max_load`` (the most-loaded expert's picks,
    summed on the device in int64). No pick is dropped, so the block has
    no ``moe/dropped``."""

    def __init__(self, d_model: int, num_experts: int, dim_feedforward: int,
                 top_k: int = 4, norm_topk_prob: bool = True,
                 routed_scaling_factor: float = 1.0,
                 use_expert_bias: bool = True, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 shared: Optional[nn.Module] = None, gate_eps: float = 1e-6):
        super().__init__()
        d, e, f = d_model, num_experts, dim_feedforward
        self.num_experts, self.top_k = e, top_k
        self.norm_topk_prob = norm_topk_prob
        self.gate_eps = float(gate_eps)
        self.routed_scaling_factor = float(routed_scaling_factor)
        self.dtype = dtype
        self.gate = nn.Linear(d, e, bias=False)
        self.w1 = nn.Parameter(torch.empty(e, f, d))
        self.w3 = nn.Parameter(torch.empty(e, f, d))
        self.w2 = nn.Parameter(torch.empty(e, d, f))
        with torch.no_grad():
            for w in (self.gate.weight, self.w1, self.w3, self.w2):
                w.normal_(0.0, 0.02, generator=generator)
        if use_expert_bias:
            self.register_buffer("expert_bias", torch.zeros(e))
        else:
            self.expert_bias = None
        self.shared_experts = shared
        #: Picks per expert of the last training forward (int64 ``[E]``).
        self.load: Optional[torch.Tensor] = None

    def route(self, tokens: torch.Tensor):
        """``(chosen [S, k], gates [S, k])`` of the tokens ``[S, D]``."""
        scores = torch.sigmoid(tokens.float() @ self.gate.weight.float().T)
        choice = scores.detach()
        if self.expert_bias is not None:
            choice = choice + self.expert_bias
        chosen = torch.topk(choice, self.top_k, dim=-1).indices
        gates = scores.gather(1, chosen)
        if self.norm_topk_prob:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + self.gate_eps)
        return chosen, gates * self.routed_scaling_factor

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, t, d = x.shape
        s, k, dt = b * t, self.top_k, self.dtype
        tokens = x.reshape(s, d)
        with span("enc/moe/route"):
            chosen, gates = self.route(tokens)
            flat = chosen.reshape(-1)
            order = torch.argsort(flat, stable=True)
            counts = torch.zeros(self.num_experts, dtype=torch.int64,
                                 device=x.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            ends = torch.cumsum(counts, 0, dtype=torch.int32)
            xs = tokens.to(dt).index_select(0, order // k)
            add("moe/picks", float(s * k))
            add("moe/max_load", counts.max())
            if train:
                self.load = counts
        ys = grouped_swiglu(xs, self.w1.to(dt), self.w3.to(dt),
                            self.w2.to(dt), ends)
        with span("enc/moe/combine"):
            back = torch.empty_like(order)
            back[order] = torch.arange(s * k, device=x.device)
            y = (ys.index_select(0, back).view(s, k, d).float()
                 * gates[..., None]).sum(dim=1)
        if self.shared_experts is not None:
            with span("enc/moe/shared"):
                y = y + self.shared_experts(tokens).float()
        return y.reshape(b, t, d)

    @torch.no_grad()
    def update_bias(self) -> None:
        """``b_e += EXPERT_BIAS_RATE * sign(mean load - load_e)`` over the
        last training forward's loads; nothing without a bias or a
        forward."""
        if self.expert_bias is None or self.load is None:
            return
        load = self.load.float()
        self.expert_bias.add_(torch.sign(load.mean() - load),
                              alpha=EXPERT_BIAS_RATE)
        self.load = None


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Grouped product over row groups ending at ``ends`` (int32, on the
    device): ``a [P, K] x b [E, K, N] -> [P, N]``, group ``e``'s rows by
    ``b[e]``; or, with ``a`` ``[K, P]`` and ``b`` ``[P, N]``, one
    ``[K, N]`` product per group over its slice of ``P`` (``[E, K, N]``),
    the weight gradient. ``torch._grouped_mm``: one CUTLASS grouped GEMM
    on the card for bf16; the CPU computes the same function."""
    return torch._grouped_mm(a, b, offs=ends)


class _GroupedSwiGLU(torch.autograd.Function):
    """The experts' SwiGLU over picks sorted by expert: three grouped
    products forward, six backward (two data and one weight gradient per
    projection); the gate's activation recomputed from the saved
    ``h1 = x w1^T`` and ``h3 = x w3^T``."""

    @staticmethod
    def forward(ctx, xs, w1, w3, w2, ends):
        with span("enc/moe/experts"):
            h1 = grouped_mm(xs, w1.transpose(1, 2), ends)
            h3 = grouped_mm(xs, w3.transpose(1, 2), ends)
            y = grouped_mm(F.silu(h1) * h3, w2.transpose(1, 2), ends)
        ctx.save_for_backward(xs, w1, w3, w2, ends, h1, h3)
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, w1, w3, w2, ends, h1, h3 = ctx.saved_tensors
        with span("enc/moe/experts"):
            dy = dy.contiguous()
            h1f, h3f = h1.float(), h3.float()
            sig = torch.sigmoid(h1f)
            silu = h1f * sig
            act = (silu * h3f).to(xs.dtype)
            da = grouped_mm(dy, w2, ends).float()
            dw2 = grouped_mm(dy.t(), act, ends)
            dh1 = (da * h3f * sig * (1.0 + h1f * (1.0 - sig))).to(xs.dtype)
            dh3 = (da * silu).to(xs.dtype)
            dxs = grouped_mm(dh1, w1, ends) + grouped_mm(dh3, w3, ends)
            dw1 = grouped_mm(dh1.t(), xs, ends)
            dw3 = grouped_mm(dh3.t(), xs, ends)
        return dxs, dw1, dw3, dw2, None


def grouped_swiglu(xs, w1, w3, w2, ends) -> torch.Tensor:
    """``w2_e (silu(w1_e x) * w3_e x)`` for each row ``x`` of ``xs`` in
    expert ``e``'s group (groups end at ``ends``)."""
    return _GroupedSwiGLU.apply(xs, w1, w3, w2, ends)
