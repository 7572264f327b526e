"""The reference's training steps: STE-GAN's fused adversarial step and the
encoder's pre-training step, with their AdamW, in plain PyTorch.

GAN step, in the published order: the generator's forward once; the
discriminator's LS-GAN loss on the detached fake and its AdamW update; the
generator's loss (adversarial + 15 x multi-window TD + unit distance +
phoneme CE + 7 x feature matching) through the updated discriminator and
the frozen encoder (eval mode), and its AdamW update; then the generator's
EMA with the ramped decay ``min(decay, (1+t)/(10+t))`` in f32.

Encoder step: the left shift, batch statistics and dropout of a training
forward; the voiced loss (per utterance, the mean of 0.5 x unit distance
+ 0.5 x CE over its frames, summed over voiced utterances and divided by
the batch's utterance count) plus the silent loss (each silent
utterance's costs aligned by DTW to its parallel voiced targets, the mean
aligned cost, summed and divided likewise); AdamW with weight decay 1e-5.

Both steps record what the benchmark compares: each step's losses, the
first step's forward outputs and gradient per leaf, and the parameters
(and the GAN's EMA and spectral-norm vectors) after the last step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import losses as L
from portbench.reference.nets import MaskStream
from portbench.reference.precision import Precision


class AdamW:
    """``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g^2``,
    ``p -= lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)``."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, wd: float):
        self.params = list(params)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        b1 = torch.tensor(self.b1, dtype=torch.float32)
        b2 = torch.tensor(self.b2, dtype=torch.float32)
        bc1 = float(1.0 - b1 ** self.t)
        bc2 = float(1.0 - b2 ** self.t)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            p.sub_(self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                              + self.wd * p))


@dataclass
class Record:
    """What a run of steps leaves to compare: ``losses[step][name]``,
    ``grads[network][leaf]`` (the first step's gradient norms) and
    ``params[network][leaf]`` (the parameters after the last step)."""

    losses: List[Dict[str, float]]
    grads: Dict[str, Dict[str, float]]
    params: Dict[str, Dict[str, torch.Tensor]]
    #: The first step's forward outputs, by name, on the host.
    outputs: Dict[str, torch.Tensor]
    #: BatchNorm running variances after the last step, by buffer name.
    stats: Optional[Dict[str, torch.Tensor]] = None
    #: The generator's EMA after the last step, by leaf.
    ema: Optional[Dict[str, torch.Tensor]] = None
    #: Spectral-norm power-iteration vectors after the last step.
    sn: Optional[Dict[str, torch.Tensor]] = None


def _norms(names, tensors) -> Dict[str, float]:
    vals = torch.stack([t.detach().float().norm() for t in tensors]).cpu()
    return dict(zip(names, vals.tolist()))


@dataclass
class GanHyper:
    lr: float
    b1: float
    b2: float
    ema: float
    td: float
    su: float
    ph: float
    fm: float
    eps: float = 1e-8
    wd: float = 1e-2


def ema_decay(decay: float, step: int) -> float:
    """``min(decay, (1+t)/(10+t))`` in f32."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return float(torch.minimum(torch.tensor(decay, dtype=torch.float32),
                               (1.0 + t) / (10.0 + t)))


def gan_steps(gen, disc, enc, batches: Sequence[Dict[str, torch.Tensor]],
              hyper: GanHyper, p: Precision) -> Record:
    """Runs the GAN step once per batch (``feats``, ``session``, ``real``,
    ``units``, ``phonemes``; ``real`` f32 ``[B, T, 8]``), updating the
    modules in place. ``enc`` is frozen."""
    enc.requires_grad_(False)
    g_names = [n for n, _ in gen.named_parameters()]
    d_names = [n for n, _ in disc.named_parameters()]
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())
    opt_g = AdamW(g_params, hyper.lr, hyper.b1, hyper.b2, hyper.eps, hyper.wd)
    opt_d = AdamW(d_params, hyper.lr, hyper.b1, hyper.b2, hyper.eps, hyper.wd)
    ema = [q.detach().clone() for q in g_params]
    losses, grads, outputs = [], {}, {}
    with p.active():
        for step, batch in enumerate(batches):
            real = batch["real"].float()
            fake = gen(batch["feats"], batch["session"], p)
            if step == 0:
                outputs = {"fake": fake.detach().float().cpu()}

            disc.requires_grad_(True)
            fake_maps, real_maps = disc(fake.detach(), real, p)
            loss_d = L.d_loss(fake_maps, real_maps)
            grads_d = torch.autograd.grad(loss_d, d_params)
            opt_d.step(grads_d)
            disc.requires_grad_(False)

            fake_maps, real_maps = disc(fake, real, p)
            su, ph = enc(fake, p)
            loss_g = (L.g_adversarial(fake_maps)
                      + hyper.td * L.multi_td(real, fake)
                      + hyper.su * L.unit_distance(batch["units"], su)
                      + hyper.ph * L.phoneme_ce(ph, batch["phonemes"])
                      + hyper.fm * L.feature_matching(fake_maps, real_maps))
            grads_g = torch.autograd.grad(loss_g, g_params)
            opt_g.step(grads_g)
            d = ema_decay(hyper.ema, step)
            new = float(torch.tensor(1.0) - torch.tensor(d))
            with torch.no_grad():
                for e, q in zip(ema, g_params):
                    e.mul_(d).add_(q, alpha=new)
            if step == 0:
                grads = {"g": _norms(g_names, grads_g),
                         "d": _norms(d_names, grads_d)}
            losses.append({"d": loss_d.item(), "g": loss_g.item()})
    disc.requires_grad_(True)
    return Record(losses, grads, {
        "g": {n: q.detach() for n, q in zip(g_names, g_params)},
        "d": {n: q.detach() for n, q in zip(d_names, d_params)}}, outputs,
        ema=dict(zip(g_names, ema)),
        sn={n: b.detach().float().cpu().clone()
            for n, b in disc.named_buffers()
            if n.endswith(("weight_u", "weight_v"))})


# ---------------------------------------------------------------------------
# Encoder pre-training
# ---------------------------------------------------------------------------


def dtw_align(costs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Alignments ``[S, T1]`` (for each row ``i``, the column it aligns to)
    of cost matrices ``[S, T1, T2]`` from each slot's end cell: the
    accumulated cost ``D[0, 0] = 0``, ``D[i, j] = c[i, j] + min(D[i-1, j],
    D[i, j-1], D[i-1, j-1])`` off the first row and column (infinite
    there), then the walk back from the end cell to the first row or column
    by the first minimal predecessor in the order up, left, diagonal."""
    s, t1, t2 = costs.shape
    dtw = torch.full_like(costs, float("inf"), dtype=torch.float32)
    dtw[:, 0, 0] = 0.0
    c = costs.float()
    for d in range(2, t1 + t2 - 1):
        i = torch.arange(max(1, d - t2 + 1), min(t1 - 1, d - 1) + 1,
                         device=costs.device)
        if i.numel() == 0:
            continue
        j = d - i
        best = torch.minimum(torch.minimum(dtw[:, i - 1, j], dtw[:, i, j - 1]),
                             dtw[:, i - 1, j - 1])
        dtw[:, i, j] = c[:, i, j] + best
    out = torch.zeros((s, t1), dtype=torch.long, device=costs.device)
    slot = torch.arange(s, device=costs.device)
    i, j = ends[:, 0].long(), ends[:, 1].long()
    for _ in range(t1 + t2 - 2):
        active = (i > 0) & (j > 0)
        ic, jc = i.clamp(min=1), j.clamp(min=1)
        out[slot, ic] = torch.where(active, jc, out[slot, ic])
        cand = torch.stack([dtw[slot, ic - 1, jc], dtw[slot, ic, jc - 1],
                            dtw[slot, ic - 1, jc - 1]], dim=1)
        choice = torch.argmin(cand, dim=1)
        i = torch.where(active & (choice != 1), i - 1, i)
        j = torch.where(active & (choice != 0), j - 1, j)
    return out


@dataclass
class Utterance:
    """One corpus utterance: EMG ``[16 n, 8]`` and its targets ``[m, 256]``,
    ``[m]`` (``m == n`` when voiced; a silent one's come from its parallel
    voiced recording)."""

    emg: torch.Tensor
    units: torch.Tensor
    phonemes: torch.Tensor
    silent: bool


def encoder_loss(su, ph, utts: Sequence[Utterance], frames: int = 16):
    """The step's loss from the predictions ``[W, F, ...]`` of the folded
    windows (utterances concatenated in order, then cut into windows)."""
    su_flat = su.reshape(-1, su.shape[-1])
    ph_flat = ph.reshape(-1, ph.shape[-1])
    voiced = su_flat.new_zeros(())
    silent_costs, silent_utts = [], []
    offset = 0
    for u in utts:
        n = u.emg.shape[0] // frames
        sp, pp = su_flat[offset:offset + n], ph_flat[offset:offset + n]
        offset += n
        if not u.silent:
            dist = torch.sqrt(torch.sum(torch.square(
                u.units.float() - sp + 1e-6), dim=-1))
            ce = -torch.gather(F.log_softmax(pp, dim=-1), 1,
                               u.phonemes.long()[:, None])[:, 0]
            voiced = voiced + torch.mean(0.5 * dist + 0.5 * ce)
            continue
        dists = torch.sqrt(torch.sum(torch.square(
            sp[:, None, :] - u.units.float()[None, :, :]), dim=-1) + 1e-12)
        logp = F.log_softmax(pp, dim=-1)
        lp = torch.gather(logp, 1, u.phonemes.long()[None, :].expand(n, -1))
        silent_costs.append(0.5 * dists + 0.5 * (-lp))   # [pred, target]
        silent_utts.append(u)
    total = voiced
    if silent_costs:
        t_pred = max(c.shape[0] for c in silent_costs)
        t_tgt = max(c.shape[1] for c in silent_costs)
        padded = torch.stack([F.pad(c, (0, t_tgt - c.shape[1],
                                        0, t_pred - c.shape[0]))
                              for c in silent_costs])
        ends = torch.tensor([[c.shape[1] - 1, c.shape[0] - 1]
                             for c in silent_costs], device=su.device)
        align = dtw_align(padded.detach().transpose(1, 2), ends)
        for k, c in enumerate(silent_costs):
            m = c.shape[1]
            picked = c[align[k, :m], torch.arange(m, device=c.device)]
            total = total + picked.sum() / m
    return total / len(utts)


def fold_windows(utts: Sequence[Utterance], windows: int,
                 window: int = 1600) -> torch.Tensor:
    emg = torch.cat([u.emg for u in utts])
    out = emg.new_zeros((windows * window, emg.shape[1]))
    out[:emg.shape[0]] = emg
    return out.view(windows, window, -1)


@dataclass
class EncHyper:
    lrs: Sequence[float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    wd: float = 1e-5
    dropout: float = 0.2


def encoder_steps(enc, batches: Sequence[Sequence[Utterance]],
                  shifts: Sequence[int], dropout: Optional[torch.Generator],
                  hyper: EncHyper, p: Precision, windows: int) -> Record:
    """Runs the encoder's training step once per batch of utterances, with
    the given left shifts and the dropout masks of ``dropout``."""
    names = [n for n, _ in enc.named_parameters()]
    params = list(enc.parameters())
    opt = AdamW(params, hyper.lrs[0], hyper.b1, hyper.b2, hyper.eps, hyper.wd)
    drop = MaskStream(dropout, hyper.dropout) if dropout is not None else None
    losses, grads, outputs = [], {}, {}
    with p.active():
        for step, (utts, shift) in enumerate(zip(batches, shifts)):
            x = fold_windows(utts, windows).float()
            su, ph = enc(x, p, train=True, shift=shift, drop=drop)
            if step == 0:
                outputs = {"units": su.detach().float().cpu(),
                           "phonemes": ph.detach().float().cpu()}
            loss = encoder_loss(su, ph, utts)
            g = torch.autograd.grad(loss, params)
            opt.lr = hyper.lrs[step]
            opt.step(g)
            if step == 0:
                grads = {"enc": _norms(names, g)}
            losses.append({"loss": loss.item()})
    stats = {n: b.detach().float().cpu() for n, b in enc.named_buffers()
             if n.endswith("running_var")}
    return Record(losses, grads,
                  {"enc": {n: q.detach() for n, q in zip(names, params)}},
                  outputs, stats)

