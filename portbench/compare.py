"""The numbers that decide ``correct`` for a training cell.

A run of the first steps on either side is summed up as a
:class:`Summary`: each step's losses, the first step's gradient norm per
leaf and the norm of each leaf's change over the steps. Against the
reference's summary:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap.<network>``: the network's worst leaf's gap between the two
  gradient norms, over the reference's norm of that leaf or of the
  network's median leaf, whichever is larger; ``grad_median.<network>``
  the median leaf's such gap;
* ``change_gap``: the same for the change of the parameters, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf below that, such as a bias ahead of a normalisation,
  moves under Adam by round-off alone);
* ``bn_var_gap`` (where the steps update BatchNorm statistics): the largest
  relative gap of a running variance, over every channel;
* ``out_gap``: the largest relative gap, ``||prog - ref|| / ||ref||``,
  of an output of the first step's forward (the generator's EMG; the
  encoder's unit and phoneme predictions), which depends on the forward's
  rounding alone;
* ``ema_gap`` (where the steps keep a generator EMA): ``change_gap``'s
  measure for the EMA's change over the steps, on the leaves that
  ``change_gap`` takes;
* ``sn_gap`` (where a spectral norm keeps power-iteration vectors): the
  largest ``||prog - ref|| / ||ref||`` of a vector after the steps.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

Norms = Dict[str, Dict[str, float]]

#: A leaf whose reference gradient norm is below this share of the median
#: leaf's is left out of ``change_gap``.
MOVED = 1e-3


@dataclass
class Summary:
    losses: List[Dict[str, float]]
    grads: Norms
    changes: Norms
    #: BatchNorm running variances after the steps, by buffer name (the
    #: encoder's training cells).
    stats: Optional[Dict[str, torch.Tensor]] = None
    #: The first step's forward outputs, by name, on the host.
    outputs: Optional[Dict[str, torch.Tensor]] = None
    #: The norm of each generator EMA leaf's change over the steps.
    ema: Optional[Dict[str, float]] = None
    #: Spectral-norm power-iteration vectors after the steps, by name.
    sn: Optional[Dict[str, torch.Tensor]] = None


def buffers(module, suffixes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """The module's buffers whose names end in one of ``suffixes``, on the
    host in f32."""
    return {n: b.detach().float().cpu().clone()
            for n, b in module.named_buffers() if n.endswith(suffixes)}


def running_vars(module) -> Dict[str, torch.Tensor]:
    return buffers(module, ("running_var",))


def sn_vectors(module) -> Dict[str, torch.Tensor]:
    return buffers(module, ("weight_u", "weight_v"))


class FirstOutputs:
    """Keeps the outputs of a module's first forward (a tensor or a tuple
    of them, named by ``names``) on the host, then stops listening."""

    def __init__(self, module, names: Tuple[str, ...]):
        self.names, self.outputs = names, None
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, module, args, out) -> None:
        outs = out if isinstance(out, tuple) else (out,)
        self.outputs = {n: o.detach().float().cpu()
                        for n, o in zip(self.names, outs)}
        self.handle.remove()


def stats_gap(prog: Dict[str, torch.Tensor],
              ref: Dict[str, torch.Tensor]) -> float:
    """The largest relative gap of a running variance over every channel
    of every BatchNorm."""
    return max(float(((prog[n] - ref[n]).abs() / ref[n]).max()) for n in ref)


def rel_gap(prog: Dict[str, torch.Tensor],
            ref: Dict[str, torch.Tensor]) -> float:
    """The largest ``||prog - ref|| / ||ref||`` over the tensors of
    ``ref``; a tensor of another shape (rows left out) reads 1."""
    def gap(p, r):
        if p.shape != r.shape:
            return 1.0
        return float((p.float() - r.float()).norm()
                     / r.float().norm().clamp(min=1e-30))
    return max(gap(prog[n], ref[n]) for n in ref)


def change_norms(after: Dict[str, Dict[str, torch.Tensor]],
                 before: Dict[str, Dict[str, torch.Tensor]]) -> Norms:
    """``||after - before||`` per leaf, per network of ``after``."""
    out = {}
    for net, leaves in after.items():
        names = list(leaves)
        vals = torch.stack([(leaves[n].float() - before[net][n].float()).norm()
                            for n in names]).cpu().tolist()
        out[net] = dict(zip(names, vals))
    return out


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[List[str]] = None) -> Tuple[float, str]:
    names = list(ref) if leaves is None else leaves
    med = statistics.median(ref[n] for n in names)
    worst = (0.0, "")
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        worst = max(worst, (gap, n))
    return worst


def moved(grads: Dict[str, float]) -> List[str]:
    med = statistics.median(grads.values())
    return [n for n, g in grads.items() if g >= MOVED * med]


def training_numbers(prog: Summary, ref: Summary,
                     detail: bool = False) -> Dict[str, float]:
    """The numbers, ``grad_gap`` and ``grad_median`` per network
    (``grad_gap.<network>``); ``detail`` adds each worst leaf's name and
    each step's loss gap (for the look at what sets a number)."""
    steps = [max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r)
             for p, r in zip(prog.losses, ref.losses)]
    out: Dict = {"loss_gap": max(steps)}
    worst_change = (0.0, "")
    for net in ref.grads:
        gap, leaf = worst_leaf(prog.grads[net], ref.grads[net])
        out[f"grad_gap.{net}"] = gap
        out[f"grad_median.{net}"] = median_gap(prog.grads[net],
                                               ref.grads[net])
        change = worst_leaf(prog.changes[net], ref.changes[net],
                            moved(ref.grads[net]))
        worst_change = max(worst_change, (change[0], f"{net}:{change[1]}"))
        if detail:
            out[f"grad_leaf.{net}"] = leaf
    out["change_gap"] = worst_change[0]
    if ref.stats:
        out["bn_var_gap"] = stats_gap(prog.stats, ref.stats)
    if ref.outputs:
        out["out_gap"] = rel_gap(prog.outputs, ref.outputs)
    if ref.ema:
        out["ema_gap"] = worst_leaf(prog.ema, ref.ema,
                                    moved(ref.grads["g"]))[0]
    if ref.sn:
        out["sn_gap"] = rel_gap(prog.sn, ref.sn)
    if detail:
        out.update(change_leaf=worst_change[1], step_loss_gaps=steps)
    return out


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[List[str]] = None) -> float:
    """The median over leaves of the gap ``worst_leaf`` takes the largest
    of."""
    names = list(ref) if leaves is None else leaves
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                             for n in names)


def held(numbers: Dict[str, float], limits: Dict[str, float]
         ) -> List[Tuple[str, float, float]]:
    """``(name, value, limit)`` for each limited number. The numbers
    without a limit are printed on standard error beside them, as
    readings."""
    import sys

    free = {k: v for k, v in numbers.items() if k not in limits}
    if free:
        print("portbench readings: " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(free.items())), file=sys.stderr)
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]
