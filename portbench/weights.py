"""Seeded weights for the reference's modules, made on the device.

Every network's weights come from two flat draws of one
``torch.Generator`` seeded with the run's seed (uniform on [-1, 1) and
standard normal), cut into leaves and scaled by PyTorch's default rules:
convs and linears U(+-1/sqrt(fan_in)) with their biases alike; weight norm
``g = ||v||`` per output channel; spectral norm ``u`` a unit normal vector
and ``v = unit(W^T u)``; embeddings N(0, 1); the attention projections and
relative-position tables with their published normal scales; norms 1 and
0, running variance 1. The result is a state dict by the published names,
which the benchmark loads into the program and into the reference alike.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

from portbench.reference import nets

Plan = List[Tuple[str, str, Tuple[int, ...], float]]


def _plan(module: nn.Module) -> Plan:
    """``(name, draw, shape, scale)`` per leaf: ``draw`` is ``u`` (uniform
    times scale), ``n`` (normal times scale), or a rule filled later."""
    out: Plan = []
    for prefix, m in module.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, nets._Conv):
            fan_in = math.prod(m.wshape[1:])
            bound = 1.0 / math.sqrt(fan_in)
            wname = {nets.PlainConv: "weight", nets.WNConv: "weight_v",
                     nets.SNConv: "weight_orig"}[type(m)]
            out.append((pre + wname, "u", m.wshape, bound))
            if m.bias is not None:
                out.append((pre + "bias", "u", (m.wshape[0],), bound))
            if isinstance(m, nets.WNConv):
                out.append((pre + "weight_g", "wn", tuple(m.weight_g.shape), 0))
            if isinstance(m, nets.SNConv):
                out.append((pre + "weight_u", "n", (m.wshape[0],), 1.0))
                out.append((pre + "weight_v", "sn", tuple(m.weight_v.shape), 0))
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            out.append((pre + "weight", "u", tuple(m.weight.shape), bound))
            out.append((pre + "bias", "u", tuple(m.bias.shape), bound))
        elif isinstance(m, nn.Embedding):
            out.append((pre + "weight", "n", tuple(m.weight.shape), 1.0))
        elif isinstance(m, nets.Attention):
            h, d, dh = m.w_q.shape
            std = math.sqrt(2.0 / ((d + h) * dh))
            std_o = math.sqrt(2.0 / ((dh + h) * d))
            for name in ("w_q", "w_k", "w_v"):
                out.append((pre + name, "n", (h, d, dh), std))
            out.append((pre + "w_o", "n", (h, dh, d), std_o))
        elif isinstance(m, nets.RelPos):
            shape = tuple(m.embeddings.shape)
            out.append((pre + "embeddings", "n", shape, shape[2] ** -0.5))
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            n = m.weight.shape[0]
            out.append((pre + "weight", "one", (n,), 0))
            out.append((pre + "bias", "zero", (n,), 0))
            if isinstance(m, nn.BatchNorm1d):
                out.append((pre + "running_mean", "zero", (n,), 0))
                out.append((pre + "running_var", "one", (n,), 0))
                out.append((pre + "num_batches_tracked", "count", (), 0))
    return out


def seeded_state(modules: Iterable[Tuple[str, nn.Module]], seed: int,
                 device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{network: state dict}`` for each ``(network, module)`` given (the
    modules may live on the meta device; only their structure is read)."""
    plans = {key: _plan(m) for key, m in modules}
    sizes = {"u": 0, "n": 0}
    for plan in plans.values():
        for _, draw, shape, _ in plan:
            if draw in sizes:
                sizes[draw] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = {"u": torch.rand(sizes["u"], generator=gen, device=device) * 2 - 1,
            "n": torch.randn(sizes["n"], generator=gen, device=device)}
    used = {"u": 0, "n": 0}
    states = {}
    for key, plan in plans.items():
        sd: Dict[str, torch.Tensor] = {}
        for name, draw, shape, scale in plan:
            if draw in flat:
                n = math.prod(shape)
                sd[name] = flat[draw][used[draw]:used[draw] + n].view(
                    shape) * scale
                used[draw] += n
            elif draw == "one":
                sd[name] = torch.ones(shape, device=device)
            elif draw == "zero":
                sd[name] = torch.zeros(shape, device=device)
            elif draw == "count":
                sd[name] = torch.zeros((), dtype=torch.long, device=device)
        for name, draw, shape, _ in plan:
            base = name.rsplit(".", 1)[0]
            if draw == "wn":
                sd[name] = nets._norm_rows(sd[base + ".weight_v"]).view(shape)
            elif draw == "sn":
                w = sd[base + ".weight_orig"]
                u = nets._unit(sd[base + ".weight_u"])
                sd[base + ".weight_u"] = u
                sd[name] = nets._unit(w.reshape(w.shape[0], -1).T @ u)
        states[key] = sd
    return states
