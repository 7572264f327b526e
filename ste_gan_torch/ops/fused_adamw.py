"""One-pass AdamW over all leaves of a network: the hand-written Hopper
kernel, its plain PyTorch version, and the optimizer state they share.

Replaces ``ste_gan_tpu/ops/fused_adamw.py::_adamw_kernel`` (Pallas, one
launch per leaf). The CUDA source is ``ste_gan_torch/csrc/adamw.cu``, whose
header says what bounds the kernel (device-memory bandwidth: 28 bytes per
parameter) and how its design meets it (one pass, one launch per network,
hyperparameters and step count in device memory).

Semantics equal ``optax.adamw`` as the JAX kernel computes it::

    m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g^2
    p' = p - lr*((m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p),  bc = 1 - b^t

The port updates parameters and moments in place and writes ``p'`` itself,
where JAX applies ``p + (p' - p)`` through ``optax.apply_updates``; the two
differ by at most one rounding of ``p``.

:func:`fused_adamw_` runs the plain version only when the parameters lie on
the CPU; on the card it launches the kernel or raises.
``fused_adamw_.launches`` counts kernel launches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from ste_gan_torch.ops import build

#: Elements per block of the kernel.
CHUNK = 32768


@dataclass
class AdamWState:
    """AdamW moments and hyperparameters of one network. ``hyper`` holds
    (lr, b1, b2, eps, wd) and ``count`` the number of updates taken, both
    in device memory next to the parameters."""

    params: List[torch.Tensor]
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]
    hyper: torch.Tensor
    count: torch.Tensor
    #: Device tables of the kernel (built on the card only).
    tables: Optional[dict] = field(default=None, repr=False)


def _tables(params, exp_avg, exp_avg_sq, device) -> dict:
    """Pointer, size and chunk tables of the fixed buffers; they stay valid
    because the port updates these tensors in place."""
    sizes, leaf, start = [], [], []
    for i, p in enumerate(params):
        n = p.numel()
        sizes.append(n)
        for s in range(0, n, CHUNK):
            leaf.append(i)
            start.append(s)

    def table(vals, dtype):
        return torch.tensor(vals, dtype=dtype).to(device)

    p_ptrs = [p.data_ptr() for p in params]
    return {
        "p_host": p_ptrs,
        "p": table(p_ptrs, torch.int64),
        "m": table([t.data_ptr() for t in exp_avg], torch.int64),
        "v": table([t.data_ptr() for t in exp_avg_sq], torch.int64),
        "sizes": table(sizes, torch.int64),
        "leaf": table(leaf, torch.int32),
        "start": table(start, torch.int64),
        "n_chunks": len(leaf),
    }


def adamw_init(params: Sequence[torch.Tensor], lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-2) -> AdamWState:
    params = list(params)
    for p in params:
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise TypeError("AdamW takes contiguous f32 parameters")
    device = params[0].device
    exp_avg = [torch.zeros_like(p) for p in params]
    exp_avg_sq = [torch.zeros_like(p) for p in params]
    hyper = torch.tensor([lr, b1, b2, eps, weight_decay],
                         dtype=torch.float32).to(device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    tables = (_tables(params, exp_avg, exp_avg_sq, device)
              if device.type == "cuda" else None)
    return AdamWState(params, exp_avg, exp_avg_sq, hyper, count, tables)


def adamw_plain_(params, grads, exp_avg, exp_avg_sq, hyper, count) -> None:
    """The update in plain PyTorch ops, leaf by leaf, in place. ``count`` is
    the number of updates including this one."""
    lr, b1, b2, eps, wd = hyper.unbind()
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, exp_avg, exp_avg_sq):
            m_new = b1 * m + (1.0 - b1) * g
            v_new = b2 * v + (1.0 - b2) * (g * g)
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p
            p.copy_(p - lr * update)
            m.copy_(m_new)
            v.copy_(v_new)


def _launch(state: AdamWState, grads: List[torch.Tensor]) -> None:
    tab = state.tables
    if [p.data_ptr() for p in state.params] != tab["p_host"]:
        raise RuntimeError("a parameter was reallocated after adamw_init "
                           "(e.g. moved to another device); build the "
                           "optimizer state again")
    # The gradients are new tensors every step: their pointer table goes up
    # through pinned memory without waiting for the device (the caching
    # host allocator keeps the block until the copy has run).
    g_ptrs = torch.tensor([g.data_ptr() for g in grads],
                          dtype=torch.int64).pin_memory()
    g_ptrs = g_ptrs.to(state.hyper.device, non_blocking=True)
    lib = build.load("adamw")
    err = lib.adamw_multi_tensor(
        tab["p"].data_ptr(), g_ptrs.data_ptr(), tab["m"].data_ptr(),
        tab["v"].data_ptr(), tab["sizes"].data_ptr(), tab["leaf"].data_ptr(),
        tab["start"].data_ptr(), tab["n_chunks"], CHUNK,
        state.hyper.data_ptr(), state.count.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "adamw_multi_tensor")


def fused_adamw_(state: AdamWState, grads: Sequence[torch.Tensor]) -> None:
    """One AdamW step over every leaf of ``state``, in place."""
    grads = list(grads)
    if len(grads) != len(state.params):
        raise ValueError(f"{len(grads)} gradients for {len(state.params)} "
                         f"parameters")
    for p, g in zip(state.params, grads):
        if g.shape != p.shape or g.dtype != torch.float32 or g.device != p.device:
            raise TypeError(f"gradient {tuple(g.shape)} {g.dtype} {g.device} "
                            f"does not match parameter {tuple(p.shape)}")
    grads = [g.contiguous() for g in grads]
    state.count.add_(1)
    device = state.hyper.device
    if device.type == "cpu":
        adamw_plain_(state.params, grads, state.exp_avg, state.exp_avg_sq,
                     state.hyper, state.count)
        return
    if device.type != "cuda":
        raise RuntimeError(f"AdamW runs on cuda or cpu, not {device}")
    _launch(state, grads)
    fused_adamw_.launches += 1


fused_adamw_.launches = 0


def set_learning_rate(state: AdamWState, lr: float) -> AdamWState:
    """Write the learning rate into device memory (a fill, no host wait)."""
    state.hyper[0].fill_(lr)
    return state
