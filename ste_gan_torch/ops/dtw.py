"""Monotonic DTW alignment over a batch of slots: the hand-written Hopper
kernel, its plain PyTorch version, and the numpy oracles.

Counterpart of ``ste_gan_tpu/ops/dtw.py``. The JAX package runs the DP as an
anti-diagonal wavefront ``lax.scan`` and the backtrace as a
``lax.while_loop``, vmapped over the silent slots inside its jitted encoder
step (``ste_gan_tpu/train/encoder.py:136-186``); it is not a Pallas kernel.
In eager PyTorch the same wavefront costs about ten launches per
anti-diagonal and the backtrace a host wait per iteration, so the port runs
both in one CUDA kernel, ``dtw_align_kernel`` (``ste_gan_torch/csrc/dtw.cu``,
whose header says what bounds it).

DP semantics, identical to the reference and the JAX version:
``dtw[0, 0] = 0`` (not ``costs[0, 0]``), the rest of the first row and
column infinite, ``dtw[i, j] = costs[i, j] + min(min(up, left), diag)`` in
f32; the backtrace walks from the end cell taking the first minimal
predecessor in the order (up, left, diag), records for each row its matched
column and stops at the first row or column. ``min`` is exact, so the f32
DP equals JAX's bit for bit and the alignments are identical.

Each slot ``s`` has its own end cell ``ends[s] = (i, j)``: only the block
``[i + 1, j + 1]`` of its padded cost matrix is valid, rows past ``i`` of
its alignment stay 0, and a slot with ``i < 0`` or ``j < 0`` (an empty
slot) aligns to all zeros.

:func:`dtw_directions_plain` and :func:`dtw_backtrace_codes_plain` are the
kernel's own formulation: a 2-bit direction code per cell, from the
backtrace's comparisons in its order, and a walk that reads one code a
step. :func:`plan_dtw` says whether a slot's codes fit in shared memory.

:func:`dtw_alignment_batched` runs the plain version only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
``dtw_alignment_batched.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ste_gan_torch.ops import build
from ste_gan_torch.utils.profiling import span

_INF = float("inf")


# ---------------------------------------------------------------------------
# numpy oracles (the JAX package's ``dtw_matrix_np`` / ``dtw_alignment_np``)
# ---------------------------------------------------------------------------


def dtw_matrix_np(costs: np.ndarray) -> np.ndarray:
    t1, t2 = costs.shape
    dtw = np.zeros_like(costs, dtype=np.float64)
    dtw[0, 1:] = np.inf
    dtw[1:, 0] = np.inf
    for i in range(1, t1):
        for j in range(1, t2):
            dtw[i, j] = costs[i, j] + min(dtw[i - 1, j], dtw[i, j - 1],
                                          dtw[i - 1, j - 1])
    return dtw


def dtw_alignment_np(costs: np.ndarray) -> List[int]:
    dtw = dtw_matrix_np(costs)
    i, j = costs.shape[0] - 1, costs.shape[1] - 1
    results = [0] * costs.shape[0]
    while i > 0 and j > 0:
        results[i] = j
        i, j = min([(i - 1, j), (i, j - 1), (i - 1, j - 1)],
                   key=lambda x: dtw[x[0], x[1]])
    return results


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def dtw_matrix_plain(costs: torch.Tensor) -> torch.Tensor:
    """Accumulated costs ``[S, T1, T2]`` f32 by an anti-diagonal wavefront,
    vectorised over slots and over the cells of each diagonal."""
    s, t1, t2 = costs.shape
    dtw = torch.full_like(costs, _INF, dtype=torch.float32)
    dtw[:, 0, 0] = 0.0
    c = costs.float()
    for d in range(2, t1 + t2 - 1):
        # Interior cells (i, d - i) with 1 <= i < t1 and 1 <= d - i < t2.
        i = torch.arange(max(1, d - t2 + 1), min(t1 - 1, d - 1) + 1,
                         device=costs.device)
        if i.numel() == 0:
            continue
        j = d - i
        best = torch.minimum(torch.minimum(dtw[:, i - 1, j], dtw[:, i, j - 1]),
                             dtw[:, i - 1, j - 1])
        dtw[:, i, j] = c[:, i, j] + best
    return dtw


def dtw_backtrace_plain(dtw: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``[S, T1]`` int32 alignments from each slot's end cell, vectorised
    over slots. Every step lowers ``i + j`` by at least one, so
    ``T1 + T2 - 2`` steps finish every slot; the loop never waits for the
    device. Ends past the padded shape are clamped to it."""
    s, t1, t2 = dtw.shape
    out = torch.zeros((s, t1), dtype=torch.int32, device=dtw.device)
    if t1 < 2 or t2 < 2:  # the walk stops at once: all rows align to 0
        return out
    slot = torch.arange(s, device=dtw.device)
    i = ends[:, 0].long().clamp(max=t1 - 1)
    j = ends[:, 1].long().clamp(max=t2 - 1)
    for _ in range(t1 + t2 - 2):
        active = (i > 0) & (j > 0)
        ic, jc = i.clamp(min=1), j.clamp(min=1)
        out[slot, ic] = torch.where(active, jc.int(), out[slot, ic])
        cand = torch.stack([dtw[slot, ic - 1, jc], dtw[slot, ic, jc - 1],
                            dtw[slot, ic - 1, jc - 1]], dim=1)
        choice = torch.argmin(cand, dim=1)  # the first minimum
        i = torch.where(active & (choice != 1), i - 1, i)
        j = torch.where(active & (choice != 0), j - 1, j)
    return out


#: Direction codes of the kernel's backtrace: the first minimal predecessor
#: in the order up, left, diag.
UP, LEFT, DIAG = 0, 1, 2


def dtw_directions_plain(costs: torch.Tensor) -> torch.Tensor:
    """Each cell's direction code ``[S, T1, T2]`` uint8 as the kernel
    stores it: the first minimal predecessor in the order up, left, diag,
    from the comparisons ``up <= left and up <= diag`` (up), else
    ``left <= diag`` (left), else diag, on the f32 values that enter the
    cell's min. The first row and column (never stepped from) hold 0."""
    dtw = dtw_matrix_plain(costs)
    up, left, diag = dtw[:, :-1, 1:], dtw[:, 1:, :-1], dtw[:, :-1, :-1]
    inner = torch.where((up <= left) & (up <= diag), UP,
                        torch.where(left <= diag, LEFT, DIAG))
    codes = torch.zeros(dtw.shape, dtype=torch.uint8, device=costs.device)
    codes[:, 1:, 1:] = inner.to(torch.uint8)
    return codes


def dtw_backtrace_codes_plain(codes: torch.Tensor, ends: torch.Tensor):
    """The kernel's walk over the direction codes ``[S, T1, T2]``: from each
    slot's end cell (clamped to the padded shape) while ``i > 0`` and
    ``j > 0``, ``out[i] = j``, then one step as the cell's code says.
    Returns the alignments ``[S, T1]`` int32 and each slot's number of
    steps ``[S]`` int64 (the walk's length, what its chain is made of)."""
    s, t1, t2 = codes.shape
    out = torch.zeros((s, t1), dtype=torch.int32, device=codes.device)
    steps = torch.zeros(s, dtype=torch.int64, device=codes.device)
    slot = torch.arange(s, device=codes.device)
    i = ends[:, 0].long().clamp(max=t1 - 1)
    j = ends[:, 1].long().clamp(max=t2 - 1)
    for _ in range(t1 + t2 - 2):  # never waits for the device
        active = (i > 0) & (j > 0)
        ic, jc = i.clamp(min=0), j.clamp(min=0)
        out[slot, ic] = torch.where(active, jc.int(), out[slot, ic])
        code = codes[slot, ic, jc].long()
        steps += active.long()
        i = torch.where(active & (code != LEFT), i - 1, i)
        j = torch.where(active & (code != UP), j - 1, j)
    return out, steps


def dtw_alignment_plain(costs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    return dtw_backtrace_plain(dtw_matrix_plain(costs), ends)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


#: Shared memory a block may hold on Hopper (bytes).
SMEM_LIMIT = 232448
_MAX_THREADS, _HEADER = 1024, 256
#: Bytes a thread's share of the cost tiles takes: 3 tiles of 8 + 1 floats.
_TILE_BYTES = 4 * 3 * (8 + 1)


class DtwPlan(NamedTuple):
    """How ``dtw_align_kernel`` takes slots of ``[t1, t2]`` costs:
    ``threads`` per block (one a row, strips of them when ``t1`` is
    larger), ``words_per_row`` of 16 direction codes, ``shared_codes``
    (else a global scratch), ``smem_bytes`` per block."""
    threads: int
    words_per_row: int
    shared_codes: bool
    smem_bytes: int


def plan_dtw(t1: int, t2: int) -> DtwPlan:
    """The kernel's launch for ``[t1, t2]`` slots: ``min(1024, t1)``
    threads rounded up to a warp; 256 bytes of warp-edge values, three
    cost tiles of 8 diagonals a thread, a boundary row of ``t2`` floats
    when the rows come in strips, and the codes (``4 t1 ceil(t2 / 16)``
    bytes) when they fit within a block's shared memory. Raises if even
    the rest does not fit."""
    threads = min(_MAX_THREADS, -(-t1 // 32) * 32)
    wpr = -(-t2 // 16)
    header = (_HEADER + _TILE_BYTES * threads
              + (4 * (-(-t2 // 4) * 4) if t1 > threads else 0))
    if header > SMEM_LIMIT:
        raise ValueError(f"DTW of {t1} x {t2}: the boundary row of {t2} "
                         f"columns exceeds a block's shared memory")
    codes = 4 * t1 * wpr
    if header + codes <= SMEM_LIMIT:
        return DtwPlan(threads, wpr, True, header + codes)
    return DtwPlan(threads, wpr, False, header)


def _launch(costs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    s, t1, t2 = costs.shape
    plan = plan_dtw(t1, t2)
    out = torch.empty((s, t1), dtype=torch.int32, device=costs.device)
    # Direction codes past shared memory: a global scratch, each slot's
    # valid block written before the walk reads it.
    codes = (None if plan.shared_codes else torch.empty(
        (s, t1, plan.words_per_row), dtype=torch.int32, device=costs.device))
    lib = build.load("dtw")
    err = lib.dtw_align(costs.data_ptr(), ends.data_ptr(),
                        None if codes is None else codes.data_ptr(),
                        out.data_ptr(), s, t1, t2, plan.threads,
                        plan.words_per_row, int(plan.shared_codes),
                        plan.smem_bytes,
                        torch.cuda.current_stream().cuda_stream)
    build.check(err, "dtw_align")
    return out


def dtw_alignment_batched(costs: torch.Tensor, ends: torch.Tensor
                          ) -> torch.Tensor:
    """Alignments ``[S, T1]`` int32 of ``costs [S, T1, T2]`` f32 from the
    end cells ``ends [S, 2]`` int32 (``(-1, -1)`` or any negative entry:
    an empty slot). No gradient flows through an alignment. Runs inside
    the ``dtw`` span (``utils/profiling.py``)."""
    if costs.dim() != 3 or ends.shape != (costs.shape[0], 2):
        raise ValueError(f"costs {tuple(costs.shape)} and ends "
                         f"{tuple(ends.shape)}: want [S, T1, T2] and [S, 2]")
    if costs.dtype != torch.float32 or ends.dtype != torch.int32:
        raise TypeError(f"costs {costs.dtype}, ends {ends.dtype}: want "
                        f"float32 and int32")
    if ends.device != costs.device:
        raise ValueError("costs and ends lie on different devices")
    with span("dtw"):
        return _alignment(costs.detach().contiguous(), ends.contiguous())


def _alignment(costs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    if costs.device.type == "cpu":
        return dtw_alignment_plain(costs, ends)
    if costs.device.type != "cuda":
        raise RuntimeError(f"DTW runs on cuda or cpu, not {costs.device}")
    if costs.shape[0] == 0:
        return torch.zeros((0, costs.shape[1]), dtype=torch.int32,
                           device=costs.device)
    out = _launch(costs, ends)
    dtw_alignment_batched.launches += 1
    return out


dtw_alignment_batched.launches = 0
