"""Zero-phase IIR filter cascades over a batch of f64 rows: the
hand-written Hopper kernel, its plain PyTorch version and the wrapper.

Counterpart of the JAX package's host filtering with
``scipy.signal.filtfilt`` (``ste_gan_tpu/etl/emg_dsp.py:31-46``, notch
harmonics and drift removal; ``:139-141``, the Hilbert envelope's
low-pass). That is no Pallas kernel; but an IIR filter is a chain of
dependent steps, which eager PyTorch would run at a launch or more per
sample, so the port runs the whole cascade in one CUDA kernel,
``filtfilt_kernel`` (``ste_gan_torch/csrc/iir.cu``, whose header says what
bounds it).

Semantics, stage by stage, as chained ``filtfilt(b, a, x)`` calls with
scipy's defaults: odd extension by ``padlen = 3 * max(len(a), len(b))`` at
both ends, a transposed direct-form-II pass forward from ``zi * x[0]`` and
one backward from ``zi * y[-1]``, the padding stripped. Each row has its
own length; every stage sees the previous stage's output. All in f64.

:func:`filtfilt_cascade` runs the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises. The kernel takes a
row-major buffer (:func:`kernel_buffer`) and runs each row resident in
shared memory or streamed through a ring, as :func:`plan_filtfilt` says.
``filtfilt_cascade.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from ste_gan_torch.device import resolve_device
from ste_gan_torch.etl.filters import filtfilt_stage
from ste_gan_torch.ops import build

#: Most taps a stage may have (filter order 7), the kernel's register state.
MAX_TAPS = 8

Design = Tuple[np.ndarray, np.ndarray]


def prepare_stages(designs: Sequence[Design]):
    """The kernel's stage table for ``designs`` (``(b, a)`` pairs):
    ``coefs [S, 3, MAX_TAPS]`` f64 (``b``, ``a`` and ``zi``, zero-padded),
    ``taps [S]`` and ``padlens [S]``."""
    coefs = np.zeros((len(designs), 3, MAX_TAPS))
    taps, padlens = [], []
    for s, (b, a) in enumerate(designs):
        bn, an, zi, padlen = filtfilt_stage(b, a)
        if not 2 <= len(bn) <= MAX_TAPS:
            raise ValueError(f"stage {s}: {len(bn)} taps; the kernel takes "
                             f"2-{MAX_TAPS}")
        coefs[s, 0, :len(bn)] = bn
        coefs[s, 1, :len(an)] = an
        coefs[s, 2, :len(zi)] = zi
        taps.append(len(bn))
        padlens.append(padlen)
    return coefs, np.asarray(taps, np.int32), np.asarray(padlens, np.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _lfilter_plain(buf: torch.Tensor, lo: int, his: List[int],
                   coefs: np.ndarray, n: int, reverse: bool) -> None:
    """One transposed-direct-form-II pass in place over ``buf [T, R]``,
    rows ending at ``his`` (exclusive), vectorised over rows, with scipy's
    (and the kernel's) order: ``y = z[0] + b[0] x``, then
    ``z[k] = (z[k + 1] + x b[k + 1]) - y a[k + 1]``. Forward, all rows start
    at ``lo`` from ``zi * x[lo]``; backward, each row starts at its own last
    sample from ``zi * y[hi - 1]`` (rows not yet started run on values they
    never use, and their state is reset when they start)."""
    b = torch.from_numpy(coefs[0, :n]).to(buf)
    a_rest = torch.from_numpy(coefs[1, 1:n]).to(buf)
    zi = torch.from_numpy(coefs[2, :n - 1]).to(buf)
    # z[k + 1] as a product with a 0/1 matrix, which adds no rounding.
    shift = torch.zeros(n - 1, n - 1, dtype=buf.dtype)
    shift[torch.arange(1, n - 1), torch.arange(0, n - 2)] = 1.0
    shift = shift.to(buf.device)
    hi_max = max(his)
    x = buf[lo:hi_max]
    xb = x[:, :, None] * b  # off the dependency chain
    xb0, xbr = xb[..., 0].unbind(0), xb[..., 1:].unbind(0)
    starts = {}
    if reverse:
        for i, h in enumerate(his):
            starts.setdefault(h - 1 - lo, []).append(i)
    ts = range(hi_max - 1 - lo, -1, -1) if reverse else range(hi_max - lo)
    z = zi[None, :] * x[ts[0]][:, None]
    ys = []
    for t in ts:
        if t in starts:
            rows = torch.tensor(starts[t], device=buf.device)
            z[rows] = zi[None, :] * x[t, rows][:, None]
        y = z[:, 0] + xb0[t]
        z = torch.addr(torch.addmm(xbr[t], z, shift), y, a_rest, alpha=-1)
        ys.append(y)
    if reverse:
        ys.reverse()
    buf[lo:hi_max] = torch.stack(ys)


def filtfilt_plain(buf: torch.Tensor, lengths: List[int], p0: int,
                   coefs: np.ndarray, taps: np.ndarray,
                   padlens: np.ndarray) -> None:
    """The cascade in place on the time-major ``buf [T, R]`` (row ``r`` at
    ``[p0, p0 + lengths[r])``), the kernel's arithmetic as torch ops."""
    rows = torch.arange(buf.shape[1], device=buf.device)
    n_t = torch.tensor(lengths, device=buf.device)
    for s in range(len(taps)):
        n, pad = int(taps[s]), int(padlens[s])
        i = torch.arange(pad, device=buf.device)
        left = buf[p0]
        buf[p0 - pad:p0] = 2.0 * left[None, :] - buf[p0 + pad - i]
        right = buf[p0 + n_t - 1, rows]
        dst = p0 + n_t[None, :] + i[:, None]
        src = p0 + n_t[None, :] - 2 - i[:, None]
        buf[dst, rows[None, :].expand_as(dst)] = (
            2.0 * right[None, :] - buf[src, rows[None, :].expand_as(src)])
        his = [p0 + length + pad for length in lengths]
        _lfilter_plain(buf, p0 - pad, his, coefs[s], n, reverse=False)
        _lfilter_plain(buf, p0 - pad, his, coefs[s], n, reverse=True)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


#: Shared memory a block may hold on Hopper (bytes).
SMEM_LIMIT = 232448
#: The streamed variant's ring: slots of CHUNK f64 each (``csrc/iir.cu``).
CHUNK, SLOTS = 2048, 4
_RESIDENT_HEADER, _STREAM_HEADER = 16, 128


class FiltfiltPlan(NamedTuple):
    """How ``filtfilt_kernel`` takes rows of ``width`` f64 (padding
    included): ``resident`` stages each row in shared memory whole,
    otherwise the passes stream it through a ring; ``smem_bytes`` per block;
    ``chunks`` the ring chunks a row spans (1 when resident)."""
    resident: bool
    width: int
    smem_bytes: int
    chunks: int


def plan_filtfilt(length: int, p0: int) -> FiltfiltPlan:
    """The kernel's variant for rows of ``length`` samples padded by ``p0``
    at both ends: the row buffer's ``width`` is ``length + 2 p0`` rounded up
    to even (16-byte rows for the bulk copies); a row stays resident when
    ``16 + 8 width`` bytes fit in a block's shared memory."""
    width = length + 2 * p0
    width += width % 2
    resident_bytes = _RESIDENT_HEADER + 8 * width
    if resident_bytes <= SMEM_LIMIT:
        return FiltfiltPlan(True, width, resident_bytes, 1)
    return FiltfiltPlan(False, width, _STREAM_HEADER + 8 * SLOTS * CHUNK,
                        -(-width // CHUNK))


def kernel_buffer(rows: torch.Tensor, p0: int, width: int) -> torch.Tensor:
    """The kernel's row-major buffer ``[R, width]``: row ``r``'s samples at
    ``[p0, p0 + L)``, zeros around them."""
    buf = rows.new_zeros(rows.shape[0], width)
    buf[:, p0:p0 + rows.shape[1]] = rows.detach()
    return buf


def _launch(rows, lengths, coefs, taps, padlens, p0) -> torch.Tensor:
    """The cascade by ``filtfilt_kernel``; returns the filtered ``[R, L]``
    view of the kernel's buffer."""
    plan = plan_filtfilt(rows.shape[1], p0)
    buf = kernel_buffer(rows, p0, plan.width)
    dev = buf.device
    lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    coefs_t = torch.from_numpy(coefs).to(dev)
    taps_t = torch.from_numpy(taps).to(dev)
    pads_t = torch.from_numpy(padlens).to(dev)
    lib = build.load("iir")
    err = lib.filtfilt_cascade(buf.data_ptr(), lengths_t.data_ptr(),
                               coefs_t.data_ptr(), taps_t.data_ptr(),
                               pads_t.data_ptr(), buf.shape[0], plan.width,
                               p0, len(taps), int(not plan.resident),
                               torch.cuda.current_stream().cuda_stream)
    build.check(err, "filtfilt_cascade")
    return buf[:, p0:p0 + rows.shape[1]]


def _check(rows, lengths, stages):
    if rows.dim() != 2 or rows.dtype != torch.float64:
        raise TypeError(f"rows {tuple(rows.shape)} {rows.dtype}: want "
                        f"[R, L] float64")
    lengths = [int(n) for n in (lengths.tolist() if torch.is_tensor(lengths)
                                else lengths)]
    if len(lengths) != rows.shape[0]:
        raise ValueError(f"{len(lengths)} lengths for {rows.shape[0]} rows")
    coefs, taps, padlens = prepare_stages(stages)
    p0 = int(padlens.max()) if len(padlens) else 0
    if stages and any(not p0 < n <= rows.shape[1] for n in lengths):
        raise ValueError(f"row lengths {lengths} must exceed the padding "
                         f"{p0} and fit in {rows.shape[1]} samples")
    return lengths, coefs, taps, padlens, p0


def _run(rows, lengths, coefs, taps, padlens, p0, plain: bool):
    if plain:  # the time-major buffer of the plain version
        buf = rows.new_zeros(rows.shape[1] + 2 * p0, rows.shape[0])
        buf[p0:p0 + rows.shape[1]] = rows.detach().T
        filtfilt_plain(buf, lengths, p0, coefs, taps, padlens)
        out = buf[p0:p0 + rows.shape[1]].T
    else:
        out = _launch(rows, lengths, coefs, taps, padlens, p0)
    valid = (torch.arange(rows.shape[1], device=rows.device)[None, :]
             < torch.tensor(lengths, device=rows.device)[:, None])
    return torch.where(valid, out, rows.detach()).contiguous()


def filtfilt_cascade_plain(rows: torch.Tensor,
                           lengths: Union[Sequence[int], torch.Tensor],
                           stages: Sequence[Design]) -> torch.Tensor:
    """:func:`filtfilt_cascade` by its plain version on any device (what
    the CPU runs, and what the kernel is held to on the card)."""
    lengths, coefs, taps, padlens, p0 = _check(rows, lengths, stages)
    if not stages or rows.shape[0] == 0:
        return rows.clone()
    return _run(rows, lengths, coefs, taps, padlens, p0, plain=True)


def filtfilt_cascade(rows: torch.Tensor,
                     lengths: Union[Sequence[int], torch.Tensor],
                     stages: Sequence[Design]) -> torch.Tensor:
    """``rows [R, L]`` f64 with row ``r`` valid in its first ``lengths[r]``
    samples, through the zero-phase stages ``stages`` (``(b, a)`` pairs) in
    order. Returns a new ``[R, L]`` f64 tensor: each row's valid samples
    filtered, the rest as they were. Like scipy, refuses a row no longer
    than a stage's padding."""
    lengths, coefs, taps, padlens, p0 = _check(rows, lengths, stages)
    if rows.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"filtfilt runs on cuda or cpu, not {rows.device}")
    if rows.device.type == "cuda":
        resolve_device(rows.device)  # raises without a card
    if not stages or rows.shape[0] == 0:
        return rows.clone()
    if rows.device.type == "cpu":
        return _run(rows, lengths, coefs, taps, padlens, p0, plain=True)
    out = _run(rows, lengths, coefs, taps, padlens, p0, plain=False)
    filtfilt_cascade.launches += 1
    return out


filtfilt_cascade.launches = 0
