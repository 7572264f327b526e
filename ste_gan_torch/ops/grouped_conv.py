"""Grouped 1-D convolution: the hand-written Hopper kernels, their plain
PyTorch versions, and the autograd function that joins them.

Replaces ``ste_gan_tpu/ops/pallas_conv.py``: ``_fwd_kernel`` (forward, and
dX through ``_conv_core_bwd``) and ``_dw_kernel`` (dW). The CUDA sources are
``ste_gan_torch/csrc/grouped_conv.cu``, whose header says what bounds the
kernels on the card and how their design meets it.

Layout is PyTorch's: ``x`` is ``[B, Cin, T]``, the weight ``[Cout, Cin/G, K]``
and the output ``[B, Cout, Tout]``; output channels form G consecutive
blocks. Padding is explicit ``(pad_l, pad_r)``; the trailing remainder of a
strided conv is dropped, as in ``F.conv1d``. Operands are f32 or bf16, sums
are taken in f32, results come back in the operand type.

Each wrapper (:func:`conv_fwd`, :func:`conv_dx`, :func:`conv_dw`) runs its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. ``wrapper.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ste_gan_torch.ops import build

_THREADS = 256
_SMEM_LIMIT = 227 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def out_length(t_in: int, k: int, stride: int, pad_l: int, pad_r: int) -> int:
    return (t_in + pad_l + pad_r - k) // stride + 1


def _check(x: torch.Tensor, w: torch.Tensor, groups: int) -> None:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped conv takes f32 or bf16 operands of one "
                        f"type, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected x [B, Cin, T] and w [Cout, Cin/G, K], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] * groups != x.shape[1] or w.shape[0] % groups:
        raise ValueError(f"channels {x.shape[1]} -> {w.shape[0]} do not fit "
                         f"weight {tuple(w.shape)} with {groups} groups")
    if x.device != w.device:
        raise ValueError("x and w lie on different devices")


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def conv_fwd_plain(x, w, stride: int, pad_l: int, pad_r: int, groups: int):
    """The forward in f32, cast to the operand type."""
    y = F.conv1d(F.pad(x.float(), (pad_l, pad_r)), w.float(), stride=stride,
                 groups=groups)
    return y.to(x.dtype)


def dilate_flip(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    """The data gradient as a forward conv (``pallas_conv.py:282-304``):
    ``dy`` dilated by the stride, weights tap-flipped with in/out channels
    transposed per group. Returns (dy_dil, w_t, pad_l', pad_r')."""
    b, c_out, t_out = dy.shape
    _, cg, k = w.shape
    og = c_out // groups
    if stride > 1:
        dy_dil = dy.new_zeros(b, c_out, (t_out - 1) * stride + 1)
        dy_dil[:, :, ::stride] = dy
    else:
        dy_dil = dy
    w_t = (w.view(groups, og, cg, k).transpose(1, 2).flip(-1)
           .reshape(groups * cg, og, k).contiguous())
    pad_l2 = k - 1 - pad_l
    pad_r2 = t_in + k - 1 - pad_l2 - dy_dil.shape[-1]
    if pad_l2 < 0 or pad_r2 < 0:
        raise ValueError(f"data gradient needs pad_l <= K-1 (pad_l {pad_l}, "
                         f"K {k})")
    return dy_dil, w_t, pad_l2, pad_r2


def conv_dx_plain(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    dy_dil, w_t, pl, pr = dilate_flip(dy, w, stride, pad_l, t_in, groups)
    return conv_fwd_plain(dy_dil, w_t, 1, pl, pr, groups)


def conv_dw_plain(x, dy, k: int, stride: int, pad_l: int, pad_r: int,
                  groups: int):
    """Per-tap contraction of strided input slices against ``dy`` in f32
    (``ops/conv.py:98-123``); returned in the operand type."""
    b, c_in, _ = x.shape
    _, c_out, t_out = dy.shape
    cg, og = c_in // groups, c_out // groups
    xp = F.pad(x.float(), (pad_l, pad_r))
    dyg = dy.float().reshape(b, groups, og, t_out)
    span = (t_out - 1) * stride + 1
    taps = []
    for j in range(k):
        xk = xp[:, :, j:j + span:stride].reshape(b, groups, cg, t_out)
        taps.append(torch.einsum("bgct,bgot->goc", xk, dyg))
    dw = torch.stack(taps, dim=-1).reshape(c_out, cg, k)
    return dw.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_fwd(x, w, stride: int, pad_l: int, t_out: int, groups: int):
    b, c_in, t_in = x.shape
    c_out, cg, k = w.shape
    og = c_out // groups
    bn = 16 if og <= 16 else (32 if og <= 32 else 64)
    bm = (_THREADS // (bn // 4)) * 4
    win_len = (bm - 1) * stride + k
    win_stride = -(-win_len // 4) * 4
    kt = max(1, min(k, 4096 // (cg * bn)))
    smem = 4 * (cg * win_stride + kt * cg * bn)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grouped conv tile needs {smem} bytes of shared "
                         f"memory (Cin/G {cg}, K {k}, stride {stride})")
    x = x.contiguous()
    # [Cout, cg, K] -> [G, K, cg, og]: the kernel stages it contiguously.
    w = w.view(groups, og, cg, k).permute(0, 3, 2, 1).contiguous()
    y = torch.empty(b, c_out, t_out, device=x.device, dtype=x.dtype)
    lib = build.load("grouped_conv")
    err = lib.grouped_conv1d_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], bn, b,
        t_in, c_in, k, c_out, stride, pad_l, groups, t_out, kt, win_len,
        win_stride, smem, _stream())
    build.check(err, "grouped_conv1d_fwd")
    return y


def _launch_dw(x, dy, k: int, stride: int, pad_l: int, groups: int):
    b, c_in, t_in = x.shape
    _, c_out, t_out = dy.shape
    cg, og = c_in // groups, c_out // groups
    nx = 1
    while nx * 4 < og and nx < _THREADS:
        nx *= 2
    ny = _THREADS // nx
    if og > 4 * nx or cg > 4 * ny:
        raise ValueError(f"grouped conv dW tile does not fit Cin/G {cg}, "
                         f"Cout/G {og}")
    kt = max(1, min(k, (4 * ny) // cg))
    n_ktiles = -(-k // kt)
    rows = b * t_out
    n_chunks = max(1, min(-(-rows // 32),
                          -(-4 * 132 * 2 // (n_ktiles * groups))))
    rows_per_chunk = -(-rows // n_chunks)
    n_chunks = -(-rows // rows_per_chunk)
    smem = 4 * 32 * (kt * cg + 1 + og + 1)
    x = x.contiguous()
    dy = dy.contiguous()
    part = torch.empty(n_chunks, c_out, cg, k, device=x.device,
                       dtype=torch.float32)
    dw = torch.empty(c_out, cg, k, device=x.device, dtype=x.dtype)
    lib = build.load("grouped_conv")
    err = lib.grouped_conv1d_dw(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        _DTYPES[x.dtype], b, t_in, c_in, k, c_out, stride, pad_l, groups,
        t_out, kt, nx, n_chunks, rows_per_chunk, smem, _stream())
    build.check(err, "grouped_conv1d_dw")
    return dw


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------


def conv_fwd(x, w, stride: int, pad_l: int, pad_r: int, groups: int):
    """Grouped conv forward, ``[B, Cin, T] -> [B, Cout, Tout]``."""
    _check(x, w, groups)
    if x.device.type == "cpu":
        return conv_fwd_plain(x, w, stride, pad_l, pad_r, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped conv runs on cuda or cpu, not {x.device}")
    t_out = out_length(x.shape[-1], w.shape[-1], stride, pad_l, pad_r)
    y = _launch_fwd(x, w, stride, pad_l, t_out, groups)
    conv_fwd.launches += 1
    return y


def conv_dx(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    """Data gradient: the forward kernel on stride-dilated ``dy`` with
    flipped, transposed weights; returns ``[B, Cin, t_in]``."""
    if dy.dtype != w.dtype or dy.device != w.device:
        raise TypeError("dy and w must share dtype and device")
    if dy.device.type == "cpu":
        return conv_dx_plain(dy, w, stride, pad_l, t_in, groups)
    if dy.device.type != "cuda":
        raise RuntimeError(f"grouped conv runs on cuda or cpu, not {dy.device}")
    dy_dil, w_t, pl, _ = dilate_flip(dy, w, stride, pad_l, t_in, groups)
    dx = _launch_fwd(dy_dil, w_t, 1, pl, t_in, groups)
    conv_dx.launches += 1
    return dx


def conv_dw(x, dy, k: int, stride: int, pad_l: int, pad_r: int, groups: int):
    """Weight gradient ``[Cout, Cin/G, K]`` in the operand type, summed in
    f32 over batch and time in a fixed order."""
    if x.dtype != dy.dtype or x.device != dy.device:
        raise TypeError("x and dy must share dtype and device")
    if x.device.type == "cpu":
        return conv_dw_plain(x, dy, k, stride, pad_l, pad_r, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped conv runs on cuda or cpu, not {x.device}")
    dw = _launch_dw(x, dy, k, stride, pad_l, groups)
    conv_dw.launches += 1
    return dw


conv_fwd.launches = 0
conv_dx.launches = 0
conv_dw.launches = 0


class GroupedConv1dFn(torch.autograd.Function):
    """Grouped conv with the kernels above in both directions. dW is skipped
    when the weight needs no gradient (the discriminator in the generator
    phase); dX when the input needs none."""

    @staticmethod
    def forward(ctx, x, w, stride: int, pad_l: int, pad_r: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, pad_l, pad_r, groups)
        return conv_fwd(x, w, stride, pad_l, pad_r, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, pad_l, pad_r, groups = ctx.geom
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_dx(dy, w, stride, pad_l, x.shape[-1], groups)
        if ctx.needs_input_grad[1]:
            dw = conv_dw(x, dy, w.shape[-1], stride, pad_l, pad_r, groups)
        return dx, dw, None, None, None, None


def grouped_conv1d(x, w, stride: int = 1, padding: Tuple[int, int] = (0, 0),
                   groups: int = 1):
    """Differentiable grouped conv1d over ``[B, Cin, T]`` with weight
    ``[Cout, Cin/G, K]``."""
    return GroupedConv1dFn.apply(x, w, stride, int(padding[0]),
                                 int(padding[1]), groups)
