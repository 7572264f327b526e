"""Grouped 1-D convolution: the hand-written Hopper kernels, their plain
PyTorch versions, and the autograd function that joins them.

Replaces ``ste_gan_tpu/ops/pallas_conv.py``: ``_fwd_kernel`` (forward, and
dX through ``_conv_core_bwd``) and ``_dw_kernel`` (dW). The CUDA sources are
``ste_gan_torch/csrc/grouped_conv.cu`` and ``grouped_conv_dw.cu`` (the bf16
dW), whose comments say what bounds each kernel on the card and how its
design meets it.

Layout is PyTorch's: ``x`` is ``[B, Cin, T]``, the weight ``[Cout, Cin/G, K]``
and the output ``[B, Cout, Tout]``; output channels form G consecutive
blocks. Padding is explicit ``(pad_l, pad_r)``; the trailing remainder of a
strided conv is dropped, as in ``F.conv1d``, and gets a zero gradient.
Operands are f32 or bf16, sums are taken in f32, results come back in the
operand type.

The data gradient is a polyphase transposed conv: input position
``t = s*q + r`` (phase ``r``) receives only the taps ``j0_r + s*m`` at
``dy[q + d_r - m]`` (:func:`phases`), so no stride-dilated ``dy`` is built.
Routes by operand type:

* bf16 (the main path), on the tensor cores: ``conv_fwd_wgmma_kernel`` (the
  forward; it replaces ``pallas_conv.py:147`` ``_fwd_kernel``) and
  ``conv_dx_wgmma_kernel`` (dX; the phases fused into the columns of one
  stride-1 GEMM over a shared ``dy`` window), one wgmma mainloop with
  weights resident per (group, channel tile) in persistent CTAs, each
  after the one-launch ``conv_weight_layout_kernel``; and
  ``conv_dw_wgmma_kernel`` (dW, one launch; it replaces ``pallas_conv.py:158``
  ``_dw_kernel``): wgmma with ``dy`` from registers and the same
  channel-last ``x`` window through an MN-major descriptor, rows split over
  a thread-block cluster whose partial sums are added on chip in rank
  order. Their launch plans are :func:`_plan_conv` and :func:`_plan_dw`,
  pure Python; :func:`_layout_weights`, :func:`emulate_conv` and
  :func:`emulate_dw` repeat the kernels' layouts and schedules on the CPU,
  for the tests.
* f32 (exact, no TF32): the CUDA-core kernels of the first port.
  ``conv_fwd_kernel`` is the forward; dX runs it on stride-dilated ``dy``
  with flipped, transposed weights (:func:`dilate_flip`, which only this
  route uses); dW runs ``conv_dw_partial_f32_kernel`` +
  ``conv_dw_reduce_kernel``.

Each wrapper (:func:`conv_fwd`, :func:`conv_dx`, :func:`conv_dw`) runs its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. ``wrapper.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ste_gan_torch.ops import build

_THREADS = 256
_SMEM_LIMIT = 227 * 1024
_DTYPES = (torch.float32, torch.bfloat16)
#: The wgmma forward and dX: widest N, and the mbarriers' bytes at the start
#: of shared memory.
_CONV_MAX_N = 64
_BAR_BYTES = 256
#: dW: units per consumer warpgroup of ``conv_dw_wgmma_kernel``, by wgmma
#: N (its instantiations); a unit's accumulators take N / 2 registers a
#: thread, so each keeps 128-160 of them (the consumers run at 216). The
#: most CTAs of a cluster (the portable limit).
_DW_UNITS = {64: 4, 32: 10, 16: 16}
_DW_MAX_CLUSTER = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def out_length(t_in: int, k: int, stride: int, pad_l: int, pad_r: int) -> int:
    return (t_in + pad_l + pad_r - k) // stride + 1


def phases(k: int, stride: int, pad_l: int) -> List[Tuple[int, int, int]]:
    """Per input phase ``r = t mod stride``: ``(j0, n, d)``, its first tap,
    its tap count and its ``dy`` offset. Phase ``r`` sums taps
    ``j0 + stride*m`` (``m < n``) at ``dy[q + d - m]`` for ``t = stride*q + r``;
    ``n`` is 0 when ``K < stride`` leaves the phase without taps."""
    out = []
    for r in range(stride):
        j0 = (r + pad_l) % stride
        n = _cdiv(k - j0, stride) if j0 < k else 0
        out.append((j0, n, (r + pad_l) // stride))
    return out


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


def conv_dx_plain(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    """The polyphase data gradient in f32, cast to the operand type: per
    phase one stride-1 ``F.conv1d`` of ``dy`` with that phase's taps
    (reversed, in/out channels transposed per group), interleaved."""
    b, c_out, t_out = dy.shape
    _, cg, k = w.shape
    og = c_out // groups
    dyf, wf = dy.float(), w.float()
    dx = dyf.new_zeros(b, groups * cg, t_in)
    for r, (j0, n, d) in enumerate(phases(k, stride, pad_l)):
        q = _cdiv(t_in - r, stride)  # input positions of phase r
        if n == 0 or q <= 0:
            continue
        w_r = (wf[:, :, j0::stride].flip(-1).reshape(groups, og, cg, n)
               .transpose(1, 2).reshape(groups * cg, og, n))
        dy_r = F.pad(dyf, (n - 1 - d, q + d - t_out))  # negative pads crop
        dx[:, :, r::stride] = F.conv1d(dy_r, w_r, groups=groups)
    return dx.to(dy.dtype)


def dilate_flip(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    """The data gradient as a forward conv (``pallas_conv.py:282-304``):
    ``dy`` dilated by the stride, weights tap-flipped with in/out channels
    transposed per group. Returns (dy_dil, w_t, pad_l', pad_r'). Used by the
    f32 route of :func:`conv_dx` only."""
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
# Launch plans of the bf16 tensor-core kernels (pure Python: the CPU tests
# check them). The first fields of each plan are the kernel's parameter
# struct, in its order.
# ---------------------------------------------------------------------------

_CONV_FIELDS = ("B", "C_src", "T_src", "C_dst", "T_dst", "G",
                "CR", "C8", "S", "KE", "t_off", "R", "CO", "CO_total", "n_nt",
                "mt", "n_tt", "V", "tiles_per_slab", "n_tiles",
                "resident", "ck", "n_chunks",
                "slot_bytes", "tap_bytes", "w_off", "win_off", "out_ld",
                "K", "stride", "P0", "dx", "vec", "s_shift")


def _struct(plan, fields) -> ctypes.Array:
    return (ctypes.c_int * len(fields))(*(getattr(plan, f) for f in fields))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One launch of ``conv_fwd_wgmma_kernel`` or ``conv_dx_wgmma_kernel``:
    per (group, channel tile) a GEMM of time rows by ``nt_w`` columns over
    (tap, reduction channel). The forward reads x (``S`` = stride planes,
    ``KE`` = K taps, columns = output channels); dX reads dy at stride 1
    (``KE`` = the dy offsets of all phases, columns = (phase, input
    channel))."""
    B: int
    C_src: int         # channels of the source, x or dy
    T_src: int
    C_dst: int         # channels of the destination, y or dx
    T_dst: int
    G: int
    CR: int            # reduction channels per group (cg, or og for dX)
    C8: int            # their 8-channel groups, padded to a k16 multiple
    S: int             # window planes: the stride, or 1 for dX
    KE: int            # taps: K, or the dy offsets of dX
    t_off: int         # window position 0's source time, less the tile's
    R: int             # phases in the columns (co*R + r): 1, or dX's stride
    CO: int            # destination channels per channel tile
    CO_total: int      # destination channels per group
    n_nt: int          # channel tiles per group
    mt: int            # m64 products per tile (tile rows 64 * mt)
    n_tt: int          # time tiles per batch row
    V: int             # window rows per plane
    tiles_per_slab: int
    n_tiles: int
    resident: int      # 1: a slab stays in shared memory; 0: streamed
    ck: int            # taps per streamed chunk (KE when resident)
    n_chunks: int
    slot_bytes: int    # one window slot (also the output tile)
    tap_bytes: int     # one tap of weights, C8 * nt_w * 16
    w_off: int         # the slab or chunk ring in shared memory
    win_off: int       # the four window slots (two per pipe)
    out_ld: int        # elements per channel row of the output tile
    K: int
    stride: int
    P0: int            # dX: phase r's tap at offset t is P0 + r - stride*t
    dx: int
    vec: int           # 16-byte window loads: T_src % 8 == 0, S a power of 2
    s_shift: int       # log2 S when S is a power of 2
    nt_w: int          # the wgmma N: 16, 32 or 64
    grid: int          # persistent CTAs
    smem: int

    @property
    def bm(self) -> int:
        return 64 * self.mt

    @functools.cached_property
    def args(self) -> ctypes.Array:
        return _struct(self, _CONV_FIELDS)

    @property
    def w_numel(self) -> int:
        """bf16 elements of the laid-out weights, every slab."""
        return self.G * self.n_nt * self.KE * self.C8 * self.nt_w * 8

    def cta_tiles(self, cta: int) -> range:
        """The contiguous tiles of a CTA, as the kernel splits them."""
        return range(cta * self.n_tiles // self.grid,
                     (cta + 1) * self.n_tiles // self.grid)

    def pipe_tiles(self, cta: int, pipe: int) -> range:
        """The tiles consumer warpgroup ``pipe`` of a CTA runs: every other."""
        tiles = self.cta_tiles(cta)
        return range(tiles.start + pipe, tiles.stop, 2)

    def tile(self, i: int) -> Tuple[int, int, int, int]:
        """(group, channel tile, batch row, time tile) of tile ``i``: slabs
        ((group, channel tile)) outermost, as ``conv_tile``."""
        slab, rem = divmod(i, self.tiles_per_slab)
        b, tt = divmod(rem, self.n_tt)
        g, nt = divmod(slab, self.n_nt)
        return g, nt, b, tt

    def tap_rows(self, t: int) -> Tuple[int, int]:
        """(plane, first window row) that tap ``t`` reads: a tap is a row
        shift of the descriptor's start."""
        return t % self.S, t // self.S

    def chunks(self) -> List[range]:
        """Taps of each weight chunk of a tile, in order (one when
        resident)."""
        return [range(c * self.ck, min(self.KE, (c + 1) * self.ck))
                for c in range(self.n_chunks)]

    def outputs(self, i: int) -> Tuple[int, range, range]:
        """(batch row, destination channels, destination times) tile ``i``
        writes."""
        g, nt, b, tt = self.tile(i)
        c0 = g * self.CO_total + nt * self.CO
        n_c = min(self.CO, self.CO_total - nt * self.CO)
        rows = self.R * self.bm
        return b, range(c0, c0 + n_c), range(tt * rows,
                                            min(self.T_dst, (tt + 1) * rows))


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=512)
def _plan_conv(dx: bool, b: int, c_in: int, c_out: int, k: int, stride: int,
               pad_l: int, t_in: int, t_out: int, groups: int,
               n_sm: int = 132) -> ConvPlan:
    """Tiles, weight residency, grid and shared memory of the forward
    (``dx`` False) or dX wgmma kernel on a card of ``n_sm`` SMs."""
    cg, og = c_in // groups, c_out // groups
    if dx:
        live = [(n, d) for _, n, d in phases(k, stride, pad_l) if n > 0]
        e_min = min(d - n + 1 for n, d in live)
        ke = max(d for _, d in live) - e_min + 1
        cr, r, co_total, s_win, t_off, p0 = og, stride, cg, 1, e_min, \
            pad_l - stride * e_min
        rows, src, dst = _cdiv(t_in, stride), (c_out, t_out), (c_in, t_in)
    else:
        ke, cr, r, co_total, s_win, t_off, p0 = k, cg, 1, og, stride, -pad_l, 0
        rows, src, dst = t_out, (c_in, t_in), (c_out, t_out)
    if r > _CONV_MAX_N:
        raise ValueError(f"grouped conv dX takes strides up to {_CONV_MAX_N}")
    c8 = 2 * _cdiv(cr, 16)
    co = min(co_total, _CONV_MAX_N // r)
    nt_w = _pow2_at_least(r * co, 16)
    n_nt = _cdiv(co_total, co)
    tap_bytes = c8 * nt_w * 16
    for mt in ((2, 1) if rows > 64 else (1,)):
        bm = 64 * mt
        v = bm + (ke - 1) // s_win
        out_ld = r * bm + 8
        slot = _round_up(max(2 * s_win * v * 8 * c8, 2 * co * out_ld), 128)
        room = _SMEM_LIMIT - _BAR_BYTES - 4 * slot
        if ke * tap_bytes <= room:
            resident, ck, n_chunks, w_bytes = 1, ke, 1, ke * tap_bytes
            break
        ck = room // (4 * tap_bytes)
        if ck >= 1:
            n_chunks = _cdiv(ke, ck)
            ck = _cdiv(ke, n_chunks)
            resident, w_bytes = 0, 4 * ck * tap_bytes
            break
    else:
        raise ValueError(f"grouped conv {'dX' if dx else 'forward'} window "
                         f"needs {4 * slot} bytes of shared memory (K {k}, "
                         f"stride {stride}, {cr} channels per group)")
    n_tt = _cdiv(rows, bm)
    n_tiles = groups * n_nt * b * n_tt
    win_off = _BAR_BYTES + _round_up(w_bytes, 128)
    pow2 = s_win & (s_win - 1) == 0
    if groups * n_nt * ke * tap_bytes >= 2 ** 31:
        raise ValueError("grouped conv weights too large for the layout")
    return ConvPlan(
        b, *src, *dst, groups, cr, c8, s_win, ke, t_off, r, co, co_total,
        n_nt, mt, n_tt, v, b * n_tt, n_tiles, resident, ck, n_chunks, slot,
        tap_bytes, _BAR_BYTES, win_off, out_ld, k, stride, p0, int(dx),
        int(src[1] % 8 == 0 and pow2), s_win.bit_length() - 1 if pow2 else 0,
        nt_w, min(n_sm, _cdiv(n_tiles, 2)), win_off + 4 * slot)


def _layout_weights(w, plan: ConvPlan):
    """``[Cout, cg, K]`` -> the kernels' slabs ``[G * n_nt, KE, C8, nt_w, 8]``
    (the map of ``conv_weight_layout_kernel``): element (slab, t, c8, n, e)
    is reduction channel ``8*c8 + e`` of column ``n = co*R + r``, tap ``t``
    (forward) or ``P0 + r - stride*t`` (dX, phase ``r``); zero past the
    channels, columns and taps."""
    p = plan
    dev = w.device
    slab, t, c8, n, e = torch.meshgrid(
        *(torch.arange(m, device=dev) for m in
          (p.G * p.n_nt, p.KE, p.C8, p.nt_w, 8)), indexing="ij")
    g, nt = slab // p.n_nt, slab % p.n_nt
    cr, co, r = 8 * c8 + e, n // p.R, n % p.R
    ch = nt * p.CO + co
    if p.dx:
        j = p.P0 + r - p.stride * t
        src = ((g * p.CR + cr) * p.CO_total + ch) * p.K + j
    else:
        j = t
        src = ((g * p.CO_total + ch) * p.CR + cr) * p.K + j
    ok = ((n < p.R * p.CO) & (cr < p.CR) & (ch < p.CO_total) & (j >= 0)
          & (j < p.K))
    flat = w.reshape(-1)
    vals = flat[torch.where(ok, src, torch.zeros_like(src))]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _channel_last_window(src, b: int, c0: int, n_ch: int, t0: int, s: int,
                         c8: int, v: int):
    """Source times ``t0 + pv`` (``pv < s*v``) of channels ``c0 ..
    c0 + n_ch`` of batch row ``b``, channel-last as the window warps stage
    them: ``[plane = pv mod s][c/8][row = pv div s][c mod 8]``, zeros
    outside the source and past the channels. Returned as 16-byte units
    ``[n, 8]``."""
    pv = torch.arange(s * v)
    c = torch.arange(c8 * 8)
    t = t0 + pv
    n_t = src.shape[-1]
    ok = (c < n_ch)[:, None] & ((t >= 0) & (t < n_t))[None, :]
    vals = src[b, (c0 + c).clamp(max=src.shape[1] - 1)][
        :, t.clamp(0, n_t - 1)] * ok
    win = src.new_zeros(s, c8, v, 8)
    win[pv % s, :, pv // s, :] = vals.t().reshape(-1, c8, 8)
    return win.reshape(-1, 8)


def _stage_window(src, plan: ConvPlan, b: int, g: int, tt: int):
    """The window slot of one forward or dX tile: source time
    ``tt*bm*S + t_off + pv`` of the group's channels."""
    p = plan
    return _channel_last_window(src, b, g * p.CR, p.CR,
                                tt * p.bm * p.S + p.t_off, p.S, p.C8, p.V)


def _desc_read(buf, start: int, lbo: int, rows: int):
    """The ``[rows, 16]`` K-major matrix a no-swizzle wgmma descriptor reads
    from ``buf`` (16-byte units ``[n, 8]``): row ``m``, element ``k`` at unit
    ``start + m mod 8 + 8*(m div 8) + lbo*(k div 8)`` (SBO 128 bytes)."""
    m = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    unit = start + m % 8 + 8 * (m // 8) + lbo * (k // 8)
    return buf[unit, (k % 8).expand(rows, 16)]


def emulate_conv(src, w, plan: ConvPlan):
    """The wgmma kernels' schedule in f32 on the CPU: every CTA's tiles,
    pipe by pipe; per tile the staged window, each chunk of the laid-out
    weights as its bulk copy lands, per k16 step, tap and m64 product the
    descriptors' operands (a tap is a start-row shift), and the epilogue's
    (channel, phase) columns. Equals :func:`conv_fwd_plain` (forward) or
    :func:`conv_dx_plain` (dX) up to f32 rounding."""
    p = plan
    wp = _layout_weights(w.float(), p).reshape(-1, 8)
    src = src.float()
    out = src.new_zeros(p.B, p.C_dst, p.T_dst)
    tap_units = p.C8 * p.nt_w
    rows = torch.arange(p.bm)[:, None]
    cols = torch.arange(p.nt_w)[None, :]
    co, r = cols // p.R, cols % p.R
    for cta in range(p.grid):
        for pipe in (0, 1):
            for i in p.pipe_tiles(cta, pipe):
                g, nt, b, tt = p.tile(i)
                win = _stage_window(src, p, b, g, tt)
                acc = src.new_zeros(p.bm, p.nt_w)
                for taps in p.chunks():
                    first = (g * p.n_nt + nt) * p.KE + taps.start
                    chunk = wp[first * tap_units:
                               (first + len(taps)) * tap_units]
                    for ks in range(p.C8 // 2):
                        for t in taps:
                            plane, row = p.tap_rows(t)
                            bmat = _desc_read(
                                chunk, ((t - taps.start) * p.C8 + 2 * ks)
                                * p.nt_w, p.nt_w, p.nt_w)
                            for h in range(p.mt):
                                amat = _desc_read(
                                    win, (plane * p.C8 + 2 * ks) * p.V + row
                                    + 64 * h, p.V, 64)
                                acc[64 * h:64 * h + 64] += amat @ bmat.t()
                ch = nt * p.CO + co
                tim = p.R * (tt * p.bm + rows) + r
                ok = ((cols < p.R * p.CO) & (ch < p.CO_total)
                      & (tim < p.T_dst))
                ok = ok.expand(p.bm, p.nt_w)
                out[b, (g * p.CO_total + ch).expand(p.bm, -1)[ok],
                    tim.expand(-1, p.nt_w)[ok]] = acc[ok]
    return out


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One launch of ``conv_dw_wgmma_kernel``: per group a GEMM of M =
    output channels (a tile of 64) by N = (plane, input channel) columns,
    summed over the B x Tout rows. A *unit* is one wgmma column tile: tap row
    ``m`` and plane group ``pg``, whose column ``r*CO + c`` is channel ``c``
    at tap ``m*s + pg*R + r``. A cluster of ``C`` CTAs owns an output tile
    (group, output-channel tile, channel tile, *part* of ``2 * UW`` units,
    ``UW`` per consumer warpgroup); its ranks split the row tiles, both
    warpgroups of a CTA consume each staged tile, and the partial tiles are
    summed on chip in rank order."""
    B: int
    Cin: int
    Cout: int
    Tin: int
    Tout: int
    K: int
    stride: int
    pad_l: int
    G: int
    cg: int
    og: int
    CO: int            # input channels per channel tile (8 * C8)
    C8: int
    n_ct: int          # channel tiles per group
    n_ot: int          # output-channel tiles of 64 per group
    R: int             # planes (taps of a tap row) per unit
    n_pg: int          # plane groups per tap row
    U: int             # units: ceil(K / s) tap rows x n_pg
    UW: int            # units of each consumer warpgroup (2 * UW a part)
    n_parts: int
    BT: int            # rows (time steps of one batch row) per row tile
    n_tb: int          # row tiles per batch row
    n_rt: int          # row tiles
    C: int             # CTAs per cluster
    n_tiles: int       # clusters (output tiles)
    V: int             # window rows per plane
    JP: int            # taps per (o, c) row of the reduce buffer, odd
    planes: int        # window planes per slot (>= stride)
    dy_pitch: int      # elements per output-channel row of the dy tile
    slot_bytes: int
    win_off: int       # the x window inside a slot, after the dy tile
    n_slots: int       # ring slots
    n_x8: int          # 8-step chunks of x a window loads
    raw_pitch: int     # elements per channel row of a raw x buffer
    raw_off: int       # the two raw x buffers, after the slots
    x_async: int       # x by cp.async: Tin % 8 == 0, stride a power of 2
    dy_async: int      # dy by cp.async: Tout % 8 == 0
    s_shift: int       # log2 stride when it is a power of 2
    b_lbo: int         # the x descriptor's strides in 16-byte units: the
    b_sbo: int         # next 8 rows (LBO), the next 8 columns (SBO)
    nt_w: int          # the wgmma N: 16, 32 or 64
    smem: int

    @property
    def grid(self) -> int:
        """CTAs: ``C`` per cluster."""
        return self.n_tiles * self.C

    @functools.cached_property
    def args(self) -> ctypes.Array:
        return _struct(self, _DW_FIELDS)

    def tile(self, i: int) -> Tuple[int, int, int, int]:
        """(group, output-channel tile, channel tile, part) of cluster
        ``i``, as ``conv_dw_wgmma_kernel`` decodes it."""
        rest, part = divmod(i, self.n_parts)
        rest, ct = divmod(rest, self.n_ct)
        g, ot = divmod(rest, self.n_ot)
        return g, ot, ct, part

    def part_units(self, part: int) -> range:
        """The units of a part: the U units in ``n_parts`` near-equal
        contiguous ranges."""
        return range(part * self.U // self.n_parts,
                     (part + 1) * self.U // self.n_parts)

    def units(self, part: int, wg: int) -> range:
        """The units consumer warpgroup ``wg`` holds in a part (at most
        ``UW``): the first half of the part's, rounded up, or the rest."""
        q = self.part_units(part)
        mid = q.start + (len(q) + 1) // 2
        return range(q.start, mid) if wg == 0 else range(mid, q.stop)

    def first_row(self, part: int) -> int:
        """The first tap row of a part: its window starts at that tap."""
        return self.part_units(part).start // self.n_pg

    def unit_start(self, part: int, q: int) -> int:
        """16-byte unit of a slot's window where unit ``q`` reads its first
        row: plane ``pg*R``, row ``m`` less the part's first tap row."""
        m, pg = divmod(q, self.n_pg)
        return pg * self.R * self.C8 * self.V + m - self.first_row(part)

    def taps(self, part: int) -> range:
        """The taps whose columns lie in the part's units."""
        q0, q1 = self.part_units(part).start, self.part_units(part).stop
        first = (q0 // self.n_pg) * self.stride + (q0 % self.n_pg) * self.R
        last = (q1 // self.n_pg) * self.stride + (q1 % self.n_pg) * self.R
        return range(first, min(self.K, last))

    def rank_rows(self, rank: int) -> range:
        """The contiguous row tiles of cluster rank ``rank``."""
        return range(rank * self.n_rt // self.C,
                     (rank + 1) * self.n_rt // self.C)

    def rows(self, rt: int) -> Tuple[int, range]:
        """(batch row, time steps) of row tile ``rt``."""
        b, tb = divmod(rt, self.n_tb)
        return b, range(tb * self.BT, min(self.Tout, (tb + 1) * self.BT))

    def extent(self, i: int) -> Tuple[int, int]:
        """(output channels, input channels) of cluster ``i``'s tile."""
        _, ot, ct, _ = self.tile(i)
        return (min(64, self.og - 64 * ot), min(self.CO, self.cg - self.CO * ct))

    def reduce_slice(self, i: int, rank: int) -> range:
        """The (o, c) rows (``o * n_c + c``) of cluster ``i``'s tile that
        rank ``rank`` sums over the ranks and stores."""
        n_o, n_c = self.extent(i)
        pairs = n_o * n_c
        return range(rank * pairs // self.C, (rank + 1) * pairs // self.C)


#: ``DwParams`` of the kernel: every field of the plan, in order.
_DW_FIELDS = tuple(f.name for f in dataclasses.fields(DwPlan))


def _dw_layout(k: int, stride: int, cg: int):
    """The unit geometry of dW: (CO, C8, n_ct, R, n_pg, U, nt_w)."""
    c8 = 8 if cg > 64 else _pow2_at_least(_cdiv(cg, 8), 1)
    co = 8 * c8
    r = 1
    while 2 * r <= stride and 2 * r * co <= _CONV_MAX_N:
        r *= 2
    n_pg = _cdiv(stride, r)
    return co, c8, _cdiv(cg, co), r, n_pg, _cdiv(k, stride) * n_pg, \
        _pow2_at_least(r * co, 16)


@functools.lru_cache(maxsize=256)
def _plan_dw(b: int, c_in: int, c_out: int, k: int, stride: int, pad_l: int,
             t_in: int, t_out: int, groups: int,
             clusters: Tuple[int, ...]) -> DwPlan:
    """Units, parts, cluster size, row tiles and shared memory of
    ``conv_dw_wgmma_kernel`` on a card that holds ``clusters[C - 1]``
    clusters of C CTAs at once (:func:`_cluster_table`). The U units are
    split into parts as evenly as the units a warpgroup holds allow; of the
    cluster sizes it takes the one whose busiest CTA has the fewest row
    tiles, counted in waves of clusters."""
    cg, og = c_in // groups, c_out // groups
    co, c8, n_ct, r, n_pg, units, nt_w = _dw_layout(k, stride, cg)
    n_ot = _cdiv(og, 64)
    planes = max(stride, ((n_pg - 1) * r * c8 + nt_w // 8 + c8 - 1) // c8)
    for bt in ((128, 64) if t_out > 64 else (64,)):
        n_tb = _cdiv(t_out, bt)
        n_rt = b * n_tb
        uw = _DW_UNITS[nt_w]
        parts = _cdiv(units, 2 * uw)
        n_tiles = groups * n_ot * n_ct * parts
        c = min(range(1, min(_DW_MAX_CLUSTER, max(1, n_rt // 2)) + 1),
                key=lambda c: (_cdiv(n_tiles, clusters[c - 1])
                               * _cdiv(n_rt, c), c))
        span = max((((p + 1) * units // parts) - 1) // n_pg
                   - p * units // parts // n_pg for p in range(parts)) + 1
        v = bt + span - 1
        jp = span * stride | 1
        dy_pitch = bt + 8
        dy_bytes = 64 * dy_pitch * 2
        slot = _round_up(dy_bytes + planes * c8 * v * 16, 128)
        n_x8 = (stride * v + 7) // 8 + 1
        raw_pitch = _round_up(8 * n_x8 - 8, 64) + 8  # 16 bytes mod 128
        raw = 2 * co * raw_pitch * 2
        red = 64 * co * jp * 4
        for n_slots in (4, 3, 2):
            smem = _BAR_BYTES + max(n_slots * slot + raw, red)
            if smem <= _SMEM_LIMIT:
                break
        if smem <= _SMEM_LIMIT:
            break
    else:
        raise ValueError(f"grouped conv dW tile needs {smem} bytes of shared "
                         f"memory (K {k}, stride {stride}, {cg} channels "
                         f"per group)")
    pow2 = stride & (stride - 1) == 0
    return DwPlan(
        b, c_in, c_out, t_in, t_out, k, stride, pad_l, groups, cg, og, co, c8,
        n_ct, n_ot, r, n_pg, units, uw, parts, bt, n_tb, n_rt, c, n_tiles, v,
        jp, planes, dy_pitch, slot, dy_bytes, n_slots, n_x8, raw_pitch,
        n_slots * slot, int(t_in % 8 == 0 and pow2), int(t_out % 8 == 0),
        stride.bit_length() - 1 if pow2 else 0, 8, v, nt_w, smem)


def _desc_read_mn(buf, start, lbo: int, sbo: int, cols: int):
    """The ``[cols, 16]`` (N x K) matrix an MN-major no-swizzle wgmma
    descriptor reads from ``buf`` (16-byte units ``[n, 8]``): column ``n``,
    row ``k`` at unit ``start + k mod 8 + lbo*(k div 8) + sbo*(n div 8)``,
    element ``n mod 8`` of it (8 columns of one row are one unit). ``start``
    may be a tensor of starts: one matrix each, ``[..., cols, 16]``."""
    start = torch.as_tensor(start)[..., None, None]
    n = torch.arange(cols)[:, None]
    k = torch.arange(16)[None, :]
    unit = start + k % 8 + lbo * (k // 8) + sbo * (n // 8)
    return buf[unit, (n % 8).expand(unit.shape)]


def _stage_dw(x, dy, plan: DwPlan, i: int, rt: int):
    """The slot of cluster ``i``'s row tile ``rt``, as the window warps and
    the bulk copies stage it: the x window (time ``u0*s + m_first*s - pad_l
    + pv`` of the tile's channels, channel-last at ``[plane = pv mod s][c/8]
    [row = pv div s][c mod 8]``, zeros outside x and past the channels) as
    16-byte units, and the dy tile ``[64][BT]`` (zeros past the output
    channels and Tout)."""
    p = plan
    g, ot, ct, part = p.tile(i)
    b, times = p.rows(rt)
    u0 = times.start
    win = _channel_last_window(
        x, b, g * p.cg + p.CO * ct, min(p.CO, p.cg - p.CO * ct),
        (u0 + p.first_row(part)) * p.stride - p.pad_l, p.stride, p.C8, p.V)
    win = torch.cat([win, win.new_zeros((p.planes - p.stride) * p.C8 * p.V,
                                        8)])
    n_o = min(64, p.og - 64 * ot)
    dyt = dy.new_zeros(64, p.BT)
    o0 = g * p.og + 64 * ot
    dyt[:n_o, :len(times)] = dy[b, o0:o0 + n_o, u0:times.stop]
    return win, dyt


def emulate_dw(x, dy, plan: DwPlan):
    """``conv_dw_wgmma_kernel``'s schedule in f32 on the CPU: per cluster and
    rank its row tiles, each staged as the kernel stages it; per k16 step
    the dy rows of the register A operand and, per unit of each consumer
    warpgroup, the x columns its MN-major descriptor reads; then each
    warpgroup's sums into the reduce buffer ``[o][c][jj]`` and each rank's
    slice summed over the ranks in order. Equals :func:`conv_dw_plain` up to
    f32 rounding."""
    p = plan
    x, dy = x.float(), dy.float()
    dw = x.new_zeros(p.Cout, p.cg, p.K)
    cols = torch.arange(p.nt_w)
    r_col, c_col = cols // p.CO, cols % p.CO
    for i in range(p.n_tiles):
        g, ot, ct, part = p.tile(i)
        units = list(p.units(part, 0)) + list(p.units(part, 1))
        jbase = p.first_row(part) * p.stride
        taps = p.taps(part)
        n_o, n_c = p.extent(i)
        starts = torch.tensor([[p.unit_start(part, q) + 16 * ks
                                for ks in range(p.BT // 16)] for q in units])
        reds = []
        for rank in range(p.C):
            acc = x.new_zeros(len(units), 64, p.nt_w)
            for rt in p.rank_rows(rank):
                win, dyt = _stage_dw(x, dy, p, i, rt)
                # Per unit and k16 step the x columns of the unit's
                # descriptor, and per k16 step the dy rows of A.
                bmat = _desc_read_mn(win, starts, p.b_lbo, p.b_sbo, p.nt_w)
                acc += torch.einsum("oks,ukns->uon", dyt.view(64, -1, 16), bmat)
            red = x.new_zeros(64, p.CO, p.JP)
            for u, q in enumerate(units):
                m, pg = divmod(q, p.n_pg)
                j = m * p.stride + pg * p.R + r_col
                ok = (pg * p.R + r_col < p.stride) & (j < p.K) & (c_col < n_c)
                red[:n_o, c_col[ok], (j - jbase)[ok]] = acc[u][:n_o][:, ok]
            reds.append(red)
        o0, c0 = g * p.og + 64 * ot, p.CO * ct
        jj = torch.arange(taps.start, taps.stop) - jbase
        for rank in range(p.C):
            pair = torch.arange(p.reduce_slice(i, rank).start,
                                p.reduce_slice(i, rank).stop)
            o, c = pair // n_c, pair % n_c
            total = reds[0][o, c][:, jj]
            for red in reds[1:]:
                total = total + red[o, c][:, jj]
            dw[(o0 + o)[:, None], (c0 + c)[:, None], (jj + jbase)[None]] = total
    return dw


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch_conv_bf16(dx: bool, src, w, stride: int, pad_l: int, t_in: int,
                      t_out: int, groups: int):
    """The forward (``src`` = x) or dX (``src`` = dy): the layout kernel
    into a scratch slab tensor, then the wgmma kernel."""
    c_out, cg, k = w.shape
    dev = src.device
    plan = _plan_conv(dx, src.shape[0], cg * groups, c_out, k, stride, pad_l,
                      t_in, t_out, groups, _sm_count(_device_index(dev)))
    src = src.contiguous()
    w = w.contiguous()
    if plan.vec and src.data_ptr() % 16:
        plan = dataclasses.replace(plan, vec=0)
    wp = torch.empty(plan.w_numel, device=dev, dtype=torch.bfloat16)
    out = torch.empty(src.shape[0], plan.C_dst, plan.T_dst, device=dev,
                      dtype=torch.bfloat16)
    lib = build.load("grouped_conv")
    name = "grouped_conv1d_dx_bf16" if dx else "grouped_conv1d_fwd_bf16"
    err = getattr(lib, name)(
        src.data_ptr(), w.data_ptr(), wp.data_ptr(), out.data_ptr(),
        plan.args, plan.nt_w, plan.grid, plan.smem, _stream())
    build.check(err, name)
    return out

def _launch_fwd_f32(x, w, stride: int, pad_l: int, t_out: int, groups: int):
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
    err = lib.grouped_conv1d_fwd_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), bn, b, t_in, c_in, k, c_out,
        stride, pad_l, groups, t_out, kt, win_len, win_stride, smem,
        _stream())
    build.check(err, "grouped_conv1d_fwd_f32")
    return y


def _plan_dw_for(x, dy, k: int, stride: int, pad_l: int, groups: int):
    """The dW plan for these CUDA operands on their card; 16-byte copies
    only from 16-byte aligned bases."""
    b, c_in, t_in = x.shape
    _, c_out, t_out = dy.shape
    index = _device_index(x.device)
    plan = _plan_dw(b, c_in, c_out, k, stride, pad_l, t_in, t_out, groups,
                    _cluster_table(index))
    if plan.x_async and x.data_ptr() % 16:
        plan = dataclasses.replace(plan, x_async=0)
    if plan.dy_async and dy.data_ptr() % 16:
        plan = dataclasses.replace(plan, dy_async=0)
    return plan


def _launch_dw_bf16(x, dy, k: int, stride: int, pad_l: int, groups: int):
    """``conv_dw_wgmma_kernel``: one launch, the sums reduced on chip."""
    x = x.contiguous()
    dy = dy.contiguous()
    plan = _plan_dw_for(x, dy, k, stride, pad_l, groups)
    dw = torch.empty(plan.Cout, plan.cg, k, device=x.device, dtype=x.dtype)
    lib = build.load("grouped_conv_dw")
    err = lib.grouped_conv1d_dw_bf16(x.data_ptr(), dy.data_ptr(),
                                     dw.data_ptr(), plan.args, _stream())
    build.check(err, "grouped_conv1d_dw_bf16")
    return dw


@functools.lru_cache(maxsize=None)
def _cluster_table(index: int) -> Tuple[int, ...]:
    """How many clusters of 1 .. 8 CTAs of the dW kernel card ``index``
    holds at once (``cudaOccupancyMaxActiveClusters``): a cluster's CTAs
    share a GPC, so large clusters leave SMs idle."""
    lib = build.load("grouped_conv_dw")
    table = []
    with torch.cuda.device(index):
        for c in range(1, _DW_MAX_CLUSTER + 1):
            out = ctypes.c_int(0)
            build.check(lib.grouped_conv1d_dw_max_clusters(c, ctypes.byref(out)),
                        "grouped_conv1d_dw_max_clusters")
            table.append(out.value)
    return tuple(table)


def _launch_dw_f32(x, dy, k: int, stride: int, pad_l: int, groups: int):
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
                          -(-4 * _sm_count(_device_index(x.device)) * 2
                            // (n_ktiles * groups))))
    rows_per_chunk = -(-rows // n_chunks)
    n_chunks = -(-rows // rows_per_chunk)
    smem = 4 * 32 * (kt * cg + 1 + og + 1)
    x = x.contiguous()
    dy = dy.contiguous()
    part = torch.empty(n_chunks, c_out, k, cg, device=x.device,
                       dtype=torch.float32)
    dw = torch.empty(c_out, cg, k, device=x.device, dtype=x.dtype)
    lib = build.load("grouped_conv")
    err = lib.grouped_conv1d_dw_f32(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), b, t_in,
        c_in, k, c_out, stride, pad_l, groups, t_out, kt, nx, n_chunks,
        rows_per_chunk, smem, _stream())
    build.check(err, "grouped_conv1d_dw_f32")
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
    t_in = x.shape[-1]
    t_out = out_length(t_in, w.shape[-1], stride, pad_l, pad_r)
    if x.dtype == torch.bfloat16:
        y = _launch_conv_bf16(False, x, w, stride, pad_l, t_in, t_out, groups)
    else:
        y = _launch_fwd_f32(x, w, stride, pad_l, t_out, groups)
    conv_fwd.launches += 1
    return y


def conv_dx(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    """Data gradient ``[B, Cin, t_in]`` of ``dy`` ``[B, Cout, Tout]``: the
    phase-fused ``conv_dx_wgmma_kernel`` in bf16, the forward kernel on
    stride-dilated ``dy`` in f32."""
    if dy.dtype != w.dtype or dy.device != w.device:
        raise TypeError("dy and w must share dtype and device")
    if dy.dim() != 3 or w.dim() != 3 or dy.shape[1] != w.shape[0] \
            or w.shape[0] % groups:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit weight "
                         f"{tuple(w.shape)} with {groups} groups")
    if dy.device.type == "cpu":
        return conv_dx_plain(dy, w, stride, pad_l, t_in, groups)
    if dy.device.type != "cuda":
        raise RuntimeError(f"grouped conv runs on cuda or cpu, not {dy.device}")
    if dy.dtype == torch.bfloat16:
        dx = _launch_conv_bf16(True, dy, w, stride, pad_l, t_in,
                               dy.shape[-1], groups)
    else:
        dy_dil, w_t, pl, _ = dilate_flip(dy, w, stride, pad_l, t_in, groups)
        dx = _launch_fwd_f32(dy_dil, w_t, 1, pl, t_in, groups)
    conv_dx.launches += 1
    return dx


def conv_dw(x, dy, k: int, stride: int, pad_l: int, pad_r: int, groups: int):
    """Weight gradient ``[Cout, Cin/G, K]`` in the operand type, summed in
    f32 over batch and time in a fixed order."""
    if x.dtype != dy.dtype or x.device != dy.device:
        raise TypeError("x and dy must share dtype and device")
    if x.dim() != 3 or dy.dim() != 3 or x.shape[0] != dy.shape[0] \
            or x.shape[1] % groups or dy.shape[1] % groups:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} do "
                         f"not fit {groups} groups")
    if x.device.type == "cpu":
        return conv_dw_plain(x, dy, k, stride, pad_l, pad_r, groups)
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped conv runs on cuda or cpu, not {x.device}")
    launch = _launch_dw_bf16 if x.dtype == torch.bfloat16 else _launch_dw_f32
    dw = launch(x, dy, k, stride, pad_l, groups)
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
