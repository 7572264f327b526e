"""Grouped 1-D convolution: the hand-written Hopper kernels, their plain
PyTorch versions, and the autograd function that joins them.

Replaces ``ste_gan_tpu/ops/pallas_conv.py``: ``_fwd_kernel`` (forward, and
dX through ``_conv_core_bwd``) and ``_dw_kernel`` (dW). The CUDA sources are
``ste_gan_torch/csrc/grouped_conv.cu``, whose comments say what bounds each
kernel on the card and how its design meets it.

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
  ``conv_dw_partial_kernel`` + ``conv_dw_reduce_kernel`` (implicit-GEMM dW,
  ``mma.sync``). Their launch plans are :func:`_plan_conv` and
  :func:`_plan_dw`, pure Python; :func:`_layout_weights` and
  :func:`emulate_conv` repeat the wgmma kernels' layouts and schedule on
  the CPU, for the tests.
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
from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

from ste_gan_torch.ops import build

_THREADS = 256
_WARPS = _THREADS // 32
_SMEM_LIMIT = 227 * 1024
_DTYPES = (torch.float32, torch.bfloat16)
#: The wgmma forward and dX: widest N, and the mbarriers' bytes at the start
#: of shared memory.
_CONV_MAX_N = 64
_BAR_BYTES = 256
#: dW: rows (time steps of one batch row) per staged tile, as ``kBT``.
_DW_ROWS = 128
#: dW: most blocks to launch, two full waves of an H100's 132 SMs at the
#: kernel's two blocks per SM (so that no third wave runs nearly empty),
#: and fewest row tiles a chunk sums before it writes its partial slab.
_DW_MAX_BLOCKS = 2 * 2 * 132
_DW_MIN_TILES = 4


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
_DW_FIELDS = ("B", "Cin", "Cout", "Tin", "Tout", "K", "stride", "pad_l", "G",
              "cg", "og", "n_otiles", "n_ctiles", "kt", "tiles_per_b",
              "n_rtiles", "tiles_per_chunk", "V")


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


def _stage_window(src, plan: ConvPlan, b: int, g: int, tt: int):
    """The window slot of one tile, as the window warps stage it: source
    time ``tt*bm*S + t_off + pv`` of the group's channels, channel-last, at
    ``[plane = pv mod S][c/8][row = pv div S][c mod 8]``; zeros outside the
    source and past its channels. Returned as 16-byte units ``[n, 8]``."""
    p = plan
    pv = torch.arange(p.S * p.V)
    c = torch.arange(p.C8 * 8)
    t = tt * p.bm * p.S + p.t_off + pv
    ok = (c < p.CR)[:, None] & ((t >= 0) & (t < p.T_src))[None, :]
    vals = src[b, (g * p.CR + c).clamp(max=p.C_src - 1)][
        :, t.clamp(0, p.T_src - 1)] * ok
    win = src.new_zeros(p.S, p.C8, p.V, 8)
    win[pv % p.S, :, pv // p.S, :] = vals.t().reshape(-1, p.C8, 8)
    return win.reshape(-1, 8)


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
    n_otiles: int        # output-channel tiles of ob per group
    n_ctiles: int        # input-channel tiles of cb per group
    kt: int              # taps per block
    tiles_per_b: int     # row tiles of _DW_ROWS per batch row
    n_rtiles: int
    tiles_per_chunk: int
    V: int               # x window rows per phase
    ob: int              # output channels per block (16, 32 or 64)
    cb: int              # input channels per block (16 or 32)
    n_ttiles: int        # tap tiles
    n_chunks: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.n_ttiles, self.G * self.n_otiles * self.n_ctiles,
                self.n_chunks)

    @functools.cached_property
    def args(self) -> ctypes.Array:
        return _struct(self, _DW_FIELDS)

    def row_tiles(self, chunk: int) -> range:
        start = chunk * self.tiles_per_chunk
        return range(start, min(self.n_rtiles, start + self.tiles_per_chunk))

    def rows(self, tile: int) -> Iterator[Tuple[int, int]]:
        """(batch row, time step) of every real row of a row tile."""
        bb, i = divmod(tile, self.tiles_per_b)
        for u in range(i * _DW_ROWS, min(self.Tout, (i + 1) * _DW_ROWS)):
            yield bb, u

    def block(self, bx: int, by: int) -> Tuple[int, range, range, range]:
        """(group, output channels, input channels, taps) of a block, as
        the kernel decodes blockIdx.x / .y."""
        ct = by % self.n_ctiles
        ot = (by // self.n_ctiles) % self.n_otiles
        g = by // (self.n_ctiles * self.n_otiles)
        k0 = bx * self.kt
        return (g, range(ot * self.ob, min(self.og, (ot + 1) * self.ob)),
                range(ct * self.cb, min(self.cg, (ct + 1) * self.cb)),
                range(k0, min(self.K, k0 + self.kt)))


@functools.lru_cache(maxsize=256)
def _plan_dw(b: int, c_in: int, c_out: int, k: int, stride: int, pad_l: int,
             t_in: int, t_out: int, groups: int) -> DwPlan:
    """Tiles, row chunks, grid and shared memory of
    ``conv_dw_partial_kernel``."""
    cg, og = c_in // groups, c_out // groups
    ob = 16 if og <= 16 else (32 if og <= 32 else 64)
    cb = 16 if cg <= 16 else 32
    kt = _WARPS * 32 // cb  # each warp owns 32 columns (tap, channel)
    n_otiles, n_ctiles, n_ttiles = _cdiv(og, ob), _cdiv(cg, cb), _cdiv(k, kt)
    tiles_per_b = _cdiv(t_out, _DW_ROWS)
    n_rtiles = b * tiles_per_b
    per_chunk = n_ttiles * groups * n_otiles * n_ctiles
    n_chunks = max(1, min(_DW_MAX_BLOCKS // per_chunk,
                          n_rtiles // _DW_MIN_TILES))
    tiles_per_chunk = _cdiv(n_rtiles, n_chunks)
    n_chunks = _cdiv(n_rtiles, tiles_per_chunk)
    v = _DW_ROWS + (kt - 1) // stride
    smem = 2 * (ob * (_DW_ROWS + 8) + stride * v * (cb + 8))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grouped conv dW tile needs {smem} bytes of shared "
                         f"memory (stride {stride})")
    return DwPlan(b, c_in, c_out, t_in, t_out, k, stride, pad_l, groups, cg,
                  og, n_otiles, n_ctiles, kt, tiles_per_b, n_rtiles,
                  tiles_per_chunk, v, ob, cb, n_ttiles, n_chunks, smem)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_conv_bf16(dx: bool, src, w, stride: int, pad_l: int, t_in: int,
                      t_out: int, groups: int):
    """The forward (``src`` = x) or dX (``src`` = dy): the layout kernel
    into a scratch slab tensor, then the wgmma kernel."""
    c_out, cg, k = w.shape
    dev = src.device
    plan = _plan_conv(dx, src.shape[0], cg * groups, c_out, k, stride, pad_l,
                      t_in, t_out, groups,
                      _sm_count(dev.index if dev.index is not None
                                else torch.cuda.current_device()))
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


def _launch_dw_bf16(x, dy, k: int, stride: int, pad_l: int, groups: int):
    b, c_in, t_in = x.shape
    _, c_out, t_out = dy.shape
    plan = _plan_dw(b, c_in, c_out, k, stride, pad_l, t_in, t_out, groups)
    x = x.contiguous()
    dy = dy.contiguous()
    part = torch.empty(plan.n_chunks, c_out, k, plan.cg, device=x.device,
                       dtype=torch.float32)
    dw = torch.empty(c_out, plan.cg, k, device=x.device, dtype=x.dtype)
    lib = build.load("grouped_conv")
    gx, gy, _ = plan.grid
    err = lib.grouped_conv1d_dw_bf16(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        plan.args, plan.ob, plan.cb, gx, gy, plan.n_chunks, plan.smem,
        _stream())
    build.check(err, "grouped_conv1d_dw_bf16")
    return dw


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
                          -(-4 * 132 * 2 // (n_ktiles * groups))))
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
