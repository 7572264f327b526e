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
``dy[q + d_r - m]`` (:func:`phases`), so no stride-dilated ``dy`` is built
and no zero is multiplied. Routes by operand type:

* bf16 (the main path), all on the tensor cores: ``conv_fwd_bf16_kernel``
  (the forward as an implicit GEMM per group, over a phase-split input
  window; it replaces ``pallas_conv.py:147`` ``_fwd_kernel``),
  ``conv_dx_kernel`` (polyphase dX) and ``conv_dw_partial_kernel`` +
  ``conv_dw_reduce_kernel`` (implicit-GEMM dW). Their launch plans are
  :func:`_plan_fwd`, :func:`_plan_dx` and :func:`_plan_dw`, pure Python.
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
#: Shared memory a forward or dX block aims at, so that two blocks share an
#: SM.
_SMEM_TARGET = 100 * 1024
#: dW: rows (time steps of one batch row) per staged tile, as ``kBT``.
_DW_ROWS = 128
#: dW: most blocks to launch, two full waves of an H100's 132 SMs at the
#: kernel's two blocks per SM (so that no third wave runs nearly empty),
#: and fewest row tiles a chunk sums before it writes its partial slab.
_DW_MAX_BLOCKS = 2 * 2 * 132
_DW_MIN_TILES = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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

_FWD_FIELDS = ("B", "Cin", "Cout", "Tin", "Tout", "K", "stride", "pad_l", "G",
               "cg", "og", "n_otiles", "cg_pad", "n_cchunks",
               "bm", "V", "mt", "n_mchunks", "so_stride")
_DX_FIELDS = ("B", "Cin", "Cout", "Tin", "Tout", "K", "stride", "pad_l", "G",
              "cg", "og", "n_ctiles", "og_pad", "n_ochunks",
              "bq", "upp", "rounds", "nmax", "dmin", "win_rows",
              "mt", "n_mchunks", "out_off", "so_stride")
_DW_FIELDS = ("B", "Cin", "Cout", "Tin", "Tout", "K", "stride", "pad_l", "G",
              "cg", "og", "n_otiles", "n_ctiles", "kt", "tiles_per_b",
              "n_rtiles", "tiles_per_chunk", "V")


def _struct(plan, fields) -> ctypes.Array:
    return (ctypes.c_int * len(fields))(*(getattr(plan, f) for f in fields))


#: Forward: time rows per block by output channels per block, as
#: ``FwdTile<OB>::BM`` (the 8 warps tile BM x OB with warp tiles of 32x32,
#: 64x16 at OB 16).
_FWD_BM = {16: 512, 32: 256, 64: 128}


@dataclasses.dataclass(frozen=True)
class FwdPlan:
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
    n_otiles: int    # output-channel tiles of ob per group
    cg_pad: int      # cg rounded up to whole c-chunks
    n_cchunks: int   # chunks of cc input channels (with the taps, the reduction)
    bm: int          # output time rows per block
    V: int           # x window rows per phase
    mt: int          # taps per weight stage
    n_mchunks: int   # weight stages per c-chunk
    so_stride: int   # floats per channel row of the output tile
    ob: int          # output channels per block (16, 32 or 64)
    cc: int          # input channels per chunk (16 or 32)
    n_ttiles: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.n_ttiles, self.G * self.n_otiles, self.B)

    @functools.cached_property
    def args(self) -> ctypes.Array:
        return _struct(self, _FWD_FIELDS)

    def block(self, bx: int, by: int) -> Tuple[int, range, range]:
        """(group, output channels, output time steps) of a block, as the
        kernel decodes blockIdx.x / .y."""
        g, ot = divmod(by, self.n_otiles)
        return (g, range(ot * self.ob, min(self.og, (ot + 1) * self.ob)),
                range(bx * self.bm, min(self.Tout, (bx + 1) * self.bm)))

    def tap_chunks(self) -> Iterator[Tuple[int, range]]:
        """(c-chunk start, taps) of each weight stage, in order."""
        for ch in range(self.n_cchunks * self.n_mchunks):
            cc_i, mc = divmod(ch, self.n_mchunks)
            j0 = mc * self.mt
            yield cc_i * self.cc, range(j0, min(j0 + self.mt, self.K))

    def tap_rows(self, j: int) -> Tuple[int, int]:
        """(plane, window row) that tap ``j`` reads for a block's first
        output; output ``i`` of the block reads ``i`` rows further."""
        return j % self.stride, j // self.stride


@functools.lru_cache(maxsize=256)
def _plan_fwd(b: int, c_in: int, c_out: int, k: int, stride: int, pad_l: int,
              t_in: int, t_out: int, groups: int) -> FwdPlan:
    """Tiles, grid and shared memory of ``conv_fwd_bf16_kernel``."""
    cg, og = c_in // groups, c_out // groups
    ob = 16 if og <= 16 else (32 if og <= 32 else 64)
    cc = 16 if cg <= 16 else 32
    bm = _FWD_BM[ob]
    n_cchunks = _cdiv(cg, cc)
    v = bm + (k - 1) // stride
    ccp = cc + 8
    win_bytes = 2 * stride * v * ccp
    tap_bytes = 2 * ob * ccp
    mt = max(1, min(k, (_SMEM_TARGET - win_bytes) // (2 * tap_bytes)))
    n_mchunks = _cdiv(k, mt)
    mt = _cdiv(k, n_mchunks)
    so_stride = bm + 4
    smem = max(win_bytes + 2 * mt * tap_bytes, 4 * ob * so_stride)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grouped conv forward tile needs {smem} bytes of "
                         f"shared memory (K {k}, stride {stride})")
    return FwdPlan(b, c_in, c_out, t_in, t_out, k, stride, pad_l, groups, cg,
                   og, _cdiv(og, ob), n_cchunks * cc, n_cchunks, bm, v, mt,
                   n_mchunks, so_stride, ob, cc, _cdiv(t_out, bm), smem)


@dataclasses.dataclass(frozen=True)
class DxPlan:
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
    n_ctiles: int    # input-channel tiles of nb per group
    og_pad: int      # og rounded up to whole o-chunks
    n_ochunks: int   # chunks of oc output channels (the reduction)
    bq: int          # rows q per phase in one block's time tile
    upp: int         # warp units per phase (bq / wm)
    rounds: int      # passes of the 8 warps over the stride * upp units
    nmax: int        # most taps of any phase
    dmin: int        # smallest dy offset d of any phase
    win_rows: int    # dy rows staged per block
    mt: int          # taps of every phase per weight stage
    n_mchunks: int   # weight stages per o-chunk
    out_off: int     # byte offset of the output tile in shared memory
    so_stride: int   # floats per channel row of the output tile
    nb: int          # input channels per block (16 or 32)
    oc: int          # output channels per reduction chunk (16, 32 or 64)
    wm: int          # rows per warp unit
    n_ttiles: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.n_ttiles, self.G * self.n_ctiles, self.B)

    @functools.cached_property
    def args(self) -> ctypes.Array:
        return _struct(self, _DX_FIELDS)

    def units(self) -> Iterator[Tuple[int, int, int]]:
        """(round, phase, first row) of each warp unit, as the kernel
        assigns them: unit = warp + 8*round, phase = unit // upp."""
        for rnd in range(self.rounds):
            for warp in range(_WARPS):
                unit = warp + _WARPS * rnd
                r, qg = divmod(unit, self.upp)
                if r < self.stride:
                    yield rnd, r, qg * self.wm

    def tap_chunks(self) -> Iterator[Tuple[int, range]]:
        """(o-chunk start, taps m) of each weight stage, in order."""
        for ch in range(self.n_ochunks * self.n_mchunks):
            oc_i, mc = divmod(ch, self.n_mchunks)
            m0 = mc * self.mt
            yield oc_i * self.oc, range(m0, min(m0 + self.mt, self.nmax))


@functools.lru_cache(maxsize=256)
def _plan_dx(b: int, c_in: int, c_out: int, k: int, stride: int, pad_l: int,
             t_in: int, t_out: int, groups: int) -> DxPlan:
    """Tiles, grid and shared memory of ``conv_dx_kernel``."""
    cg, og = c_in // groups, c_out // groups
    nb = 16 if cg <= 16 else 32
    oc = 16 if og <= 16 else (32 if og <= 32 else 64)
    wm = 64 if nb == 16 else 32  # warp tile 64x16 or 32x32
    n_ochunks = _cdiv(og, oc)
    upp = max(1, _WARPS // stride)
    bq = wm * upp
    ph = phases(k, stride, pad_l)
    nmax = max(n for _, n, _ in ph)
    dmin, dmax = min(d for *_, d in ph), max(d for *_, d in ph)
    win_rows = bq + dmax - dmin + nmax - 1
    ocp = oc + 8
    win_bytes = 2 * win_rows * ocp
    tap_bytes = 2 * stride * nb * ocp  # one tap of every phase
    mt = max(1, min(nmax, (_SMEM_TARGET - win_bytes) // (2 * tap_bytes)))
    n_mchunks = _cdiv(nmax, mt)
    mt = _cdiv(nmax, n_mchunks)
    in_bytes = win_bytes + 2 * mt * tap_bytes
    rounds = _cdiv(stride * upp, _WARPS)
    so_stride = stride * bq + 4
    out_off = 0 if rounds == 1 else in_bytes
    smem = max(in_bytes, out_off + 4 * nb * so_stride)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grouped conv dX tile needs {smem} bytes of shared "
                         f"memory (K {k}, stride {stride}, Cout/G {og})")
    return DxPlan(b, c_in, c_out, t_in, t_out, k, stride, pad_l, groups, cg,
                  og, _cdiv(cg, nb), n_ochunks * oc, n_ochunks, bq, upp,
                  rounds, nmax, dmin, win_rows, mt, n_mchunks, out_off,
                  so_stride, nb, oc, wm, _cdiv(t_in, stride * bq), smem)


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


def _fwd_weights(w, plan: FwdPlan):
    """``[Cout, cg, K]`` -> ``[G, n_otiles, K, ob, cg_pad]``, zero-padded
    (one copy where no padding is needed, as on the main path)."""
    g, og, cg, k = plan.G, plan.og, plan.cg, plan.K
    og_pad = plan.n_otiles * plan.ob
    wp = w.view(g, og, cg, k)
    if (og_pad, plan.cg_pad) != (og, cg):
        wp = F.pad(wp, (0, 0, 0, plan.cg_pad - cg, 0, og_pad - og))
    return (wp.view(g, plan.n_otiles, plan.ob, plan.cg_pad, k)
            .permute(0, 1, 4, 2, 3).contiguous())


def _launch_fwd_bf16(x, w, stride: int, pad_l: int, t_out: int, groups: int):
    b, c_in, t_in = x.shape
    c_out, _, k = w.shape
    plan = _plan_fwd(b, c_in, c_out, k, stride, pad_l, t_in, t_out, groups)
    x = x.contiguous()
    wp = _fwd_weights(w, plan)
    y = torch.empty(b, c_out, t_out, device=x.device, dtype=x.dtype)
    lib = build.load("grouped_conv")
    err = lib.grouped_conv1d_fwd_bf16(
        x.data_ptr(), wp.data_ptr(), y.data_ptr(), plan.args, plan.ob,
        plan.cc, *plan.grid, plan.smem, _stream())
    build.check(err, "grouped_conv1d_fwd_bf16")
    return y


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


def _dx_weights(w, plan: DxPlan):
    """``[Cout, cg, K]`` -> ``[G, n_ctiles, s, nmax, nb, og_pad]``,
    zero-padded: per phase ``r`` its taps ``j0_r + s*m`` in order of ``m``.
    With K padded to ``s * nmax``, tap ``j`` is ``(m, j mod s)``, and
    ``j0_r = (r + pad_l) mod s`` is a roll of the residues."""
    g, og, cg, s = plan.G, plan.og, plan.cg, plan.stride
    wp = F.pad(w.view(g, og, cg, plan.K).permute(0, 2, 3, 1),
               (0, plan.og_pad - og, 0, s * plan.nmax - plan.K,
                0, plan.n_ctiles * plan.nb - cg))
    wp = wp.view(g, plan.n_ctiles, plan.nb, plan.nmax, s, plan.og_pad)
    wp = torch.roll(wp, -(plan.pad_l % s), dims=4)
    return wp.permute(0, 1, 4, 3, 2, 5).contiguous()


def _launch_dx_bf16(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    b, c_out, t_out = dy.shape
    _, cg, k = w.shape
    plan = _plan_dx(b, cg * groups, c_out, k, stride, pad_l, t_in, t_out,
                    groups)
    dy = dy.contiguous()
    wph = _dx_weights(w, plan)
    dx = torch.empty(b, cg * groups, t_in, device=dy.device, dtype=dy.dtype)
    lib = build.load("grouped_conv")
    err = lib.grouped_conv1d_dx_bf16(
        dy.data_ptr(), wph.data_ptr(), dx.data_ptr(), plan.args, plan.nb,
        plan.oc, *plan.grid, plan.smem, _stream())
    build.check(err, "grouped_conv1d_dx_bf16")
    return dx


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
    t_out = out_length(x.shape[-1], w.shape[-1], stride, pad_l, pad_r)
    launch = _launch_fwd_bf16 if x.dtype == torch.bfloat16 else _launch_fwd_f32
    y = launch(x, w, stride, pad_l, t_out, groups)
    conv_fwd.launches += 1
    return y


def conv_dx(dy, w, stride: int, pad_l: int, t_in: int, groups: int):
    """Data gradient ``[B, Cin, t_in]`` of ``dy`` ``[B, Cout, Tout]``: the
    polyphase transposed conv (``conv_dx_kernel``) in bf16, the forward
    kernel on stride-dilated ``dy`` in f32."""
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
        dx = _launch_dx_bf16(dy, w, stride, pad_l, t_in, groups)
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
