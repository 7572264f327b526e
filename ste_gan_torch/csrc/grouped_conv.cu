// Grouped 1-D convolution for Hopper (sm_90a): forward, data gradient (dX)
// and the f32 weight gradient (dW), CUDA C++ behind a plain C interface; the
// bf16 dW is grouped_conv_dw.cu, and the device helpers both use are
// hopper.cuh.
//
// Replaces the Pallas TPU kernels of ste_gan_tpu/ops/pallas_conv.py:
//   * conv_fwd_wgmma_kernel <- _fwd_kernel (:147-155) via _run_fwd
//                           (:189-208), bf16;
//   * conv_dx_wgmma_kernel  <- its second use, the dX pass of
//                           _conv_core_bwd (:264-305), bf16. Both run one
//                           wgmma mainloop (warp-specialised, weights
//                           resident per group, persistent CTAs) after the
//                           one-launch conv_weight_layout_kernel.
//   * conv_fwd_kernel    <- _fwd_kernel in f32, on the CUDA cores. It also
//                           computes the f32 dX the way _conv_core_bwd
//                           (:282-304) does: the forward at stride 1 on
//                           stride-dilated dy with tap-flipped,
//                           in/out-transposed weights.
//   * conv_dw_partial_f32_kernel + conv_dw_reduce_kernel
//                        <- _dw_kernel (:158-174) via _run_dw (:211-234) in
//                           f32, on the CUDA cores (bf16: grouped_conv_dw.cu
//                           conv_dw_wgmma_kernel, one launch, wgmma over the
//                           same channel-last window, rows split over a
//                           thread-block cluster, partial sums added on chip).
//
// Layout is PyTorch's: x [B, Cin, Tin], y and dy [B, Cout, Tout]; output
// channels form G consecutive blocks of og = Cout/G, input channels blocks
// of cg = Cin/G. dW is written as [Cout, cg, K]. Every sum is accumulated in
// f32 and the result is written in the operand type; no sum uses atomics,
// and every sum is taken in a fixed order (two calls agree bit for bit).
// The f32 kernels stay exact f32 on the CUDA cores (no TF32).
//
// What bounds them: at the scale discriminators' shapes (K 37, cg 16-32,
// og 32-64) each output element takes ~2.4k FLOP of a few bytes of input, so
// forward, dX and dW are bound by arithmetic, and in bf16 by the tensor-core
// rate. Each section below says what its design does about it.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps in the f32 kernels
constexpr int kTM = 4;  // time rows per thread (f32 forward)
constexpr int kTN = 4;  // output channels per thread (f32 forward)

// ---------------------------------------------------------------------------
// Forward in f32, CUDA cores. Block = (time tile of BM outputs, group x
// channel tile of BN, batch row). The input window of the tile
// ([cg][win_len] floats) is staged once; weights are staged kt taps at a
// time as [kt][cg][BN]; each thread keeps a 4x4 (time, channel) tile.
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int Tin, int Cin, int K, int Cout, int stride,
                int pad_l, int G, int Tout, int KT, int win_len, int win_stride) {
  constexpr int NX = BN / kTN;
  constexpr int NY = kThreads / NX;
  constexpr int BM = NY * kTM;
  extern __shared__ float smem[];
  const int cg = Cin / G, og = Cout / G;
  const int n_tiles = (og + BN - 1) / BN;
  const int g = blockIdx.y / n_tiles;
  const int n0 = (blockIdx.y % n_tiles) * BN;
  const int t0 = blockIdx.x * BM;
  const int b = blockIdx.z;
  float* win = smem;                       // [cg][win_stride]
  float* ws = smem + cg * win_stride;      // [KT][cg][BN]

  const float* xb = x + ((size_t)b * Cin + (size_t)g * cg) * Tin;
  const int base = t0 * stride - pad_l;
  for (int i = threadIdx.x; i < cg * win_len; i += kThreads) {
    const int c = i / win_len, r = i - c * win_len;
    const int t = base + r;
    win[c * win_stride + r] = (t >= 0 && t < Tin) ? xb[(size_t)c * Tin + t] : 0.f;
  }

  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    __syncthreads();  // window staged / previous weight chunk consumed
    const float* wg = w + ((size_t)g * K + k0) * cg * og;
    for (int i = threadIdx.x; i < kt * cg * BN; i += kThreads) {
      const int row = i / BN, n = i - row * BN;  // row = kk * cg + c
      const int o = n0 + n;
      ws[row * BN + n] = (o < og) ? wg[(size_t)row * og + o] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      const float* xr = win + (k0 + kk) + ty * kTM * stride;
      const float* wr = ws + kk * cg * BN + tx * kTN;
#pragma unroll 4
      for (int c = 0; c < cg; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(wr + c * BN);
        const float* xc = xr + c * win_stride;
        float av[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = xc[i * stride];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int o = n0 + tx * kTN + j;
    if (o >= og) continue;
    float* yr = y + ((size_t)b * Cout + (size_t)g * og + o) * Tout;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int t = t0 + ty * kTM + i;
      if (t < Tout) yr[t] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward and dX in bf16 (Hopper): one implicit-GEMM mainloop, wgmma on a
// channel-last window, weights resident per (group, channel tile).
//
// conv_fwd_wgmma_kernel replaces pallas_conv.py:147 _fwd_kernel through
// _run_fwd (:189-208); conv_dx_wgmma_kernel replaces its second use, the
// data gradient of _conv_core_bwd (:264-305).
//
// Both are, per (group, channel tile), a GEMM of M = time rows, N = columns
// and a reduction over (tap, channel). The forward:
//   y[b, g*og + o, u] = sum_{j, c} x[b, g*cg + c, u*s + j - pad_l] * w[g*og + o, c, j];
// tap j of output row u0 + i reads the channel-last x window at plane
// j mod s, row i + j div s. dX is the same loop at stride 1 over dy, with
// the s input phases fused into N:
//   dx[b, g*cg + c, s*q + r] = sum_{e, o} dy[b, g*og + o, q + e] * w[g*og + o, c, r + P0 - s*e']
// where e = e_min + e' runs over the dy offsets of every phase (phase r's
// tap j0_r + s*m lies at offset d_r - m, ops/grouped_conv.py phases()), and
// P0 = pad_l - s*e_min; the weight is zero where that tap lies outside
// [0, K). A reduction row is (offset e', output channel o), a column
// co*s + r (input channel co, phase r): N = s*cg, 64 at layer 1 and 32 at
// layer 2 of the main path, and the phases share one dy window. The zero slots cost
// 1 - K / (s*E) of the products (E offsets): 1 in 38 on the main path (K
// 37, s 2, E 19), 1 in 42 at the full scale discriminators' K 41, s 2, 3
// in 44 at K 41, s 4, and 5 in 8 at K 3, s 4 (K < s).
//
// What bounds them: operations, 104.3 GFLOP per six-geometry pass of the
// main path (0.105 ms at 989 TFLOP/s) against ~100 MB of operands. The
// smem-operand ceiling: each wgmma m64nNk16 reads A (64 rows x 16
// channels, 2 KB) and B (N x 16) from shared memory; at N 32 with one k16
// step per tap (layer 2, cg 16) the 3 KB take about as many cycles at 128
// B per clock as its 16 cycles of products, so layer 2 is held near two
// thirds of peak.
//
// What the design does about what held the mma.sync kernels back:
//   1. Weights restaged per block: persistent CTAs (one per SM) walk a
//      balanced contiguous range of tiles in (group, channel tile)-major
//      order. The wrapper's one-launch conv_weight_layout_kernel writes each
//      (group, channel tile) slab in its shared-memory layout, and one
//      thread loads it with cp.async.bulk against an mbarrier only when the
//      next tile is of another slab (one to three loads per CTA and call).
//      Where a slab and the window ring do not fit in 227 KB (the full
//      scale discriminators' K 41, cg 64 and s 4, cg 32 layers) the same
//      kernel streams it per tile through a two-slot ring of tap chunks.
//   2. Synchronous window staging: warp specialisation. A CTA runs two
//      pipes, each one consumer warpgroup, two window warps that stage the
//      next tile's window into the other slot of a two-slot ring, and one
//      weight thread; completion travels on
//      mbarriers, never __syncthreads. The window warps transpose x or dy
//      ([B, C, T]) to channel-last by registers: 16-byte loads of 8 time
//      steps of 8 channels, regrouped with byte permutes into 8 rows of 8
//      channels, two such units in flight per thread (lengths that are not
//      a multiple of 8 take 2-byte loads, eight per row). A bulk load of
//      the time-major box would need a staging buffer that layer 1's
//      resident slab leaves no room for, and rows of a 16-byte multiple,
//      which odd lengths lack. The consumer pipes take turns to issue their
//      products (pipe 0, pipe 1, pipe 0, ...), so that one pipe's epilogue
//      runs under the other's products; the kernel starts as a programmatic
//      dependent of the layout kernel, and only its weight thread waits
//      for that kernel's end.
//   3. ldmatrix + mma.sync: wgmma.mma_async m64nNk16 (N 16, 32 or 64) from
//      shared-memory descriptors; a tile's products are all issued before
//      one commit_group and wait_group, k16 steps outermost so that each
//      tap's product follows the last without a loop between, and each
//      tap's issue overlaps the running ones (when streamed, one chunk's
//      wait overlaps the next chunk's issue). The layout has no swizzle, in 16-byte core-matrix
//      rows: the window is [plane][c/8][row][8] and a weight tap
//      [c/8][n][8], so an 8 x 8 core matrix is 128 contiguous bytes (no
//      bank conflict) and a tap's one-row shift is a 16-byte move of the
//      descriptor's start address, which a swizzled layout could not take
//      without its base-offset field. LBO = the next 8 channels (rows x 16
//      bytes), SBO = the next 8 rows (128 bytes).
//   4. Fixed time tiles: 64 or 128 rows per consumer (128 = two m64
//      products on one B tile), picked from the row count; the pipes take a
//      CTA's tiles in turn, so they differ by at most one tile and no
//      warpgroup idles at T_out 128.
// The epilogue converts to bf16, writes an [o][u] (forward) or [c][t] (dX,
// two phases of a channel as one 4-byte pair) tile into the window slot
// just consumed and stores 16-byte rows contiguous in time, while the other
// pipe's products run. Timed on an H100 with parts switched off, the rest of
// the gap to the bound lies in the epilogue and in a call's fixed cost (the
// layout kernel, the first slab load), not in the products.
// ---------------------------------------------------------------------------

struct ConvParams {  // field order = _CONV_FIELDS in ops/grouped_conv.py
  int B, C_src, T_src, C_dst, T_dst, G;  // source x or dy, destination y or dx
  int CR, C8, S, KE, t_off;   // reduction channels per group, 8-channel groups
                              // (padded to 16), window stride, taps, window
                              // time offset
  int R, CO, CO_total, n_nt;  // phases in N, channels per channel tile, per
                              // group, channel tiles per group
  int mt, n_tt, V, tiles_per_slab, n_tiles;  // m64 products per tile, time
                                             // tiles, window rows per plane
  int resident, ck, n_chunks;                // slab resident, or streamed in
                                             // chunks of ck taps
  int slot_bytes, tap_bytes, w_off, win_off, out_ld;
  int K, stride, P0, dx;  // the weight layout
  int vec, s_shift;       // 16-byte window loads; log2 S when S is a power of 2
};

constexpr int kConvThreads = 448;  // warps 0-7: consumers, 8-11: windows, 12-13: weights
constexpr int kWinThreads = 64;    // window threads per pipe
constexpr int kSlots = 2;          // window slots per pipe
constexpr uint32_t kBulkPiece = 32768;

// ---- bulk copies and wgmma from shared memory (sm_90a PTX; the rest in
// hopper.cuh) ----

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// global -> shared in pieces, completing `bytes` (a multiple of 16) on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
    const uint32_t n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_addr(bar))
        : "memory");
  }
}

// d[64 x N] += A[64 x 16] * B[N x 16]^T, bf16 operands from shared memory, f32
// accumulators: per 8 columns nb, d[4nb + e] is row 16*warp + lane/4 +
// 8*(e/2), column 8nb + 2*(lane%4) + e%2.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

struct ConvTile {
  int slab, g, nt, b, tt;
};

// Tile i of a call: slab-major ((group, channel tile), batch row, time tile).
__device__ __forceinline__ ConvTile conv_tile(const ConvParams& p, int i) {
  ConvTile t;
  t.slab = i / p.tiles_per_slab;
  const int rem = i - t.slab * p.tiles_per_slab;
  t.b = rem / p.n_tt;
  t.tt = rem - t.b * p.n_tt;
  t.g = t.slab / p.n_nt;
  t.nt = t.slab - t.g * p.n_nt;
  return t;
}

// The products of taps [t_begin, t_end) on one window slot: tap t reads
// window rows starting at row t div S of plane t mod S; its weights are
// tap t - t_begin of the slab or chunk at w_addr. k16 steps are the outer
// loop, so that the taps' products run back to back. Operand addresses are
// counted in 16-byte units, the descriptor's own.
template <int NT, int MT>
__device__ __forceinline__ void conv_taps(float (&acc)[MT][NT / 2], const ConvParams& p,
                                          uint32_t win_addr, uint32_t w_addr,
                                          int t_begin, int t_end) {
  const int ksteps = p.C8 >> 1;
  const uint32_t plane_units = (uint32_t)(p.C8 * p.V), tap_units = (uint32_t)(p.C8 * NT);
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t da0 = smem_desc(win_addr, p.V * 16, 128) + (uint32_t)(2 * ks * p.V);
    uint64_t db = smem_desc(w_addr, NT * 16, 128) + (uint32_t)(2 * ks * NT);
    int plane = t_begin % p.S;
    uint32_t a_off = (uint32_t)plane * plane_units + (uint32_t)(t_begin / p.S);
    for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
      for (int h = 0; h < MT; ++h) wgmma_bf16<NT>(acc[h], da0 + a_off + 64 * h, db);
      db += tap_units;
      if (++plane == p.S) {  // the next row of plane 0
        plane = 0;
        a_off -= (uint32_t)(p.S - 1) * plane_units - 1;
      } else {
        a_off += plane_units;
      }
    }
  }
}

template <int NT, int MT>
__device__ __forceinline__ void conv_wgmma_body(const bf16* __restrict__ src,
                                                const bf16* __restrict__ wp,
                                                bf16* __restrict__ dst,
                                                const ConvParams& p) {
  extern __shared__ __align__(128) unsigned char conv_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(conv_smem);
  uint64_t* win_full = bars;                    // [pipe][slot], 64 window threads
  uint64_t* win_empty = bars + 2 * kSlots;      // [pipe][slot], 128 consumer threads
  uint64_t* chk_full = bars + 4 * kSlots;       // [pipe][2], bytes of a chunk
  uint64_t* chk_empty = bars + 4 * kSlots + 4;  // [pipe][2], 128 consumer threads
  uint64_t* slab_full = bars + 4 * kSlots + 8;  // bytes of a slab
  uint64_t* slab_empty = slab_full + 1;            // 256 consumer threads
  uint64_t* turn = slab_full + 2;                  // [pipe], 128 threads of the other pipe
  // The warp index through a shuffle, so that the compiler sees every role
  // branch as warp-uniform (a divergent path around wgmma serialises it).
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  // This CTA's tiles [lo, hi), and the slabs they span.
  const int lo = (int)((long long)blockIdx.x * p.n_tiles / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * p.n_tiles / gridDim.x);
  const int slab_lo = lo / p.tiles_per_slab;
  const int n_slabs = (hi - 1) / p.tiles_per_slab - slab_lo + 1;
  const int bm = 64 * MT;
  if (tid == 0) {
    for (int i = 0; i < 2 * kSlots; ++i) {
      mbar_init(win_full + i, kWinThreads);
      mbar_init(win_empty + i, 128);
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(chk_full + i, 1);
      mbar_init(chk_empty + i, 128);
    }
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, 256);
    mbar_init(turn, 128);
    mbar_init(turn + 1, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 12) {
    // ---- Weights: lane 0 of warp 12 (pipe 0, and the resident slabs) or
    // 13 (pipe 1). ----
    const int pipe = warp - 12;
    if ((tid & 31) != 0 || (p.resident && pipe != 0)) return;
    // The layout kernel before this one writes wp (programmatic launch:
    // the other roles start meanwhile, on data that kernel does not touch).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const char* wb = reinterpret_cast<const char*>(wp);
    if (p.resident) {
      const uint32_t bytes = (uint32_t)(p.KE * p.tap_bytes);
      for (int k = 0; k < n_slabs; ++k) {
        if (k > 0) mbar_wait(slab_empty, (k - 1) & 1);  // both pipes are done with k - 1
        mbar_expect_tx(slab_full, bytes);
        bulk_load(conv_smem + p.w_off, wb + (size_t)(slab_lo + k) * bytes, bytes, slab_full);
      }
    } else {
      int m = 0;  // chunks of this pipe so far
      for (int i = lo + pipe; i < hi; i += 2) {
        const int slab = i / p.tiles_per_slab;
        for (int c = 0; c < p.n_chunks; ++c, ++m) {
          const int cs = pipe * 2 + (m & 1);
          if (m >= 2) mbar_wait(chk_empty + cs, ((m >> 1) - 1) & 1);
          const int t0 = c * p.ck, n_taps = min(p.ck, p.KE - t0);
          const uint32_t bytes = (uint32_t)(n_taps * p.tap_bytes);
          mbar_expect_tx(chk_full + cs, bytes);
          bulk_load(conv_smem + p.w_off + (size_t)cs * p.ck * p.tap_bytes,
                    wb + ((size_t)slab * p.KE + t0) * p.tap_bytes, bytes, chk_full + cs);
        }
      }
    }
    return;
  }

  if (warp >= 8) {
    // ---- Windows: warps 8-9 for pipe 0, 10-11 for pipe 1. Window position
    // pv (source time t0 + pv) of channels 8*c8.. goes to row pv div S of
    // plane pv mod S, as one 16-byte row of 8 channels. ----
    const int pipe = (warp - 8) >> 1, ptid = tid - 256 - pipe * kWinThreads;
    const unsigned short* srch = reinterpret_cast<const unsigned short*>(src);
    int s_idx = 0, s_round = 0;  // ring slot and the times the ring went round
    for (int i = lo + pipe; i < hi; i += 2) {
      const ConvTile t = conv_tile(p, i);
      const int slot = pipe * kSlots + s_idx;
      if (s_round > 0) mbar_wait(win_empty + slot, (s_round - 1) & 1);
      bf16* win = reinterpret_cast<bf16*>(conv_smem + p.win_off + (size_t)slot * p.slot_bytes);
      const unsigned short* sb = srch + ((size_t)t.b * p.C_src + (size_t)t.g * p.CR) * p.T_src;
      const int t0 = t.tt * bm * p.S + p.t_off;
      stage_window(win, sb, p.T_src, p.CR, p.C8, p.V, p.S, p.s_shift, p.vec, t0, ptid,
                   kWinThreads);
      fence_async_smem();
      mbar_arrive(win_full + slot);
      if (++s_idx == kSlots) {
        s_idx = 0;
        ++s_round;
      }
    }
    return;
  }

  // ---- Consumers: warpgroup 0 (pipe 0) or 1 (pipe 1). ----
  const int pipe = warp >> 2, wtid = tid & 127, wwarp = warp & 3, lane = tid & 31;
  const uint32_t base_addr = smem_addr(conv_smem);
  // This thread's accumulator columns 8*j + 2*(lane % 4) and the one after:
  // the first one's element offset in the output tile, [co][R*row + r] for
  // column co*R + r. The second is the next channel (R 1) or the next
  // phase of the same channel (R even); an odd R > 1 computes it.
  const int ncol = p.R * p.CO;
  int coff[NT / 8];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3), co = col / p.R;
    coff[j] = co * p.out_ld + col - co * p.R;
  }
  float acc[MT][NT / 2];
  int s_idx = 0, s_round = 0, m = 0, slab_k = -1;
  // The pipes take turns to issue their products (pipe 0 first), so that
  // one pipe's epilogue runs under the other's products: pipe 0's k-th
  // tile waits for pipe 1's (k-1)-th issue, pipe 1's k-th for pipe 0's
  // k-th. The tiles per pipe say which turns exist.
  const int n_other = pipe ? (hi - lo + 1) / 2 : (hi - lo) / 2;
  int k_tile = 0;
  for (int i = lo + pipe; i < hi; i += 2, ++k_tile) {
    const ConvTile t = conv_tile(p, i);
    const int slot = pipe * kSlots + s_idx;
    const uint32_t slot_off = p.win_off + (uint32_t)slot * p.slot_bytes;
    mbar_wait(win_full + slot, s_round & 1);
    if (p.resident) {
      // Every slab of the range in turn, this pipe's tiles in it or not,
      // so that slab_empty's phases follow the loads.
      while (slab_k < t.slab - slab_lo) {
        if (slab_k >= 0) mbar_arrive(slab_empty);
        ++slab_k;
        mbar_wait(slab_full, slab_k & 1);
      }
    }
#pragma unroll
    for (int h = 0; h < MT; ++h) {
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) acc[h][q] = 0.f;
      fence_acc(acc[h]);
    }
    wgmma_fence();
    const uint32_t win_addr = base_addr + slot_off;
    if (pipe == 1 || (k_tile >= 1 && k_tile - 1 < n_other))
      mbar_wait(turn + pipe, (pipe ? k_tile : k_tile - 1) & 1);
    // One chunk of all taps on the resident slab, or n_chunks streamed
    // ones: a chunk's slot is freed once the next chunk's products are
    // issued and its own are done.
    for (int c = 0; c < p.n_chunks; ++c, ++m) {
      const int cs = pipe * 2 + (m & 1);
      if (!p.resident) mbar_wait(chk_full + cs, (m >> 1) & 1);
      const int t0 = c * p.ck;
      const uint32_t w_addr =
          base_addr + p.w_off + (p.resident ? 0u : (uint32_t)(cs * p.ck * p.tap_bytes));
      conv_taps<NT, MT>(acc, p, win_addr, w_addr, t0, min(p.KE, t0 + p.ck));
      wgmma_commit();
      if (c == p.n_chunks - 1) mbar_arrive(turn + (pipe ^ 1));  // the other pipe's turn
      if (c > 0) {
        wgmma_wait<1>();
        mbar_arrive(chk_empty + pipe * 2 + ((m - 1) & 1));
      }
    }
    wgmma_wait<0>();
    if (!p.resident) mbar_arrive(chk_empty + pipe * 2 + ((m - 1) & 1));
#pragma unroll
    for (int h = 0; h < MT; ++h) fence_acc(acc[h]);

    // ---- Epilogue: the tile as [channel][time] bf16 in the window slot
    // (every warp of the group has passed its wait), then 16-byte rows.
    // Columns co*R + r and co*R + r + 1 of one row are adjacent times when
    // R is even: one 4-byte store. ----
    named_sync(1 + pipe, 128);
    bf16* ot = reinterpret_cast<bf16*>(conv_smem + slot_off);
#pragma unroll
    for (int h = 0; h < MT; ++h) {
#pragma unroll
      for (int q = 0; q < NT / 2; q += 2) {
        const int row = h * 64 + wwarp * 16 + (lane >> 2) + ((q >> 1) & 1) * 8;
        const int j = q >> 2, col = 8 * j + 2 * (lane & 3);
        const bf16 v0 = __float2bfloat16(acc[h][q]), v1 = __float2bfloat16(acc[h][q + 1]);
        bf16* o0 = ot + coff[j] + row * p.R;
        if ((p.R & 1) == 0) {
          if (col < ncol) *reinterpret_cast<__nv_bfloat162*>(o0) = __halves2bfloat162(v0, v1);
        } else if (p.R == 1) {
          if (col < ncol) *o0 = v0;
          if (col + 1 < ncol) o0[p.out_ld] = v1;
        } else {
          if (col < ncol) *o0 = v0;
          if (col + 1 < ncol) {
            const int co1 = (col + 1) / p.R;
            ot[co1 * p.out_ld + col + 1 - co1 * p.R + row * p.R] = v1;
          }
        }
      }
    }
    named_sync(1 + pipe, 128);
    const int rows = p.R * bm, t_first = t.tt * rows;
    const int co_lim = min(p.CO, p.CO_total - t.nt * p.CO);
    const int t_lim = min(rows, p.T_dst - t_first);
    bf16* db = dst + ((size_t)t.b * p.C_dst + (size_t)t.g * p.CO_total + (size_t)t.nt * p.CO) *
                         p.T_dst + t_first;
    if ((p.T_dst & 7) == 0) {
      const int per = rows >> 3;  // 16-byte pieces of a row
      for (int idx = wtid; idx < co_lim * per; idx += 128) {
        const int co = idx / per, tl = (idx - co * per) * 8;
        const bf16* s8 = ot + co * p.out_ld + tl;
        bf16* d8 = db + (size_t)co * p.T_dst + tl;
        if (tl + 8 <= t_lim)
          *reinterpret_cast<uint4*>(d8) = *reinterpret_cast<const uint4*>(s8);
        else
          for (int e = 0; e < t_lim - tl; ++e) d8[e] = s8[e];
      }
    } else {
      for (int idx = wtid; idx < co_lim * rows; idx += 128) {
        const int co = idx / rows, tl = idx - co * rows;
        if (tl < t_lim) db[(size_t)co * p.T_dst + tl] = ot[co * p.out_ld + tl];
      }
    }
    mbar_arrive(win_empty + slot);
    if (++s_idx == kSlots) {
      s_idx = 0;
      ++s_round;
    }
  }
  if (p.resident) {
    while (slab_k < n_slabs - 1) {
      if (slab_k >= 0) mbar_arrive(slab_empty);
      ++slab_k;
      mbar_wait(slab_full, slab_k & 1);
    }
  }
}

template <int NT, int MT>
__global__ void __launch_bounds__(kConvThreads, 1)
conv_fwd_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                      bf16* __restrict__ y, const ConvParams p) {
  conv_wgmma_body<NT, MT>(x, wp, y, p);
}

template <int NT, int MT>
__global__ void __launch_bounds__(kConvThreads, 1)
conv_dx_wgmma_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ wp,
                     bf16* __restrict__ dx, const ConvParams p) {
  conv_wgmma_body<NT, MT>(dy, wp, dx, p);
}

// The weights [Cout, cg, K] as the kernels' slabs [G * n_nt][KE][C8][NT][8]:
// element (slab, t, c8, n, e) is reduction channel cr = 8*c8 + e of column
// n = co*R + r (channel nt*CO + co, phase r), tap j = t (forward) or
// P0 + r - stride*t (dX); zero past the channels, columns and taps. One
// launch per call (ops/grouped_conv.py _layout_weights is the same map).
__global__ void conv_weight_layout_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp,
                                          const ConvParams p, int nt_w, int total) {
  // The conv kernel launched after this one may start now: only its weight
  // thread waits (griddepcontrol.wait) for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    int rest = i >> 3;
    const int e = i & 7;
    const int n = rest % nt_w;
    rest /= nt_w;
    const int c8 = rest % p.C8;
    rest /= p.C8;
    const int t = rest % p.KE;
    const int slab = rest / p.KE;
    const int g = slab / p.n_nt, nt = slab - g * p.n_nt;
    const int cr = c8 * 8 + e, co = n / p.R, r = n - co * p.R, ch = nt * p.CO + co;
    const int j = p.dx ? p.P0 + r - p.stride * t : t;
    bf16 v = __float2bfloat16(0.f);
    if (n < p.R * p.CO && cr < p.CR && ch < p.CO_total && j >= 0 && j < p.K) {
      // forward: w[g*og + ch, cr, j]; dX: w[g*og + cr, ch, j]
      const int o = p.dx ? g * p.CR + cr : g * p.CO_total + ch;
      const int c = p.dx ? ch : cr;
      v = w[((size_t)o * (p.dx ? p.CO_total : p.CR) + c) * p.K + j];
    }
    wp[i] = v;
  }
}

// ---------------------------------------------------------------------------
// dW in f32, CUDA cores. Block = (tap tile of KT taps, group, chunk of the
// flattened batch x time rows). Outputs of the block: M = kt*cg rows (tap,
// input channel) by N = og columns; thread (ty, tx) owns rows ty + NY*i and
// columns tx + NX*j. Rows are staged kBTf at a time: xs[kBTf][M+1] and
// dys[kBTf][N+1] (padded against bank conflicts). Each block writes its
// chunk's f32 partial slab [Cout, K, cg]; conv_dw_reduce_kernel adds them.
// ---------------------------------------------------------------------------

constexpr int kBTf = 32;
constexpr int kDwT = 4;  // max rows/columns per thread

__global__ void __launch_bounds__(kThreads)
conv_dw_partial_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                           float* __restrict__ part, int B, int Tin, int Cin, int K,
                           int Cout, int stride, int pad_l, int G, int Tout, int KT,
                           int NX, int rows_per_chunk) {
  extern __shared__ float smem[];
  const int cg = Cin / G, og = Cout / G;
  const int k0 = blockIdx.x * KT;
  const int kt = min(KT, K - k0);
  const int g = blockIdx.y;
  const int chunk = blockIdx.z;
  const int M = kt * cg, N = og;
  const int NY = kThreads / NX;
  const int xs_ld = M + 1, dys_ld = N + 1;
  float* xs = smem;                           // [kBTf][xs_ld]
  float* dys = smem + kBTf * (KT * cg + 1);   // [kBTf][dys_ld]
  __shared__ int row_b[kBTf], row_t[kBTf];

  const long long R = (long long)B * Tout;
  const long long r_begin = (long long)chunk * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);

  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  float acc[kDwT][kDwT];
#pragma unroll
  for (int i = 0; i < kDwT; ++i)
#pragma unroll
    for (int j = 0; j < kDwT; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kBTf) {
    __syncthreads();
    if (threadIdx.x < kBTf) {
      const long long r = r0 + threadIdx.x;
      const int bb = r < r_end ? (int)(r / Tout) : -1;
      row_b[threadIdx.x] = bb;
      row_t[threadIdx.x] = bb < 0 ? 0 : (int)(r - (long long)bb * Tout);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBTf * M; i += kThreads) {
      const int c = i / (kBTf * kt);
      const int rem = i - c * kBTf * kt;
      const int rt = rem / kt, kk = rem - rt * kt;
      const int bb = row_b[rt];
      const int ti = row_t[rt] * stride + k0 + kk - pad_l;
      float v = 0.f;
      if (bb >= 0 && ti >= 0 && ti < Tin) v = x[((size_t)bb * Cin + (size_t)g * cg + c) * Tin + ti];
      xs[rt * xs_ld + kk * cg + c] = v;
    }
    for (int i = threadIdx.x; i < kBTf * N; i += kThreads) {
      const int n = i / kBTf, rt = i - n * kBTf;
      const int bb = row_b[rt];
      dys[rt * dys_ld + n] =
          bb >= 0 ? dy[((size_t)bb * Cout + (size_t)g * og + n) * Tout + row_t[rt]] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rt = 0; rt < kBTf; ++rt) {
      float av[kDwT], bv[kDwT];
#pragma unroll
      for (int i = 0; i < kDwT; ++i) {
        const int m = ty + NY * i;
        av[i] = (m < M) ? xs[rt * xs_ld + m] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kDwT; ++j) {
        const int n = tx + NX * j;
        bv[j] = (n < N) ? dys[rt * dys_ld + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kDwT; ++i)
#pragma unroll
        for (int j = 0; j < kDwT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* pc = part + (size_t)chunk * Cout * K * cg;
#pragma unroll
  for (int i = 0; i < kDwT; ++i) {
    const int m = ty + NY * i;
    if (m >= M) continue;
    const int kk = m / cg, c = m - kk * cg;
#pragma unroll
    for (int j = 0; j < kDwT; ++j) {
      const int n = tx + NX * j;
      if (n >= N) continue;
      pc[((size_t)(g * og + n) * K + k0 + kk) * cg + c] = acc[i][j];
    }
  }
}

// f32 dW, second pass: add the chunks' [Cout, K, cg] slabs in chunk order
// and write [Cout, cg, K].
__global__ void conv_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                      int n_chunks, int K, int cg, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < n_chunks; ++c) sum += part[(size_t)c * total + i];
    const int c = (int)(i % cg);
    const long long oj = i / cg;
    const int j = (int)(oj % K);
    const long long o = oj / K;
    dw[((size_t)o * cg + c) * K + j] = sum;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int BN>
int launch_fwd(const void* x, const void* w, void* y, int B, int Tin, int Cin, int K,
               int Cout, int stride, int pad_l, int G, int Tout, int KT, int win_len,
               int win_stride, int smem_bytes, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  auto kern = conv_fwd_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int og = Cout / G;
  dim3 grid((Tout + BM - 1) / BM, G * ((og + BN - 1) / BN), B);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
      Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride);
  return (int)cudaGetLastError();
}

template <int NT, int MT>
int launch_conv(bool dx, const void* src, const void* w, void* wp, void* dst,
                const ConvParams& p, int grid, int smem_bytes, cudaStream_t stream) {
  const int total = p.G * p.n_nt * p.KE * p.C8 * NT * 8;
  conv_weight_layout_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wp), p, NT, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void (*kern)(const bf16*, const bf16*, bf16*, const ConvParams) =
      dx ? conv_dx_wgmma_kernel<NT, MT> : conv_fwd_wgmma_kernel<NT, MT>;
  // The shared-memory limit each kernel has been given so far (raised, never
  // lowered: one attribute call per kernel and size, not per launch).
  static int smem_set[2] = {0, 0};
  if (smem_bytes > smem_set[dx]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dx] = smem_bytes;
  }
  // Programmatic dependent launch: the kernel's prologue and first windows
  // overlap the layout kernel's run.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(src),
                                 static_cast<const bf16*>(wp), static_cast<bf16*>(dst), p);
}

int dispatch_conv(bool dx, const void* src, const void* w, void* wp, void* dst,
                  const int* params, int nt, int grid, int smem_bytes, void* stream) {
  const ConvParams& p = *reinterpret_cast<const ConvParams*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt * 4 + p.mt) {
    case 16 * 4 + 1: return launch_conv<16, 1>(dx, src, w, wp, dst, p, grid, smem_bytes, s);
    case 16 * 4 + 2: return launch_conv<16, 2>(dx, src, w, wp, dst, p, grid, smem_bytes, s);
    case 32 * 4 + 1: return launch_conv<32, 1>(dx, src, w, wp, dst, p, grid, smem_bytes, s);
    case 32 * 4 + 2: return launch_conv<32, 2>(dx, src, w, wp, dst, p, grid, smem_bytes, s);
    case 64 * 4 + 1: return launch_conv<64, 1>(dx, src, w, wp, dst, p, grid, smem_bytes, s);
    case 64 * 4 + 2: return launch_conv<64, 2>(dx, src, w, wp, dst, p, grid, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// f32 forward; w is [G, K, cg, og]. Every entry point returns
// cudaGetLastError() after its launches.
int grouped_conv1d_fwd_f32(const void* x, const void* w, void* y, int bn, int B, int Tin,
                           int Cin, int K, int Cout, int stride, int pad_l, int G,
                           int Tout, int KT, int win_len, int win_stride, int smem_bytes,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return launch_fwd<16>(x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride, smem_bytes, s);
    case 32: return launch_fwd<32>(x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride, smem_bytes, s);
    case 64: return launch_fwd<64>(x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 forward and dX (conv_fwd_wgmma_kernel, conv_dx_wgmma_kernel), each
// after conv_weight_layout_kernel. params: the ConvParams fields in order;
// nt = the wgmma N (16, 32 or 64); wp: scratch of G * n_nt * KE * C8 * nt * 8
// bf16 for the layout; grid: persistent CTAs.
int grouped_conv1d_fwd_bf16(const void* x, const void* w, void* wp, void* y,
                            const int* params, int nt, int grid, int smem_bytes,
                            void* stream) {
  return dispatch_conv(false, x, w, wp, y, params, nt, grid, smem_bytes, stream);
}

int grouped_conv1d_dx_bf16(const void* dy, const void* w, void* wp, void* dx,
                           const int* params, int nt, int grid, int smem_bytes,
                           void* stream) {
  return dispatch_conv(true, dy, w, wp, dx, params, nt, grid, smem_bytes, stream);
}

// The layout kernel alone (chip_smoke.py holds it against _layout_weights).
int grouped_conv1d_weight_layout(const void* w, void* wp, const int* params, int nt,
                                 void* stream) {
  const ConvParams& p = *reinterpret_cast<const ConvParams*>(params);
  const int total = p.G * p.n_nt * p.KE * p.C8 * nt * 8;
  conv_weight_layout_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wp), p, nt, total);
  return (int)cudaGetLastError();
}

// f32 dW. part: f32 scratch of n_chunks * Cout * K * (Cin/G).
int grouped_conv1d_dw_f32(const void* x, const void* dy, void* part, void* dw, int B,
                          int Tin, int Cin, int K, int Cout, int stride, int pad_l,
                          int G, int Tout, int KT, int NX, int n_chunks,
                          int rows_per_chunk, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  auto kern = conv_dw_partial_f32_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((K + KT - 1) / KT, G, n_chunks);
  kern<<<grid, kThreads, smem_bytes, s>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(dy), pt, B, Tin,
                                          Cin, K, Cout, stride, pad_l, G, Tout, KT, NX,
                                          rows_per_chunk);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)Cout * K * (Cin / G);
  const long long want = (total + 255) / 256;
  conv_dw_reduce_kernel<<<want < 4096 ? (int)want : 4096, 256, 0, s>>>(
      pt, static_cast<float*>(dw), n_chunks, K, Cin / G, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
