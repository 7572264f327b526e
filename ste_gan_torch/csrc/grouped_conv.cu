// Grouped 1-D convolution for Hopper (sm_90a): forward, data gradient (dX)
// and weight gradient (dW), CUDA C++ behind a plain C interface.
//
// Replaces the Pallas TPU kernels of ste_gan_tpu/ops/pallas_conv.py:
//   * conv_fwd_bf16_kernel <- _fwd_kernel (:147-155) via _run_fwd (:189-208),
//                           bf16: an implicit GEMM per group.
//   * conv_fwd_kernel    <- the same, f32, on the CUDA cores. It also
//                           computes the f32 dX the way _conv_core_bwd
//                           (:282-304) does: the forward at stride 1 on
//                           stride-dilated dy with tap-flipped,
//                           in/out-transposed weights.
//   * conv_dx_kernel     <- the dX pass of _conv_core_bwd (:282-304), bf16.
//   * conv_dw_partial_kernel + conv_dw_reduce_kernel
//                        <- _dw_kernel (:158-174) via _run_dw (:211-234),
//                           bf16; conv_dw_partial_f32_kernel is the f32
//                           route, on the CUDA cores.
//
// Layout is PyTorch's: x [B, Cin, Tin], y and dy [B, Cout, Tout]; output
// channels form G consecutive blocks of og = Cout/G, input channels blocks
// of cg = Cin/G. dW is written as [Cout, cg, K]. Every sum is accumulated in
// f32 and the result is written in the operand type. The bf16 kernels run
// on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate, operands
// loaded from shared memory with ldmatrix); the f32 kernels stay exact f32
// on the CUDA cores (no TF32).
//
// What bounds them: at the scale discriminators' shapes (K 37, cg 16-32,
// og 32-64) each output element takes ~2.4k FLOP of a few bytes of input, so
// forward, dX and dW are bound by arithmetic, and in bf16 by the tensor-core
// rate. Each section below says what its design does about it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps in every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 4;  // time rows per thread (f32 forward)
constexpr int kTN = 4;  // output channels per thread (f32 forward)

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// Tensor-core and async-copy primitives (sm_80+ PTX, run on sm_90a)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(const bf16* p, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Gathers src[0], src[ld], ..., src[7 * ld] (bf16 bits; the first n_ok of
// them, zeros after) into one 16-byte shared-memory store: 8 channels of
// one time step, transposed to channel-last on the way in.
__device__ __forceinline__ void store8(bf16* dst, const unsigned short* src, int ld,
                                       int n_ok) {
  unsigned short v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < n_ok ? src[(size_t)e * ld] : 0;
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
}

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
// Forward in bf16: an implicit GEMM per group on the tensor cores.
//
// y[b, g*og + o, u] = sum_{c, j} x[b, g*cg + c, u*s + j - pad_l] * w[g*og + o, c, j]:
// per group a GEMM of M = output time rows, N = og, reduction over
// (tap, input channel). Out-of-range x reads as zero.
//
// What bounds it: arithmetic (104 GFLOP per paired pass of the main path;
// each staged x element feeds ~og*K/s MACs), so the design feeds the tensor
// cores from shared memory, as dX does:
//   * Block = (time tile of BM outputs; group x tile of OB output channels;
//     batch row). Its x window, t = u0*s - pad_l + p for p < s*V, is staged
//     once per chunk of CC input channels, channel-last and split by phase
//     ([p mod s][p div s][c], rows padded by 8), transposing on the way in.
//     Tap j of output row u0 + i is then row i + j div s of plane j mod s:
//     consecutive outputs are consecutive 16-byte-aligned rows, and the 8
//     rows of an ldmatrix fall in distinct banks.
//   * Weights are permuted once per call by the wrapper, zero-padded, to
//     [G, n_otiles, K, OB, cg_pad] (c contiguous) and streamed through a
//     two-stage cp.async ring, mt taps per stage, so each weight element is
//     staged once per block.
//   * Warps tile BM x OB with warp tiles of 32x32 (64x16 at OB 16): per tap
//     and 16-deep step of channels, a warp loads MTM A fragments and NT/2 B
//     fragments with ldmatrix.x4 and issues MTM*NT mma.sync. A warp whose
//     rows all lie past Tout skips the products.
//   * The f32 accumulators leave through shared memory as an [o][u] tile, so
//     that the stores to y are contiguous in time.
// Channels past cg and og are zeros in shared memory; the ragged last time
// tile and output channels past og are masked at the store.
// ---------------------------------------------------------------------------

struct FwdParams {  // field order = _FWD_FIELDS in ops/grouped_conv.py
  int B, Cin, Cout, Tin, Tout, K, stride, pad_l, G;
  int cg, og, n_otiles, cg_pad, n_cchunks;
  int bm, V, mt, n_mchunks, so_stride;
};

// Warp tiling of a forward block with OB output channels; BM is _FWD_BM in
// ops/grouped_conv.py.
template <int OB>
struct FwdTile {
  static constexpr int NT = OB == 16 ? 2 : 4;   // n8 tiles per warp
  static constexpr int MTM = OB == 16 ? 4 : 2;  // m16 tiles per warp
  static constexpr int WN = NT * 8, WM = MTM * 16;
  static constexpr int WARPS_N = OB / WN;
  static constexpr int BM = (kWarps / WARPS_N) * WM;
};

template <int OB, int CC>
__global__ void __launch_bounds__(kThreads, 2)
conv_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                     bf16* __restrict__ y, const FwdParams p) {
  using Tile = FwdTile<OB>;
  constexpr int MTM = Tile::MTM, NT = Tile::NT, WM = Tile::WM, WN = Tile::WN;
  constexpr int BM = Tile::BM, CCP = CC + 8, PIECES = CC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* win = reinterpret_cast<bf16*>(smem_raw);      // [s][V][CCP]
  bf16* ring = win + p.stride * p.V * CCP;             // [2][mt][OB][CCP]
  float* sout = reinterpret_cast<float*>(smem_raw);   // [OB][so_stride], at the end
  const int s = p.stride;
  const int stage = p.mt * OB * CCP;
  const int g = blockIdx.y / p.n_otiles, ot = blockIdx.y - g * p.n_otiles;
  const int b = blockIdx.z, u0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Tile::WARPS_N, wn = warp - wm * Tile::WARPS_N;
  const bool active = u0 + wm * WM < p.Tout;
  const int t_base = u0 * s - p.pad_l;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) +
                             ((size_t)b * p.Cin + (size_t)g * p.cg) * p.Tin;
  const bf16* wg = wp + (size_t)blockIdx.y * p.K * OB * p.cg_pad;
  const int n_chunks = p.n_cchunks * p.n_mchunks;

  // Weight chunk ch (c-chunk ch / n_mchunks, taps j0..j0+mt) into ring slot
  // ch & 1; taps past K are never read.
  auto stage_weights = [&](int ch) {
    const int cc0 = (ch / p.n_mchunks) * CC, j0 = (ch % p.n_mchunks) * p.mt;
    bf16* dst = ring + (ch & 1) * stage;
    for (int i = threadIdx.x; i < p.mt * OB * PIECES; i += kThreads) {
      const int row = i / PIECES, piece = i - row * PIECES;  // row = tap * OB + o
      if (j0 + row / OB < p.K)
        cp_async16(dst + row * CCP + piece * 8,
                   wg + ((size_t)j0 * OB + row) * p.cg_pad + cc0 + piece * 8);
    }
  };
  // x at t_base + pv of input channels cc0..cc0+CC, channel-last, into row
  // pv div s of plane pv mod s; zeros outside [0, Tin) and past cg.
  auto stage_window = [&](int cc0) {
    for (int pv = threadIdx.x; pv < s * p.V; pv += kThreads) {
      const int t = t_base + pv;
      const bool in = t >= 0 && t < p.Tin;
      bf16* dst = win + ((pv % s) * p.V + pv / s) * CCP;
#pragma unroll
      for (int c8 = 0; c8 < PIECES; ++c8)
        store8(dst + c8 * 8, xb + (size_t)(cc0 + c8 * 8) * p.Tin + t, p.Tin,
               in ? p.cg - (cc0 + c8 * 8) : 0);
    }
  };

  float acc[MTM][NT][4];
#pragma unroll
  for (int i = 0; i < MTM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  stage_weights(0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int mc = ch % p.n_mchunks;
    // The previous chunk's closing barrier has freed the window.
    if (mc == 0) stage_window((ch / p.n_mchunks) * CC);
    if (ch + 1 < n_chunks) stage_weights(ch + 1);
    cp_async_commit();
    cp_async_wait1();  // chunk ch has landed
    __syncthreads();
    if (active) {
      const bf16* ws = ring + (ch & 1) * stage;
      const int j0 = mc * p.mt, n_taps = min(p.mt, p.K - j0);
      for (int jj = 0; jj < n_taps; ++jj) {
        const int j = j0 + jj;
        const bf16* arow =
            win + ((j % s) * p.V + wm * WM + j / s + (lane & 15)) * CCP + (lane >> 4) * 8;
        const bf16* brow =
            ws + (jj * OB + wn * WN + (lane >> 4) * 8 + (lane & 7)) * CCP +
            ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < CC / 16; ++ks) {
          uint32_t a[MTM][4], bb[NT][2];
#pragma unroll
          for (int i = 0; i < MTM; ++i)
            ldsm_x4(arow + i * 16 * CCP + ks * 16, a[i][0], a[i][1], a[i][2], a[i][3]);
#pragma unroll
          for (int jn = 0; jn < NT / 2; ++jn)
            ldsm_x4(brow + jn * 16 * CCP + ks * 16, bb[2 * jn][0], bb[2 * jn][1],
                    bb[2 * jn + 1][0], bb[2 * jn + 1][1]);
#pragma unroll
          for (int i = 0; i < MTM; ++i)
#pragma unroll
            for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], a[i], bb[jn][0], bb[jn][1]);
        }
      }
    }
    __syncthreads();  // ring slot ch & 1 (and, at a c-chunk's end, the window) is free
  }

  // The output tile reuses the window and ring: every copy into them has
  // landed and every read has passed the last barrier.
  if (active) {
#pragma unroll
    for (int i = 0; i < MTM; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = wm * WM + i * 16 + (lane >> 2) + (e >> 1) * 8;
          const int o = wn * WN + jn * 8 + 2 * (lane & 3) + (e & 1);
          sout[o * p.so_stride + u] = acc[i][jn][e];
        }
  }
  __syncthreads();
  const int o_lim = min(OB, p.og - ot * OB), u_lim = min(BM, p.Tout - u0);
  bf16* yb = y + ((size_t)b * p.Cout + (size_t)g * p.og + ot * OB) * p.Tout + u0;
  for (int i = threadIdx.x; i < o_lim * BM; i += kThreads) {
    const int o = i / BM, u = i - o * BM;
    if (u < u_lim) yb[(size_t)o * p.Tout + u] = __float2bfloat16(sout[o * p.so_stride + u]);
  }
}

// ---------------------------------------------------------------------------
// dX in bf16: a polyphase transposed conv on the tensor cores.
//
// dx[b, c, t] = sum_{o, j : t = u*s + j - pad_l} dy[b, o, u] * w[o, c, j].
// Split t by phase r = t mod s, t = s*q + r. Phase r receives only the taps
// j = j0_r + s*m (j0_r = (r + pad_l) mod s, m < n_r), at u = q + d_r - m
// (d_r = (r + pad_l) div s): a stride-1 correlation of dy with n_r taps and
// per group a GEMM of M = q rows, N = cg, reduction og x n_r. No dilated dy
// is built and no zero is multiplied (the forward-on-dilated-dy route does
// half its work on zeros at stride 2).
//
// What bounds it: arithmetic (104 GFLOP per paired pass of the main path on
// a few MB), so the design feeds the tensor cores from shared memory:
//   * Block = (time tile of s*bq outputs, all phases; group x tile of NB
//     input channels; batch row). Its dy window is staged once per chunk of
//     OC output channels, channel-last ([u][o], rows padded by 8 so that the
//     8 row addresses of an ldmatrix fall in distinct banks), transposing on
//     the way in. A tap is then a row offset, and every row address stays
//     16-byte aligned, which a time-contiguous [o][u] tile would not be.
//   * Weights are permuted once per call by the wrapper, zero-padded, to
//     [G, n_ctiles, s, nmax, NB, og_pad] (per phase its taps in order), and
//     streamed through a two-stage cp.async ring, mt taps of every phase per
//     stage, so each weight element is staged once per block.
//   * Warp = one (phase, WM rows) unit with all NB columns: per 16-deep step
//     it loads MTM A fragments and NT/2 B fragments with ldmatrix.x4 and
//     issues MTM*NT mma.sync (warp tile 32x32 or 64x16).
//   * The f32 accumulators leave through shared memory as a [c][t] tile, so
//     that the stores to dx are contiguous in time.
// A phase with no taps (K < s) writes zeros; trailing inputs that a strided
// conv drops read only dy rows past Tout, which stage as zeros.
// ---------------------------------------------------------------------------

struct DxParams {  // field order = _DX_FIELDS in ops/grouped_conv.py
  int B, Cin, Cout, Tin, Tout, K, stride, pad_l, G;
  int cg, og, n_ctiles, og_pad, n_ochunks;
  int bq, upp, rounds, nmax, dmin, win_rows;
  int mt, n_mchunks, out_off, so_stride;
};

template <int MTM, int NT, int OC>
__global__ void __launch_bounds__(kThreads, 2)
conv_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ wph,
               bf16* __restrict__ dx, const DxParams p) {
  constexpr int WM = MTM * 16, NB = NT * 8, OCP = OC + 8, PIECES = OC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* win = reinterpret_cast<bf16*>(smem_raw);              // [win_rows][OCP]
  bf16* ring = win + p.win_rows * OCP;                         // [2][s][mt][NB][OCP]
  float* sout = reinterpret_cast<float*>(smem_raw + p.out_off);  // [NB][so_stride]
  const int s = p.stride;
  const int stage = s * p.mt * NB * OCP;
  const int g = blockIdx.y / p.n_ctiles, ct = blockIdx.y - g * p.n_ctiles;
  const int b = blockIdx.z, q0 = blockIdx.x * p.bq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u_lo = q0 + p.dmin - (p.nmax - 1);
  const unsigned short* dyb = reinterpret_cast<const unsigned short*>(dy) +
                              ((size_t)b * p.Cout + (size_t)g * p.og) * p.Tout;
  const bf16* wg = wph + (size_t)blockIdx.y * s * p.nmax * NB * p.og_pad;
  const int n_chunks = p.n_ochunks * p.n_mchunks;

  // Weight chunk ch (o-chunk ch / n_mchunks, taps m0..m0+mt of every phase)
  // into ring slot ch & 1; taps past nmax are never read.
  auto stage_weights = [&](int ch) {
    const int oc0 = (ch / p.n_mchunks) * OC, m0 = (ch % p.n_mchunks) * p.mt;
    bf16* dst = ring + (ch & 1) * stage;
    for (int i = threadIdx.x; i < s * p.mt * NB * PIECES; i += kThreads) {
      const int row = i / PIECES, piece = i - row * PIECES;
      const int n = row % NB, rm = row / NB;
      const int r = rm / p.mt, m = m0 + rm - r * p.mt;
      if (m < p.nmax)
        cp_async16(dst + row * OCP + piece * 8,
                   wg + ((size_t)(r * p.nmax + m) * NB + n) * p.og_pad + oc0 + piece * 8);
    }
  };
  // dy rows u_lo.. of output channels oc0..oc0+OC, channel-last; zeros
  // outside [0, Tout) and past og. The pieces of a row are unrolled, so
  // their loads can be issued ahead of the stores.
  auto stage_window = [&](int oc0) {
    for (int row = threadIdx.x; row < p.win_rows; row += kThreads) {
      const int u = u_lo + row;
      const bool in = u >= 0 && u < p.Tout;
#pragma unroll
      for (int c8 = 0; c8 < PIECES; ++c8)
        store8(win + row * OCP + c8 * 8, dyb + (size_t)(oc0 + c8 * 8) * p.Tout + u,
               p.Tout, in ? p.og - (oc0 + c8 * 8) : 0);
    }
  };

  for (int round = 0; round < p.rounds; ++round) {
    // This warp's unit: phase r, rows qg*WM.. of the tile (idle if r >= s).
    const int unit = warp + kWarps * round;
    const int r = unit / p.upp, qg = unit - r * p.upp;
    int nr = 0, dr = 0;
    if (r < s) {
      const int j0 = (r + p.pad_l) % s;
      nr = j0 < p.K ? (p.K - j0 + s - 1) / s : 0;
      dr = (r + p.pad_l) / s;
    }
    float acc[MTM][NT][4];
#pragma unroll
    for (int i = 0; i < MTM; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    stage_weights(0);
    cp_async_commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int mc = ch % p.n_mchunks;
      if (mc == 0) {
        __syncthreads();  // the previous o-chunk's window is consumed
        stage_window((ch / p.n_mchunks) * OC);
      }
      if (ch + 1 < n_chunks) stage_weights(ch + 1);
      cp_async_commit();
      cp_async_wait1();  // chunk ch has landed
      __syncthreads();
      const bf16* ws = ring + (ch & 1) * stage;
      const int m0 = mc * p.mt;
      for (int mm = 0; mm < p.mt; ++mm) {
        const int m = m0 + mm;
        if (m >= nr) break;
        const bf16* arow =
            win + (qg * WM + dr - p.dmin + p.nmax - 1 - m + (lane & 15)) * OCP +
            (lane >> 4) * 8;
        const bf16* brow =
            ws + ((r * p.mt + mm) * NB + (lane >> 4) * 8 + (lane & 7)) * OCP +
            ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < OC / 16; ++ks) {
          uint32_t a[MTM][4], bb[NT][2];
#pragma unroll
          for (int i = 0; i < MTM; ++i)
            ldsm_x4(arow + i * 16 * OCP + ks * 16, a[i][0], a[i][1], a[i][2], a[i][3]);
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
            ldsm_x4(brow + j * 16 * OCP + ks * 16, bb[2 * j][0], bb[2 * j][1],
                    bb[2 * j + 1][0], bb[2 * j + 1][1]);
#pragma unroll
          for (int i = 0; i < MTM; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], bb[j][0], bb[j][1]);
        }
      }
      __syncthreads();  // ring slot ch & 1 is free for chunk ch + 2
    }
    if (r < s) {
#pragma unroll
      for (int i = 0; i < MTM; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = qg * WM + i * 16 + (lane >> 2) + (e >> 1) * 8;
            const int c = j * 8 + 2 * (lane & 3) + (e & 1);
            sout[c * p.so_stride + q * s + r] = acc[i][j][e];
          }
    }
  }
  __syncthreads();
  const int tt = s * p.bq, t0 = q0 * s;
  for (int c = 0; c < NB; ++c) {
    const int cc = ct * NB + c;
    if (cc >= p.cg) break;
    bf16* dxr = dx + ((size_t)b * p.Cin + (size_t)g * p.cg + cc) * p.Tin;
    for (int tl = threadIdx.x; tl < tt && t0 + tl < p.Tin; tl += kThreads)
      dxr[t0 + tl] = __float2bfloat16(sout[c * p.so_stride + tl]);
  }
}

// ---------------------------------------------------------------------------
// dW in bf16: an implicit GEMM over rows on the tensor cores.
//
// dw[o, c, j] = sum_{b, u} dy[b, o, u] * x[b, c, u*s + j - pad_l]: per group
// a GEMM of M = og, N = (tap, c), reduction over the B x Tout rows.
//
// What bounds it: arithmetic again (104 GFLOP per paired pass). The design:
//   * Block = (tile of kt taps; group x tile of OB output channels x tile of
//     CB input channels; chunk of row tiles). A row tile is kBT time steps of
//     one batch row, so the x elements all its taps need are one contiguous
//     span, x[u0*s + k0 - pad_l ...]. That span is staged once per row tile,
//     channel-last and split by phase ([t mod s][t div s][c], rows padded by
//     8): tap j of row u is then row u + (j - k0) div s of plane
//     (j - k0) mod s, consecutive rows are consecutive u, and an
//     ldmatrix.trans of 8 rows hits 8 distinct bank groups. No element is
//     gathered with a division, and no x element is loaded once per tap.
//   * dy is staged as [o][u] (time-contiguous, as it lies), the A operand
//     of a row-major MMA.
//   * kBT = 128 rows between barriers; each warp owns all OB rows and 32
//     columns (one tap of 32 channels, or two taps of 16): per 16 rows it
//     loads MW + 2 fragments and issues 4*MW mma.sync.
//   * Determinism: each block sums its fixed chunk of row tiles into its own
//     f32 partial slab [Cout, K, cg]; conv_dw_reduce_kernel adds the slabs in
//     chunk order. No atomics.
// ---------------------------------------------------------------------------

constexpr int kBT = 128;  // rows (time steps of one batch row) per staged tile

struct DwParams {  // field order = _DW_FIELDS in ops/grouped_conv.py
  int B, Cin, Cout, Tin, Tout, K, stride, pad_l, G;
  int cg, og, n_otiles, n_ctiles, kt, tiles_per_b, n_rtiles, tiles_per_chunk, V;
};

template <int MW, int CB>
__global__ void __launch_bounds__(kThreads, 2)
conv_dw_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       float* __restrict__ part, const DwParams p) {
  constexpr int OB = MW * 16, XCP = CB + 8, DYP = kBT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dys = reinterpret_cast<bf16*>(smem_raw);  // [OB][DYP]
  bf16* xw = dys + OB * DYP;                        // [s][V][XCP]
  const int s = p.stride;
  const int k0 = blockIdx.x * p.kt;
  const int ct = blockIdx.y % p.n_ctiles;
  const int ot = (blockIdx.y / p.n_ctiles) % p.n_otiles;
  const int g = blockIdx.y / (p.n_ctiles * p.n_otiles);
  const int chunk = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt_begin = chunk * p.tiles_per_chunk;
  const int rt_end = min(p.n_rtiles, rt_begin + p.tiles_per_chunk);
  const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* dyh = reinterpret_cast<const unsigned short*>(dy);

  // The warp's two column pairs (16 columns each): tap, and where its row
  // u = 0 lies in the x window.
  bool pair_ok[2];
  int pair_off[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col0 = warp * 32 + half * 16;
    const int jj = col0 / CB;
    pair_ok[half] = k0 + jj < p.K;
    pair_off[half] = ((jj % s) * p.V + jj / s) * XCP + col0 % CB;
  }
  float acc[MW][4][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int rt = rt_begin; rt < rt_end; ++rt) {
    const int bb = rt / p.tiles_per_b;
    const int u0 = (rt - bb * p.tiles_per_b) * kBT;
    __syncthreads();  // the previous tile is consumed
    // Each thread stages two adjacent rows u of every 4th output channel,
    // then the channels of its x window rows; the loops are unrolled so that
    // loads can be issued ahead of the stores.
    const unsigned short* dyb =
        dyh + ((size_t)bb * p.Cout + (size_t)g * p.og + ot * OB) * p.Tout;
    {
      const int uu = 2 * (threadIdx.x % (kBT / 2)), o0 = threadIdx.x / (kBT / 2);
      const int u = u0 + uu;
#pragma unroll
      for (int i = 0; i < OB / 4; ++i) {
        const int o = o0 + 4 * i;
        const bool ok = ot * OB + o < p.og;
        const unsigned short lo = (ok && u < p.Tout) ? dyb[(size_t)o * p.Tout + u] : 0;
        const unsigned short hi =
            (ok && u + 1 < p.Tout) ? dyb[(size_t)o * p.Tout + u + 1] : 0;
        *reinterpret_cast<uint32_t*>(dys + o * DYP + uu) = pack2(lo, hi);
      }
    }
    const int t_base = u0 * s + k0 - p.pad_l;
    const unsigned short* xb =
        xh + ((size_t)bb * p.Cin + (size_t)g * p.cg + ct * CB) * p.Tin;
    for (int pv = threadIdx.x; pv < s * p.V; pv += kThreads) {
      const int t = t_base + pv;
      const bool in = t >= 0 && t < p.Tin;
      bf16* dst = xw + ((pv % s) * p.V + pv / s) * XCP;
#pragma unroll
      for (int c8 = 0; c8 < CB / 8; ++c8)
        store8(dst + c8 * 8, xb + (size_t)(c8 * 8) * p.Tin + t, p.Tin,
               in ? p.cg - (ct * CB + c8 * 8) : 0);
    }
    __syncthreads();
    const bf16* arow = dys + (lane & 15) * DYP + (lane >> 4) * 8;
    const int brow = ((lane & 7) + ((lane >> 3) & 1) * 8) * XCP + (lane >> 4) * 8;
#pragma unroll 2
    for (int ks = 0; ks < kBT / 16; ++ks) {
      uint32_t a[MW][4];
#pragma unroll
      for (int i = 0; i < MW; ++i)
        ldsm_x4(arow + i * 16 * DYP + ks * 16, a[i][0], a[i][1], a[i][2], a[i][3]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!pair_ok[half]) continue;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(xw + pair_off[half] + ks * 16 * XCP + brow, b0, b1, b2, b3);
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          mma_bf16(acc[i][2 * half], a[i], b0, b1);
          mma_bf16(acc[i][2 * half + 1], a[i], b2, b3);
        }
      }
    }
  }

  float* pc = part + (size_t)chunk * p.Cout * p.K * p.cg;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = ot * OB + i * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = warp * 32 + j * 8 + 2 * (lane & 3) + (e & 1);
        const int tap = k0 + col / CB, c = ct * CB + col % CB;
        if (o < p.og && tap < p.K && c < p.cg)
          pc[((size_t)(g * p.og + o) * p.K + tap) * p.cg + c] = acc[i][j][e];
      }
}

// ---------------------------------------------------------------------------
// dW in f32, CUDA cores. Block = (tap tile of KT taps, group, chunk of the
// flattened batch x time rows). Outputs of the block: M = kt*cg rows (tap,
// input channel) by N = og columns; thread (ty, tx) owns rows ty + NY*i and
// columns tx + NX*j. Rows are staged kBTf at a time: xs[kBTf][M+1] and
// dys[kBTf][N+1] (padded against bank conflicts). Writes the same partial
// slab layout as the bf16 kernel.
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

// dW, second pass: add the chunks' [Cout, K, cg] slabs in chunk order and
// write [Cout, cg, K] in the operand type.
template <typename T>
__global__ void conv_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                                      int n_chunks, int K, int cg, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < n_chunks; ++c) sum += part[(size_t)c * total + i];
    const int c = (int)(i % cg);
    const long long oj = i / cg;
    const int j = (int)(oj % K);
    const long long o = oj / K;
    dw[((size_t)o * cg + c) * K + j] = from_f<T>(sum);
  }
}

template <typename T>
int launch_reduce(const float* part, void* dw, int n_chunks, int Cout, int K, int cg,
                  cudaStream_t stream) {
  const long long total = (long long)Cout * K * cg;
  const long long want = (total + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  conv_dw_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(dw),
                                                       n_chunks, K, cg, total);
  return (int)cudaGetLastError();
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

template <int OB, int CC>
int launch_fwd_bf16(const void* x, const void* wp, void* y, const FwdParams& p, dim3 grid,
                    int smem_bytes, cudaStream_t stream) {
  if (p.bm != FwdTile<OB>::BM) return (int)cudaErrorInvalidValue;
  auto kern = conv_fwd_bf16_kernel<OB, CC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem_bytes, stream>>>(static_cast<const bf16*>(x),
                                               static_cast<const bf16*>(wp),
                                               static_cast<bf16*>(y), p);
  return (int)cudaGetLastError();
}

template <int MTM, int NT, int OC>
int launch_dx(const void* dy, const void* wph, void* dx, const DxParams& p, dim3 grid,
              int smem_bytes, cudaStream_t stream) {
  auto kern = conv_dx_kernel<MTM, NT, OC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem_bytes, stream>>>(static_cast<const bf16*>(dy),
                                               static_cast<const bf16*>(wph),
                                               static_cast<bf16*>(dx), p);
  return (int)cudaGetLastError();
}

template <int MW, int CB>
int launch_dw(const void* x, const void* dy, float* part, const DwParams& p, dim3 grid,
              int smem_bytes, cudaStream_t stream) {
  auto kern = conv_dw_partial_kernel<MW, CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem_bytes, stream>>>(static_cast<const bf16*>(x),
                                               static_cast<const bf16*>(dy), part, p);
  return (int)cudaGetLastError();
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

// bf16 forward. params: the FwdParams fields in order; ob = output channels
// per block (16, 32 or 64), cc = input channels per chunk (16 or 32); wp is
// [G, n_otiles, K, ob, cg_pad].
int grouped_conv1d_fwd_bf16(const void* x, const void* wp, void* y, const int* params,
                            int ob, int cc, int grid_x, int grid_y, int grid_z,
                            int smem_bytes, void* stream) {
  const FwdParams& p = *reinterpret_cast<const FwdParams*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, grid_z);
  if (cc == 16) {
    if (ob == 16) return launch_fwd_bf16<16, 16>(x, wp, y, p, grid, smem_bytes, s);
    if (ob == 32) return launch_fwd_bf16<32, 16>(x, wp, y, p, grid, smem_bytes, s);
    if (ob == 64) return launch_fwd_bf16<64, 16>(x, wp, y, p, grid, smem_bytes, s);
  } else if (cc == 32) {
    if (ob == 16) return launch_fwd_bf16<16, 32>(x, wp, y, p, grid, smem_bytes, s);
    if (ob == 32) return launch_fwd_bf16<32, 32>(x, wp, y, p, grid, smem_bytes, s);
    if (ob == 64) return launch_fwd_bf16<64, 32>(x, wp, y, p, grid, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 dX. params: the DxParams fields in order; nb = input channels per
// block (16 or 32), oc = output channels per chunk (16, 32 or 64).
int grouped_conv1d_dx_bf16(const void* dy, const void* wph, void* dx, const int* params,
                           int nb, int oc, int grid_x, int grid_y, int grid_z,
                           int smem_bytes, void* stream) {
  const DxParams& p = *reinterpret_cast<const DxParams*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, grid_z);
  if (nb == 32) {
    if (oc == 16) return launch_dx<2, 4, 16>(dy, wph, dx, p, grid, smem_bytes, s);
    if (oc == 32) return launch_dx<2, 4, 32>(dy, wph, dx, p, grid, smem_bytes, s);
    if (oc == 64) return launch_dx<2, 4, 64>(dy, wph, dx, p, grid, smem_bytes, s);
  } else if (nb == 16) {
    if (oc == 16) return launch_dx<4, 2, 16>(dy, wph, dx, p, grid, smem_bytes, s);
    if (oc == 32) return launch_dx<4, 2, 32>(dy, wph, dx, p, grid, smem_bytes, s);
    if (oc == 64) return launch_dx<4, 2, 64>(dy, wph, dx, p, grid, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 dW. params: the DwParams fields in order; ob = output channels per
// block (16, 32 or 64), cb = input channels per block (16 or 32). part: f32
// scratch of n_chunks * Cout * K * cg; dw: [Cout, cg, K] bf16.
int grouped_conv1d_dw_bf16(const void* x, const void* dy, void* part, void* dw,
                           const int* params, int ob, int cb, int grid_x, int grid_y,
                           int n_chunks, int smem_bytes, void* stream) {
  const DwParams& p = *reinterpret_cast<const DwParams*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  const dim3 grid(grid_x, grid_y, n_chunks);
  int err = (int)cudaErrorInvalidValue;
  if (cb == 32) {
    if (ob == 16) err = launch_dw<1, 32>(x, dy, pt, p, grid, smem_bytes, s);
    if (ob == 32) err = launch_dw<2, 32>(x, dy, pt, p, grid, smem_bytes, s);
    if (ob == 64) err = launch_dw<4, 32>(x, dy, pt, p, grid, smem_bytes, s);
  } else if (cb == 16) {
    if (ob == 16) err = launch_dw<1, 16>(x, dy, pt, p, grid, smem_bytes, s);
    if (ob == 32) err = launch_dw<2, 16>(x, dy, pt, p, grid, smem_bytes, s);
    if (ob == 64) err = launch_dw<4, 16>(x, dy, pt, p, grid, smem_bytes, s);
  }
  if (err != 0) return err;
  return launch_reduce<bf16>(pt, dw, n_chunks, p.Cout, p.K, p.cg, s);
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
  return launch_reduce<float>(pt, dw, n_chunks, Cout, K, Cin / G, s);
}

}  // extern "C"
