// Grouped 1-D convolution for Hopper (sm_90a): forward (also used for the
// data gradient) and weight gradient, CUDA C++ behind a plain C interface.
//
// Replaces the Pallas TPU kernels of ste_gan_tpu/ops/pallas_conv.py:
//   * conv_fwd_kernel    <- _fwd_kernel (:147-155) via _run_fwd (:189-208),
//                           and the dX pass of _conv_core_bwd (:282-304),
//                           which reruns the forward on stride-dilated dy
//                           with tap-flipped, in/out-transposed weights;
//   * conv_dw_partial_kernel + conv_dw_reduce_kernel
//                        <- _dw_kernel (:158-174) via _run_dw (:211-234).
//
// Layout is PyTorch's: x [B, Cin, Tin], y [B, Cout, Tout]; output channels
// form G consecutive blocks of og = Cout/G. The forward takes its weights
// arranged as [G, K, Cin/G, og] (the wrapper permutes PyTorch's
// [Cout, Cin/G, K], a copy of under a megabyte), so that staging them is a
// contiguous read; the weight gradient is written as [Cout, Cin/G, K]. Operands are f32 or
// bf16; every sum is accumulated in f32 and the result is written in the
// operand type.
//
// What bounds it: at the scale discriminators' shapes (K 37, 16-32 input
// channels per group) a forward does ~2.4k FLOP per output element on a few
// bytes of input, so it is bound by arithmetic, not by device memory. This
// first version does the arithmetic on the CUDA cores in f32 (no tensor
// cores), so its bound is far below the card's bf16 peak. The design keeps
// the operands in shared memory: each block stages the input window of one
// (batch row, time tile, group) once and streams that group's weights through
// shared memory a few taps at a time, and every thread accumulates a 4x4 tile
// of (time, channel) outputs in registers. The TPU kernel's block-diagonal
// slab (padding groups up to the MXU's 128 lanes) is not carried over: each
// block computes its own group only.
//
// The weight gradient reduces over batch x time, which the TPU ran as a
// sequential grid. Here each block sums its own slice of batch x time into a
// partial [Cout, Cin/G, K] slab and a second kernel adds the slabs in a fixed
// order, so the result is deterministic (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // time rows per thread (forward)
constexpr int kTN = 4;  // output channels per thread (forward)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Forward. Block = (time tile of BM outputs, group x channel tile of BN, batch
// row). The input window of the tile ([cg][win_len] floats) is staged once;
// weights are staged kt taps at a time as [kt][cg][BN].
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                int Tin, int Cin, int K, int Cout, int stride, int pad_l, int G,
                int Tout, int KT, int win_len, int win_stride) {
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

  const T* xb = x + ((size_t)b * Cin + (size_t)g * cg) * Tin;
  const int base = t0 * stride - pad_l;
  for (int i = threadIdx.x; i < cg * win_len; i += kThreads) {
    const int c = i / win_len, r = i - c * win_len;
    const int t = base + r;
    win[c * win_stride + r] = (t >= 0 && t < Tin) ? to_f(xb[(size_t)c * Tin + t]) : 0.f;
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
    const T* wg = w + ((size_t)g * K + k0) * cg * og;
    for (int i = threadIdx.x; i < kt * cg * BN; i += kThreads) {
      const int row = i / BN, n = i - row * BN;  // row = kk * cg + c
      const int o = n0 + n;
      ws[row * BN + n] = (o < og) ? to_f(wg[(size_t)row * og + o]) : 0.f;
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
    T* yr = y + ((size_t)b * Cout + (size_t)g * og + o) * Tout;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int t = t0 + ty * kTM + i;
      if (t < Tout) yr[t] = from_f<T>(acc[i][j]);
    }
  }
}

// Weight gradient, first pass. Block = (tap tile of KT taps, group, chunk of
// the flattened batch x time rows). Outputs of the block: M = kt*cg rows
// (tap, input channel) by N = og columns; thread (ty, tx) owns rows
// ty + NY*i and columns tx + NX*j. Rows of batch x time are staged BT at a
// time: xs[BT][M+1] and dys[BT][N+1] (rows padded against bank conflicts);
// the (batch, time) of each staged row is computed once per tile.
constexpr int kBT = 32;
constexpr int kDwT = 4;  // max rows/columns per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
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
  float* xs = smem;                          // [kBT][xs_ld]
  float* dys = smem + kBT * (KT * cg + 1);   // [kBT][dys_ld]
  __shared__ int row_b[kBT], row_t[kBT];

  const long long R = (long long)B * Tout;
  const long long r_begin = (long long)chunk * rows_per_chunk;
  const long long r_end = min(R, r_begin + rows_per_chunk);

  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  float acc[kDwT][kDwT];
#pragma unroll
  for (int i = 0; i < kDwT; ++i)
#pragma unroll
    for (int j = 0; j < kDwT; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kBT) {
    __syncthreads();
    if (threadIdx.x < kBT) {
      const long long r = r0 + threadIdx.x;
      const int bb = r < r_end ? (int)(r / Tout) : -1;
      row_b[threadIdx.x] = bb;
      row_t[threadIdx.x] = bb < 0 ? 0 : (int)(r - (long long)bb * Tout);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBT * M; i += kThreads) {
      const int c = i / (kBT * kt);
      const int rem = i - c * kBT * kt;
      const int rt = rem / kt, kk = rem - rt * kt;
      const int bb = row_b[rt];
      const int ti = row_t[rt] * stride + k0 + kk - pad_l;
      float v = 0.f;
      if (bb >= 0 && ti >= 0 && ti < Tin)
        v = to_f(x[((size_t)bb * Cin + (size_t)g * cg + c) * Tin + ti]);
      xs[rt * xs_ld + kk * cg + c] = v;
    }
    for (int i = threadIdx.x; i < kBT * N; i += kThreads) {
      const int n = i / kBT, rt = i - n * kBT;
      const int bb = row_b[rt];
      dys[rt * dys_ld + n] =
          bb >= 0 ? to_f(dy[((size_t)bb * Cout + (size_t)g * og + n) * Tout + row_t[rt]])
                  : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rt = 0; rt < kBT; ++rt) {
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

  float* pc = part + (size_t)chunk * Cout * cg * K;
#pragma unroll
  for (int i = 0; i < kDwT; ++i) {
    const int m = ty + NY * i;
    if (m >= M) continue;
    const int kk = m / cg, c = m - kk * cg;
#pragma unroll
    for (int j = 0; j < kDwT; ++j) {
      const int n = tx + NX * j;
      if (n >= N) continue;
      pc[((size_t)(g * og + n) * cg + c) * K + k0 + kk] = acc[i][j];
    }
  }
}

// Weight gradient, second pass: add the chunks' slabs in a fixed order.
template <typename T>
__global__ void conv_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                                      int n_chunks, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * total + i];
    dw[i] = from_f<T>(s);
  }
}

template <typename T, int BN>
int launch_fwd(const void* x, const void* w, void* y, int B, int Tin, int Cin, int K,
               int Cout, int stride, int pad_l, int G, int Tout, int KT, int win_len,
               int win_stride, int smem_bytes, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  auto kern = conv_fwd_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int og = Cout / G;
  dim3 grid((Tout + BM - 1) / BM, G * ((og + BN - 1) / BN), B);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), Tin,
      Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int bn, const void* x, const void* w, void* y, int B, int Tin, int Cin,
                 int K, int Cout, int stride, int pad_l, int G, int Tout, int KT,
                 int win_len, int win_stride, int smem_bytes, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_fwd<T, 16>(x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride, smem_bytes, s);
    case 32: return launch_fwd<T, 32>(x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride, smem_bytes, s);
    case 64: return launch_fwd<T, 64>(x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout, KT, win_len, win_stride, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dw(const void* x, const void* dy, float* part, void* dw, int B, int Tin,
              int Cin, int K, int Cout, int stride, int pad_l, int G, int Tout, int KT,
              int NX, int n_chunks, int rows_per_chunk, int smem_bytes,
              cudaStream_t stream) {
  auto kern = conv_dw_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((K + KT - 1) / KT, G, n_chunks);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, B, Tin, Cin, K, Cout,
      stride, pad_l, G, Tout, KT, NX, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)Cout * (Cin / G) * K;
  const long long want = (total + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  conv_dw_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(dw),
                                                       n_chunks, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int grouped_conv1d_fwd(const void* x, const void* w, void* y, int dtype, int bn,
                       int B, int Tin, int Cin, int K, int Cout, int stride,
                       int pad_l, int G, int Tout, int KT, int win_len,
                       int win_stride, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float>(bn, x, w, y, B, Tin, Cin, K, Cout, stride, pad_l, G,
                               Tout, KT, win_len, win_stride, smem_bytes, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(bn, x, w, y, B, Tin, Cin, K, Cout, stride,
                                       pad_l, G, Tout, KT, win_len, win_stride,
                                       smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// part: f32 scratch of n_chunks * Cout * (Cin/G) * K; dw in the operand type.
int grouped_conv1d_dw(const void* x, const void* dy, void* part, void* dw, int dtype,
                      int B, int Tin, int Cin, int K, int Cout, int stride, int pad_l,
                      int G, int Tout, int KT, int NX, int n_chunks,
                      int rows_per_chunk, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch_dw<float>(x, dy, p, dw, B, Tin, Cin, K, Cout, stride, pad_l, G, Tout,
                            KT, NX, n_chunks, rows_per_chunk, smem_bytes, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, dy, p, dw, B, Tin, Cin, K, Cout, stride, pad_l,
                                    G, Tout, KT, NX, n_chunks, rows_per_chunk,
                                    smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
