// Zero-phase IIR filter cascades over a batch of f64 rows for Hopper
// (sm_90a), CUDA C++ behind a plain C interface.
//
// Not a TPU kernel: the JAX package filters EMG on the host with
// scipy.signal.filtfilt (ste_gan_tpu/etl/emg_dsp.py:31-46, notch harmonics
// and drift removal; :139-141, the Hilbert envelope's low-pass). An IIR
// filter is a chain of dependent steps, which eager PyTorch would run at
// one launch (or several) per sample, so the port runs the cascade here.
//
// For every row r, with its samples at [P, P + len[r]) of a row-major
// buffer (row r at buf[r * width], width even), and for each stage s in
// order, with coefficients b, a (a[0] == 1), steady-state initial state zi
// and padding p = padlen[s] (scipy's filtfilt defaults, method "pad"):
//
//   odd extension:  x[P - p + i]   = 2 x[P] - x[P + p - i]          i < p
//                   x[P + n + j]   = 2 x[P + n - 1] - x[P + n - 2 - j]
//   forward pass over [P - p, P + n + p) from z = zi * x[P - p],
//   backward pass over the same span, last to first, from z = zi * y[end],
//
// each pass scipy's lfilter in transposed direct form II:
//   y = z[0] + b[0] x;  z[k] = z[k + 1] + x b[k + 1] - y a[k + 1];
//   z[N - 2] = x b[N - 1] - y a[N - 1].
// The stage's result is left in [P, P + n) for the next stage.
//
// Everything stays f64: the 2 Hz drift high-pass at 1 kHz has poles within
// ~1.3e-2 of the unit circle, and in f32 its output would drift from
// scipy's f64 result. The arithmetic uses explicit roundings (__dmul_rn,
// __dadd_rn, __dsub_rn), so nvcc contracts nothing into an FMA and every
// step rounds as scipy's C loop does: the kernel equals
// scipy.signal.filtfilt bit for bit, and its plain PyTorch version too.
//
// What bounds it: not bytes (a row is read and written once, 16 bytes a
// sample) nor operations (~10 f64 operations a sample and pass), but the
// chain: every output needs the previous one's state, three dependent f64
// operations a sample and pass (y = z0 + b0 x; y a1; z1' - y a1), and each
// pass starts from the end of the pass before it (a stage's backward pass
// from its forward pass's last output, the next stage from the backward
// pass's last output and its odd extension). Reordering the passes or
// scanning a pass in parallel would round otherwise, so a row is one chain
// of 3 * 2 * sum over stages of (n + 2p) operations. latency_probe_kernel
// (probe.cu) measures one dependent f64 operation on an H100 80GB HBM3 at
// 8.03 cycles, so 8 rows of 15,000 samples through the eight-stage
// cascade (240,300 samples a row) are bounded by 2.93 ms at 1.98 GHz;
// chip_smoke.py prints each case's bound. The rows are independent, and
// the kernel runs them side by side, one block each.
//
// The design keeps everything but the three operations off the chain: one
// block per row; the stage's order is a template argument, the state lives
// in registers, and the pass's samples are read a window of kWindow ahead
// of the chain from shared memory, so no load waits on memory. What is
// left beside the chain is its own issue: a 3-tap stage's sample is ~9 f64
// instructions, at two cycles each on one scheduler. Two variants of one
// kernel template:
//   * resident (width * 8 bytes within the 227 KB a block may hold): one
//     bulk copy (cp.async.bulk, TMA 1-D) stages the whole padded row in
//     shared memory; every odd extension and all 2S passes run there in
//     place; one bulk copy writes the row back;
//   * streamed (longer rows): each pass streams the row through a ring of
//     kSlots chunks; a producer thread keeps the bulk loads kSlots chunks
//     ahead against mbarriers, the consumer thread runs the chain from the
//     ring and stores its outputs to global memory, where the next pass
//     (in the other direction) streams them in again.
// The wrapper (ops/iir.py plan_filtfilt) picks the variant from the width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Resident: one warp a block, so that the blocks on an SM spread their
// chains over its four schedulers. Streamed: warp 0 consumes, warp 1
// produces.
constexpr int kResidentThreads = 32, kStreamThreads = 64;
constexpr int kMaxTaps = 8;       // filter order up to 7
constexpr int kWindow = 16;       // samples read ahead of the chain
constexpr int kChunk = 2048;      // f64 per ring slot (streamed)
constexpr int kSlots = 4;         // ring slots (streamed)
constexpr int kResidentHeader = 16;   // the mbarrier, 16-byte aligned
constexpr int kStreamHeader = 128;    // 2 * kSlots mbarriers, padded
constexpr int kMaxSmem = 232448;      // a block's shared memory on Hopper

// ---- PTX: mbarriers, bulk copies, proxy fences ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` on `bar` (16-byte aligned, bytes % 16 == 0)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, waited for before returning
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's global stores before later bulk loads of them.
__device__ __forceinline__ void global_to_async_fence() {
  __threadfence();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- The recurrence ----

template <int N>
struct Lfilter {
  double b[N], a[N], zi[N - 1], z[N - 1];

  __device__ __forceinline__ void load(const double* coefs) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      b[k] = coefs[k];
      a[k] = coefs[kMaxTaps + k];
    }
#pragma unroll
    for (int k = 0; k < N - 1; ++k) zi[k] = coefs[2 * kMaxTaps + k];
  }

  __device__ __forceinline__ void start(double x0) {
#pragma unroll
    for (int k = 0; k < N - 1; ++k) z[k] = __dmul_rn(zi[k], x0);
  }

  // Explicit roundings, no FMA contraction: scipy's order, bit for bit.
  __device__ __forceinline__ double step(double x) {
    const double y = __dadd_rn(z[0], __dmul_rn(b[0], x));
#pragma unroll
    for (int k = 0; k < N - 2; ++k)
      z[k] = __dsub_rn(__dadd_rn(z[k + 1], __dmul_rn(x, b[k + 1])),
                       __dmul_rn(y, a[k + 1]));
    z[N - 2] = __dsub_rn(__dmul_rn(x, b[N - 1]), __dmul_rn(y, a[N - 1]));
    return y;
  }
};

// `count` steps over src[0], src[D], src[2D], ..., outputs to dst[D * i]
// (dst may be src). The next window is loaded before the current one runs,
// so the loads stay off the chain.
template <int N, int D>
__device__ __forceinline__ void run(Lfilter<N>& f, const double* src,
                                    double* dst, int count) {
  int i = 0;
  if (count >= kWindow) {
    double cur[kWindow];
#pragma unroll
    for (int u = 0; u < kWindow; ++u) cur[u] = src[D * u];
    for (; i + 2 * kWindow <= count; i += kWindow) {
      double nxt[kWindow];
#pragma unroll
      for (int u = 0; u < kWindow; ++u) nxt[u] = src[D * (i + kWindow + u)];
#pragma unroll
      for (int u = 0; u < kWindow; ++u) dst[D * (i + u)] = f.step(cur[u]);
#pragma unroll
      for (int u = 0; u < kWindow; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < kWindow; ++u) dst[D * (i + u)] = f.step(cur[u]);
    i += kWindow;
  }
  for (; i < count; ++i) dst[D * i] = f.step(src[D * i]);
}

// The odd extension of one stage around [p0, p0 + n) of `row`.
__device__ __forceinline__ void odd_extension(double* row, int p0, int n,
                                              int pad) {
  const double left = row[p0];
  const double right = row[p0 + n - 1];
  for (int i = 0; i < pad; ++i) {
    row[p0 - pad + i] = __dsub_rn(2.0 * left, row[p0 + pad - i]);
    row[p0 + n + i] = __dsub_rn(2.0 * right, row[p0 + n - 2 - i]);
  }
}

// Resident: one stage in place on the row in shared memory.
template <int N>
__device__ __forceinline__ void resident_stage(double* row, int p0, int n, int pad,
                               const double* coefs) {
  odd_extension(row, p0, n, pad);
  Lfilter<N> f;
  f.load(coefs);
  const int lo = p0 - pad, count = n + 2 * pad;
  f.start(row[lo]);
  run<N, 1>(f, row + lo, row + lo, count);
  double* last = row + lo + count - 1;
  f.start(*last);
  run<N, -1>(f, last, last, count);
}

// Streamed: the consumer's side of one pass over [lo, hi), direction D,
// its chunks arriving in ring slots seq, seq + 1, ... (chunk c holds the
// row's [c * kChunk, (c + 1) * kChunk)).
template <int N, int D>
__device__ __forceinline__ void stream_pass(double* grow, const double* ring, uint64_t* full,
                            uint64_t* empty, uint32_t seq, int lo, int hi,
                            const double* coefs) {
  Lfilter<N> f;
  f.load(coefs);
  const int first = D > 0 ? lo : hi - 1;
  const int c_first = first / kChunk;
  const int c_last = (D > 0 ? hi - 1 : lo) / kChunk;
  int t = first;  // the next position to filter
  for (int c = c_first, q = 0; D > 0 ? c <= c_last : c >= c_last;
       c += D, ++q) {
    const uint32_t k = seq + q, slot = k % kSlots;
    mbar_wait(&full[slot], (k / kSlots) & 1);
    const double* chunk = ring + slot * kChunk;
    const int base = c * kChunk;
    if (q == 0) f.start(chunk[t - base]);
    // One past the last position of this chunk in the pass's direction.
    const int end = D > 0 ? min(hi, base + kChunk) : max(lo, base) - 1;
    run<N, D>(f, chunk + (t - base), grow + t, D * (end - t));
    t = end;
    mbar_arrive(&empty[slot]);
  }
}

template <int N>
__device__ __forceinline__ void stream_stage_pass(int dir, double* grow, const double* ring,
                                  uint64_t* full, uint64_t* empty,
                                  uint32_t seq, int lo, int hi,
                                  const double* coefs) {
  if (dir > 0)
    stream_pass<N, 1>(grow, ring, full, empty, seq, lo, hi, coefs);
  else
    stream_pass<N, -1>(grow, ring, full, empty, seq, lo, hi, coefs);
}

template <bool kStreamed>
__global__ void __launch_bounds__(kStreamThreads)
filtfilt_kernel(double* __restrict__ buf, const int32_t* __restrict__ lengths,
                const double* __restrict__ coefs,
                const int32_t* __restrict__ taps,
                const int32_t* __restrict__ padlens, int width, int p0,
                int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  double* grow = buf + (int64_t)blockIdx.x * width;
  const int n = lengths[blockIdx.x];

  if constexpr (!kStreamed) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    double* row = reinterpret_cast<double*>(smem + kResidentHeader);
    if (threadIdx.x != 0) return;
    mbar_init(bar, 1);
    mbar_init_fence();
    const uint32_t bytes = (uint32_t)width * 8u;
    mbar_expect_tx(bar, bytes);
    bulk_load(row, grow, bytes, bar);
    mbar_wait(bar, 0);
    for (int s = 0; s < stages; ++s) {
      const double* c = coefs + (int64_t)s * 3 * kMaxTaps;
      const int pad = padlens[s];
      switch (taps[s]) {
        case 2: resident_stage<2>(row, p0, n, pad, c); break;
        case 3: resident_stage<3>(row, p0, n, pad, c); break;
        case 4: resident_stage<4>(row, p0, n, pad, c); break;
        case 5: resident_stage<5>(row, p0, n, pad, c); break;
        case 6: resident_stage<6>(row, p0, n, pad, c); break;
        case 7: resident_stage<7>(row, p0, n, pad, c); break;
        case 8: resident_stage<8>(row, p0, n, pad, c); break;
        default: break;  // the wrapper admits 2-8 taps only
      }
    }
    bulk_store(grow, row, bytes);
  } else {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kSlots;
    const double* ring = reinterpret_cast<const double*>(smem + kStreamHeader);
    const bool consumer = threadIdx.x == 0, producer = threadIdx.x == 32;
    if (consumer) {
      for (int i = 0; i < kSlots; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 1);
      }
      mbar_init_fence();
    }
    __syncthreads();
    uint32_t seq = 0;  // chunks through the ring so far, counted alike by both
    for (int s = 0; s < stages; ++s) {
      const double* c = coefs + (int64_t)s * 3 * kMaxTaps;
      const int pad = padlens[s];
      const int lo = p0 - pad, hi = p0 + n + pad;
      if (consumer) {
        odd_extension(grow, p0, n, pad);
        global_to_async_fence();
      }
      __syncthreads();
      for (int dir = 1; dir >= -1; dir -= 2) {
        const int first = (dir > 0 ? lo : hi - 1) / kChunk;
        const int last = (dir > 0 ? hi - 1 : lo) / kChunk;
        const int chunks = dir * (last - first) + 1;
        if (producer) {
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          for (int q = 0; q < chunks; ++q) {
            const uint32_t k = seq + q, slot = k % kSlots, use = k / kSlots;
            if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
            const int begin = (first + dir * q) * kChunk;
            const uint32_t bytes = 8u * (uint32_t)min(kChunk, width - begin);
            mbar_expect_tx(&full[slot], bytes);
            bulk_load(const_cast<double*>(ring) + slot * kChunk, grow + begin,
                      bytes, &full[slot]);
          }
        } else if (consumer) {
          switch (taps[s]) {
            case 2: stream_stage_pass<2>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            case 3: stream_stage_pass<3>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            case 4: stream_stage_pass<4>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            case 5: stream_stage_pass<5>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            case 6: stream_stage_pass<6>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            case 7: stream_stage_pass<7>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            case 8: stream_stage_pass<8>(dir, grow, ring, full, empty, seq, lo, hi, c); break;
            default: break;
          }
          global_to_async_fence();
        }
        seq += chunks;
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" {

// buf [rows, width] f64 row-major (row r's samples at [p0, p0 +
// lengths[r]), width even), lengths [rows] int32, coefs [stages, 3, 8] f64
// (b, a, zi, zero-padded), taps [stages] and padlens [stages] int32: device
// pointers, contiguous, buf 16-byte aligned. Requires p0 >= max(padlens)
// and p0 + lengths[r] + p0 <= width. streamed 0 stages the whole row in
// shared memory (16 + 8 * width bytes, at most 232,448), 1 streams it
// through the ring. Returns cudaGetLastError() after the launch.
int filtfilt_cascade(void* buf, const void* lengths, const void* coefs,
                     const void* taps, const void* padlens, int rows,
                     int width, int p0, int stages, int streamed,
                     void* stream) {
  if (rows <= 0 || stages <= 0 || p0 < 0 || width <= 0 || (width & 1))
    return (int)cudaErrorInvalidValue;
  const long long smem = streamed
      ? kStreamHeader + 8LL * kSlots * kChunk
      : kResidentHeader + 8LL * width;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = streamed ? &filtfilt_kernel<true> : &filtfilt_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = streamed ? kStreamThreads : kResidentThreads;
  kernel<<<rows, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(buf), static_cast<const int32_t*>(lengths),
      static_cast<const double*>(coefs), static_cast<const int32_t*>(taps),
      static_cast<const int32_t*>(padlens), width, p0, stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
