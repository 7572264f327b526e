// Zero-phase IIR filter cascades over a batch of f64 rows for Hopper
// (sm_90a), CUDA C++ behind a plain C interface.
//
// Not a TPU kernel: the JAX package filters EMG on the host with
// scipy.signal.filtfilt (ste_gan_tpu/etl/emg_dsp.py:31-46, notch harmonics
// and drift removal; :139-141, the Hilbert envelope's low-pass). An IIR
// filter is a chain of dependent steps, which eager PyTorch would run at
// one launch (or several) per sample, so the port runs the cascade here.
//
// For every row r, with its samples at [P, P + len[r]) of a time-major
// buffer (element (t, r) at buf[t * rows + r]), and for each stage s in
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
// scipy's f64 result. The H100 runs f64 at full rate.
//
// The arithmetic uses explicit roundings (__dmul_rn, __dadd_rn, __dsub_rn),
// so nvcc contracts nothing into an FMA and every step rounds as scipy's C
// loop does: the kernel equals scipy.signal.filtfilt bit for bit, and its
// plain PyTorch version on the CPU as well.
//
// What bounds it: not bytes (each sample is read and written twice per
// stage, ~32 bytes and ~4N flops) but the chain of dependent steps: every
// output needs the previous one's state, three dependent f64 operations per
// sample and pass (y = z0 + b0 x; y a1; z1' - y a1), so one row takes
// 3 * 2 * sum over stages of (n + 2p) dependent operations. The design is
// the simple one: one thread walks one row through every stage (rows side
// by side, so a warp serves 32 rows), the state lives in registers (the
// stage's order is a template argument), and the samples are read eight at
// a time ahead of the chain so that one memory latency covers eight steps.
// The row stays in global memory (L2 for an utterance); a shared-memory or
// several-threads-per-row scheme is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 8;  // filter order up to 7
constexpr int kChunk = 8;    // samples read ahead of the dependency chain

// One lfilter pass over [lo, hi) in place, forward (dir 1) or backward
// (dir -1), from the state zi * (first sample of the pass).
template <int N>
__device__ void lfilter_pass(double* buf, int64_t rows, int64_t r, int lo,
                             int hi, int dir, const double* b, const double* a,
                             const double* zi) {
  double bb[N], aa[N], z[N - 1];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    bb[k] = b[k];
    aa[k] = a[k];
  }
  const int count = hi - lo;
  const int first = dir > 0 ? lo : hi - 1;
  const double x0 = buf[first * rows + r];
#pragma unroll
  for (int k = 0; k < N - 1; ++k) z[k] = __dmul_rn(zi[k], x0);

  for (int base = 0; base < count; base += kChunk) {
    double xs[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = first + dir * (base + i);
      xs[i] = (base + i < count) ? buf[t * rows + r] : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (base + i < count) {
        // Explicit roundings, no FMA contraction: scipy's order, bit for
        // bit.
        const double x = xs[i];
        const double y = __dadd_rn(z[0], __dmul_rn(bb[0], x));
#pragma unroll
        for (int k = 0; k < N - 2; ++k)
          z[k] = __dsub_rn(__dadd_rn(z[k + 1], __dmul_rn(x, bb[k + 1])),
                           __dmul_rn(y, aa[k + 1]));
        z[N - 2] = __dsub_rn(__dmul_rn(x, bb[N - 1]), __dmul_rn(y, aa[N - 1]));
        buf[(first + dir * (base + i)) * rows + r] = y;
      }
    }
  }
}

template <int N>
__device__ void filtfilt_stage(double* buf, int64_t rows, int64_t r, int p0,
                               int n, int pad, const double* coefs) {
  const double* b = coefs;
  const double* a = coefs + kMaxTaps;
  const double* zi = coefs + 2 * kMaxTaps;
  const double left = buf[(int64_t)p0 * rows + r];
  const double right = buf[(int64_t)(p0 + n - 1) * rows + r];
  for (int i = 0; i < pad; ++i) {
    buf[(int64_t)(p0 - pad + i) * rows + r] =
        __dsub_rn(2.0 * left, buf[(int64_t)(p0 + pad - i) * rows + r]);
    buf[(int64_t)(p0 + n + i) * rows + r] =
        __dsub_rn(2.0 * right, buf[(int64_t)(p0 + n - 2 - i) * rows + r]);
  }
  lfilter_pass<N>(buf, rows, r, p0 - pad, p0 + n + pad, 1, b, a, zi);
  lfilter_pass<N>(buf, rows, r, p0 - pad, p0 + n + pad, -1, b, a, zi);
}

__global__ void __launch_bounds__(kThreads)
filtfilt_kernel(double* __restrict__ buf, const int32_t* __restrict__ lengths,
                const double* __restrict__ coefs, const int32_t* __restrict__ taps,
                const int32_t* __restrict__ padlens, int rows, int p0, int stages) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int n = lengths[r];
  for (int s = 0; s < stages; ++s) {
    const double* c = coefs + (int64_t)s * 3 * kMaxTaps;
    const int pad = padlens[s];
    switch (taps[s]) {
      case 2: filtfilt_stage<2>(buf, rows, r, p0, n, pad, c); break;
      case 3: filtfilt_stage<3>(buf, rows, r, p0, n, pad, c); break;
      case 4: filtfilt_stage<4>(buf, rows, r, p0, n, pad, c); break;
      case 5: filtfilt_stage<5>(buf, rows, r, p0, n, pad, c); break;
      case 6: filtfilt_stage<6>(buf, rows, r, p0, n, pad, c); break;
      case 7: filtfilt_stage<7>(buf, rows, r, p0, n, pad, c); break;
      case 8: filtfilt_stage<8>(buf, rows, r, p0, n, pad, c); break;
      default: break;  // the wrapper admits 2-8 taps only
    }
  }
}

}  // namespace

extern "C" {

// buf [T, rows] f64 time-major (row r's samples at [p0, p0 + lengths[r])),
// lengths [rows] int32, coefs [stages, 3, 8] f64 (b, a, zi, zero-padded),
// taps [stages] and padlens [stages] int32: device pointers, contiguous.
// Requires p0 >= max(padlens) and lengths[r] > padlens[s]. Returns
// cudaGetLastError() after the launch.
int filtfilt_cascade(void* buf, const void* lengths, const void* coefs,
                     const void* taps, const void* padlens, int rows, int p0,
                     int stages, void* stream) {
  if (rows <= 0 || stages <= 0 || p0 < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kThreads - 1) / kThreads;
  filtfilt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(buf), static_cast<const int32_t*>(lengths),
      static_cast<const double*>(coefs), static_cast<const int32_t*>(taps),
      static_cast<const int32_t*>(padlens), rows, p0, stages);
  return (int)cudaGetLastError();
}

}  // extern "C"
