// Latency probe for Hopper (sm_90a), CUDA C++ behind a plain C interface.
//
// Not a port of any kernel: it measures, with clock64(), the latencies that
// bound the two recurrence kernels (iir.cu, dtw.cu), so that their
// dependency-chain bounds rest on this card's own numbers:
//
//   0. one dependent f64 operation, alternating __dadd_rn, __dmul_rn and
//      __dsub_rn as on filtfilt_kernel's chain (y = z0 + b0 x; y a1;
//      z1' - y a1), in cycles per operation;
//   1. one DTW cell step, fminf, fminf and __fadd_rn on f32 as on
//      dtw_align_kernel's wavefront (v = c + min(min(up, left), diag)),
//      in cycles per step (three operations);
//   2. one dependent shared-memory load (pointer chasing through a ring of
//      indices), the backtrace's step, in cycles per load.
//
// One thread runs each loop; the loops are unrolled so that the counter
// and the branch stay off the chain. Results go to out[0..2] as f64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kRing = 1024;  // indices of the pointer-chasing ring

__global__ void latency_probe_kernel(const double* __restrict__ seeds,
                                     double* __restrict__ out, int iters) {
  __shared__ int ring[kRing];
  for (int i = threadIdx.x; i < kRing; i += blockDim.x)
    ring[i] = (i * 37 + 11) % kRing;  // 37 = 1 mod 4, 11 odd: one cycle
  __syncthreads();
  if (threadIdx.x != 0) return;

  // f64: y = c2 - (y + c0) * c1 stays bounded for |c1| < 1.
  double y = seeds[0];
  const double c0 = seeds[1], c1 = seeds[2], c2 = seeds[3];
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y = __dsub_rn(c2, __dmul_rn(__dadd_rn(y, c0), c1));
  }
  long long t1 = clock64();
  out[0] = (double)(t1 - t0) / (3.0 * kUnroll * iters);

  // f32: v = c + min(min(v, a), b).
  float v = (float)seeds[4];
  const float a = (float)seeds[5], b = (float)seeds[6], c = (float)seeds[7];
  t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v = __fadd_rn(c, fminf(fminf(v, a), b));
  }
  t1 = clock64();
  out[1] = (double)(t1 - t0) / ((double)kUnroll * iters);

  // Shared memory: j = ring[j].
  int j = (int)seeds[8] & (kRing - 1);
  t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) j = ring[j];
  }
  t1 = clock64();
  out[2] = (double)(t1 - t0) / ((double)kUnroll * iters);
  // Keep every chain live.
  out[3] = y + (double)v + (double)j;
}

}  // namespace

extern "C" {

// seeds [9] f64, out [4] f64 (cycles per f64 operation, per f32 cell step,
// per shared-memory load; a checksum): device pointers. Returns
// cudaGetLastError() after the launch.
int latency_probe(const void* seeds, void* out, int iters, void* stream) {
  if (iters <= 0) return (int)cudaErrorInvalidValue;
  latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(seeds), static_cast<double*>(out), iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
