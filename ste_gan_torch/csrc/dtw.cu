// Batched monotonic DTW alignment for Hopper (sm_90a), CUDA C++ behind a
// plain C interface.
//
// Not a TPU kernel: the JAX package computes this alignment with jax.lax
// inside its jitted encoder step (ste_gan_tpu/ops/dtw.py:36-100, vmapped
// over the silent slots in ste_gan_tpu/train/encoder.py:136-186): an
// anti-diagonal wavefront lax.scan for the DP and a lax.while_loop for the
// backtrace. Eager PyTorch would pay ~10 launches per anti-diagonal and a
// host wait per backtrace step, so the port runs both here.
//
// For every slot s, with end cell (ei, ej) = ends[s] and lt = ei + 1,
// lp = ej + 1 (the valid block of the padded [T1, T2] costs):
//
//   dtw[0][0] = 0, dtw[0][j>0] = dtw[i>0][0] = inf,
//   dtw[i][j] = costs[i][j] + min(min(up, left), diag)            (f32)
//   walk from (ei, ej) while i > 0 and j > 0: out[i] = j; step to the
//   first minimal predecessor in the order up, left, diag.
//
// min is exact and the add is one rounding, so the DP equals the JAX
// version bit for bit and the alignment is identical.
//
// What bounds it: not bytes (each valid cell reads one cost and writes and
// reads back one DP value, 12 bytes, ~3 ops) but the dependency chain:
// lt + lp - 1 anti-diagonals, each behind a barrier, then a serial walk of
// up to lt + lp steps. The design keeps the chain short and everything else
// off it: one block per slot, so slots run side by side on the SMs; the
// block's threads stride over the cells of one anti-diagonal, with
// __syncthreads() between diagonals; the DP goes to a global f32 scratch
// (268 KB per slot at 259 x 259, L2-resident), and only the valid block is
// touched; one thread then walks the backtrace. No gradient is needed: the
// alignment is gradient-stopped.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dtw_align_kernel(const float* __restrict__ costs, const int32_t* __restrict__ ends,
                 float* __restrict__ dp, int32_t* __restrict__ out, int t1, int t2) {
  const int64_t slot = blockIdx.x;
  const float* c = costs + slot * t1 * t2;
  float* d = dp + slot * t1 * t2;
  int32_t* o = out + slot * t1;
  // Ends past the padded shape are clamped to it.
  const int ei = min(ends[2 * slot], t1 - 1);
  const int ej = min(ends[2 * slot + 1], t2 - 1);

  for (int i = threadIdx.x; i < t1; i += kThreads) o[i] = 0;
  if (ei < 0 || ej < 0) return;  // an empty slot aligns to zeros
  const int lt = ei + 1, lp = ej + 1;

  // Anti-diagonal k holds the cells (i, k - i) of the valid block.
  for (int k = 0; k < lt + lp - 1; ++k) {
    const int i_lo = max(0, k - lp + 1), i_hi = min(lt - 1, k);
    for (int i = i_lo + threadIdx.x; i <= i_hi; i += kThreads) {
      const int j = k - i;
      float v;
      if (i == 0 || j == 0) {
        v = (i == 0 && j == 0) ? 0.0f : CUDART_INF_F;
      } else {
        const float up = d[(int64_t)(i - 1) * t2 + j];
        const float left = d[(int64_t)i * t2 + j - 1];
        const float diag = d[(int64_t)(i - 1) * t2 + j - 1];
        v = __fadd_rn(c[(int64_t)i * t2 + j], fminf(fminf(up, left), diag));
      }
      d[(int64_t)i * t2 + j] = v;
    }
    __syncthreads();
  }

  if (threadIdx.x != 0) return;
  int i = ei, j = ej;
  while (i > 0 && j > 0) {
    o[i] = j;
    const float up = d[(int64_t)(i - 1) * t2 + j];
    const float left = d[(int64_t)i * t2 + j - 1];
    const float diag = d[(int64_t)(i - 1) * t2 + j - 1];
    if (up <= left && up <= diag) {
      --i;
    } else if (left <= diag) {
      --j;
    } else {
      --i;
      --j;
    }
  }
}

}  // namespace

extern "C" {

// costs [S, T1, T2] f32, ends [S, 2] int32, dp [S, T1, T2] f32 scratch,
// out [S, T1] int32: device pointers, contiguous. Returns
// cudaGetLastError() after the launch.
int dtw_align(const void* costs, const void* ends, void* dp, void* out, int s,
              int t1, int t2, void* stream) {
  if (s <= 0 || t1 <= 0 || t2 <= 0) return (int)cudaErrorInvalidValue;
  dtw_align_kernel<<<s, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<const int32_t*>(ends),
      static_cast<float*>(dp), static_cast<int32_t*>(out), t1, t2);
  return (int)cudaGetLastError();
}

}  // extern "C"
