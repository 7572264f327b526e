// One-pass multi-tensor AdamW for Hopper (sm_90a), CUDA C++ behind a plain C
// interface.
//
// Replaces the Pallas TPU kernel ste_gan_tpu/ops/fused_adamw.py::_adamw_kernel
// (:49-62), launched per leaf by _fused_leaf_update (:65-106):
//
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g^2
//   p' = p - lr*((m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p),
//   bc1 = 1 - b1^t, bc2 = 1 - b2^t.
//
// What bounds it: seven f32 streams per parameter (read p, g, m, v; write p,
// m, v: 28 bytes) against ~15 FLOP, so device-memory bandwidth bounds it.
// The design makes one pass over every buffer and one launch per network:
// the leaves are described by device tables (pointers and sizes) and cut
// into fixed-size chunks, one block per chunk. The hyperparameters
// (lr, b1, b2, eps, wd) and the step count live in device memory, so the
// update never waits on the host; the bias corrections are computed from
// the count inside the kernel. Every thread keeps several independent loads
// in flight (unrolled loop) to cover memory latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
adamw_multi_tensor_kernel(const int64_t* __restrict__ p_ptrs,
                          const int64_t* __restrict__ g_ptrs,
                          const int64_t* __restrict__ m_ptrs,
                          const int64_t* __restrict__ v_ptrs,
                          const int64_t* __restrict__ sizes,
                          const int32_t* __restrict__ chunk_leaf,
                          const int64_t* __restrict__ chunk_start, int chunk_size,
                          const float* __restrict__ hyper,
                          const int32_t* __restrict__ count) {
  const int leaf = chunk_leaf[blockIdx.x];
  const int64_t start = chunk_start[blockIdx.x];
  const int64_t n = sizes[leaf];
  const int64_t end = start + chunk_size < n ? start + chunk_size : n;
  float* p = reinterpret_cast<float*>(p_ptrs[leaf]);
  const float* g = reinterpret_cast<const float*>(g_ptrs[leaf]);
  float* m = reinterpret_cast<float*>(m_ptrs[leaf]);
  float* v = reinterpret_cast<float*>(v_ptrs[leaf]);

  const float lr = hyper[0], b1 = hyper[1], b2 = hyper[2], eps = hyper[3],
              wd = hyper[4];
  const float t = (float)count[0];
  const float bc1 = 1.0f - powf(b1, t);
  const float bc2 = 1.0f - powf(b2, t);

  for (int64_t i0 = start + threadIdx.x; i0 < end; i0 += (int64_t)kThreads * kUnroll) {
    float pv[kUnroll], gv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      if (i < end) {
        pv[u] = p[i]; gv[u] = g[i]; mv[u] = m[i]; vv[u] = v[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      if (i < end) {
        const float m_new = b1 * mv[u] + (1.0f - b1) * gv[u];
        const float v_new = b2 * vv[u] + (1.0f - b2) * (gv[u] * gv[u]);
        const float m_hat = m_new / bc1;
        const float v_hat = v_new / bc2;
        const float update = m_hat / (sqrtf(v_hat) + eps) + wd * pv[u];
        p[i] = pv[u] - lr * update;
        m[i] = m_new;
        v[i] = v_new;
      }
    }
  }
}

}  // namespace

extern "C" {

// All table and scalar pointers are device pointers. Returns
// cudaGetLastError() after the launch.
int adamw_multi_tensor(const void* p_ptrs, const void* g_ptrs, const void* m_ptrs,
                       const void* v_ptrs, const void* sizes, const void* chunk_leaf,
                       const void* chunk_start, int n_chunks, int chunk_size,
                       const void* hyper, const void* count, void* stream) {
  if (n_chunks <= 0) return (int)cudaErrorInvalidValue;
  adamw_multi_tensor_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(p_ptrs), static_cast<const int64_t*>(g_ptrs),
      static_cast<const int64_t*>(m_ptrs), static_cast<const int64_t*>(v_ptrs),
      static_cast<const int64_t*>(sizes), static_cast<const int32_t*>(chunk_leaf),
      static_cast<const int64_t*>(chunk_start), chunk_size,
      static_cast<const float*>(hyper), static_cast<const int32_t*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"
