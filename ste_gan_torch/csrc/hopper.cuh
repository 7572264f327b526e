// Device helpers shared by the grouped conv's Hopper kernels
// (grouped_conv.cu: forward and dX; grouped_conv_dw.cu: dW): shared-memory
// addresses and ldmatrix, mbarriers, proxy fences, named barriers, wgmma
// descriptors and fences, and the channel-last window staging. Each source
// builds on its own (ops/build.py), so the two build in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Makes this thread's shared-memory stores visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A K-major shared-memory matrix without swizzle: start, LBO (the next 8
// K-elements) and SBO (the next 8 rows), all in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Stages source times t0 + pv (pv < S*V) of n_ch channels (rows of sb,
// T_src apart) channel-last into win: position pv of channels 8*c8.. goes to
// row pv div S of plane pv mod S, as one 16-byte row of 8 channels; zeros
// outside the source and past n_ch. Run by threads ptid of nthr window
// threads.
__device__ __forceinline__ void stage_window(bf16* win, const unsigned short* sb, int T_src,
                                             int n_ch, int C8, int V, int S, int s_shift,
                                             int vec, int t0, int ptid, int nthr) {
  const int sv = S * V;
  if (vec) {
    // 16-byte loads of 8 time steps of one channel (T_src % 8 == 0, so
    // an aligned 8-step chunk lies wholly inside or outside the source),
    // transposed in registers: unit (c8, k) covers source times
    // T0 + 8k.. of channels 8*c8.., two units in flight per thread.
    const int T0 = t0 & ~7, nch = (((t0 + sv + 7) & ~7) - T0) >> 3;
    const int n_units = nch * C8;
    for (int u0 = ptid; u0 < n_units; u0 += 2 * nthr) {
      uint4 v[2][8];
      int c8s[2], tks[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + h * nthr;
        const int c8 = u / nch, tk = T0 + 8 * (u - c8 * nch);
        c8s[h] = c8;
        tks[h] = tk;
        const int n_ok = (u < n_units && tk >= 0 && tk < T_src) ? n_ch - c8 * 8 : 0;
        const unsigned short* s8 = sb + (size_t)(c8 * 8) * T_src + tk;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[h][e] = e < n_ok ? __ldg(reinterpret_cast<const uint4*>(s8 + (size_t)e * T_src))
                             : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (u0 + h * nthr >= n_units) continue;
        const int pv0 = tks[h] - t0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int pv = pv0 + q;
          if (pv < 0 || pv >= sv) continue;
          const uint32_t sel = (q & 1) ? 0x7632u : 0x5410u;
          uint32_t wd[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint4& a = v[h][2 * c];
            const uint4& b = v[h][2 * c + 1];
            const uint32_t wa = (q >> 1) == 0 ? a.x : (q >> 1) == 1 ? a.y : (q >> 1) == 2 ? a.z : a.w;
            const uint32_t wb2 = (q >> 1) == 0 ? b.x : (q >> 1) == 1 ? b.y : (q >> 1) == 2 ? b.z : b.w;
            wd[c] = __byte_perm(wa, wb2, sel);
          }
          const int plane = pv & (S - 1), row = pv >> s_shift;
          *reinterpret_cast<uint4*>(win + ((size_t)(plane * C8 + c8s[h]) * V + row) * 8) =
              make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
    }
  } else {
    // Any length: eight 2-byte loads per 16-byte row, four rows' loads
    // in flight per thread.
    const int n_pieces = sv * C8;
    for (int base = ptid; base < n_pieces; base += 4 * nthr) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * nthr;
        unsigned short e8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) e8[e] = 0;
        if (idx < n_pieces) {
          const int c8 = idx / sv, tt = t0 + idx - c8 * sv;
          const int n_ok = (tt >= 0 && tt < T_src) ? n_ch - c8 * 8 : 0;
          const unsigned short* s8 = sb + (size_t)(c8 * 8) * T_src + tt;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < n_ok) e8[e] = __ldg(s8 + (size_t)e * T_src);
        }
        v[u] = make_uint4(pack2(e8[0], e8[1]), pack2(e8[2], e8[3]), pack2(e8[4], e8[5]),
                          pack2(e8[6], e8[7]));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * nthr;
        if (idx < n_pieces) {
          const int c8 = idx / sv, pv = idx - c8 * sv;
          const int plane = pv % S, row = pv / S;
          *reinterpret_cast<uint4*>(win + ((size_t)(plane * C8 + c8) * V + row) * 8) =
              v[u];
        }
      }
    }
  }
}

}  // namespace
