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
// What bounds it: not bytes (each valid cell's cost is read once, 4 bytes)
// nor operations (3 a cell), but two chains: lt + lp - 1 anti-diagonals,
// each a dependent f32 cell step (fminf, fminf, __fadd_rn) behind the cells
// of the diagonal before it, then a serial walk of up to lt + lp steps,
// each a dependent shared-memory load of the next cell's code.
// latency_probe_kernel (probe.cu) measures both on an H100 80GB HBM3:
// 14.2 cycles a cell step and 28.7 a dependent shared-memory load, so the
// longest of 24 slots of 259 x 259 (517 diagonals, ~320 walk steps) is
// bounded by ~0.008 ms at 1.98 GHz (chip_smoke.py prints the bound of each
// case). The kernel runs far above it, ~450 cycles a diagonal: the
// dependent instructions each thread issues a diagonal (its cost copy, the
// exchange with its neighbours, its cell, its code, the barrier), which
// nine warps cannot hide. Two other layouts, a thread owning several rows
// and warps pipelined behind each other without a block barrier, ran
// slower on the card.
//
// The design keeps both chains on chip and everything else off them:
//   * one block per slot, one thread per row of the valid block (strips of
//     up to 1024 rows one after another when lt is larger, the strip's last
//     row handed to the next through a shared-memory boundary row);
//   * the last two anti-diagonals stay in registers: thread i holds its own
//     value of diagonal k - 1 (left) and its upper neighbour's value of
//     diagonal k - 2 (diag); the neighbour's value of k - 1 (up) comes by
//     __shfl_up_sync inside a warp and through shared memory at warp edges;
//     one barrier per diagonal;
//   * the costs come off the chain through shared memory: cp.async copies
//     tiles of kTile diagonals two tiles ahead, each row's kTile cells
//     side by side, so a warp's copies touch a few cache lines (a warp
//     reading one cell of each of 32 rows would touch 32);
//   * each cell stores a 2-bit direction code, computed with the
//     backtrace's own comparisons in its order (up <= left && up <= diag:
//     up; else left <= diag: left; else diag) on the values that enter the
//     fminf, 16 codes a word, row by row, so the walk reads one code per
//     step and ties break as before;
//   * the codes live in shared memory when t1 * ceil(t2 / 16) words fit
//     (17.6 KB at 259 x 259), else in a global scratch (kSharedCodes
//     false); the wrapper (ops/dtw.py plan_dtw) picks the variant.
// No DP matrix is written anywhere. No gradient is needed: the alignment is
// gradient-stopped.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTile = 8;           // diagonals of costs a tile holds
constexpr int kBuffers = 3;        // tiles in flight: one read, two landing
constexpr int kHeaderFloats = 64;  // two diagonals' warp-edge values
constexpr int kMaxSmem = 232448;

// One f32 cost, global -> shared, asynchronously: a barrier does not wait
// for it (it would wait for a register load), cp.async.wait_group does.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool kSharedCodes>
__global__ void __launch_bounds__(kMaxThreads)
dtw_align_kernel(const float* __restrict__ costs,
                 const int32_t* __restrict__ ends,
                 uint32_t* __restrict__ gcodes, int32_t* __restrict__ out,
                 int t1, int t2, int wpr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int bfloats = t1 > nthreads ? ((t2 + 3) & ~3) : 0;
  float* edge = reinterpret_cast<float*>(smem);     // [2][32]
  float* tiles = edge + kHeaderFloats;  // [kBuffers][nthreads][kTile + 1]
  float* boundary = tiles + kBuffers * nthreads * (kTile + 1);  // strips
  const int64_t slot = blockIdx.x;
  const float* c = costs + slot * t1 * t2;
  int32_t* o = out + slot * t1;
  uint32_t* codes = kSharedCodes
      ? reinterpret_cast<uint32_t*>(boundary + bfloats)
      : gcodes + slot * t1 * wpr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Ends past the padded shape are clamped to it.
  const int ei = min(ends[2 * slot], t1 - 1);
  const int ej = min(ends[2 * slot + 1], t2 - 1);

  for (int i = tid; i < t1; i += nthreads) o[i] = 0;
  if (ei < 0 || ej < 0) return;  // an empty slot aligns to zeros
  const int lt = ei + 1, lp = ej + 1;

  for (int r0 = 0; r0 < lt; r0 += nthreads) {
    const int i = r0 + tid;
    const bool row_ok = i < lt;
    const bool hands_on = tid == nthreads - 1 && r0 + nthreads < lt;
    // Lane 0 takes its upper row from the warp before (shared memory), or
    // in the first warp from the strip before (the boundary row).
    const bool up_from_edge = lane == 0 && warp > 0;
    const bool up_from_boundary = lane == 0 && warp == 0 && r0 > 0;
    const float* edge_in = edge + (warp + 31) % 32;
    const int k_last = min(r0 + nthreads, lt) - 1 + lp - 1;
    float prev = CUDART_INF_F;   // this row's value on the last diagonal
    float dprev = CUDART_INF_F;  // the upper row's value two diagonals back
    float up_next = CUDART_INF_F;  // the upper row's value on the last one
    uint32_t acc = 0;            // this row's codes of the current word
    // Tile q of the strip holds its rows' costs of diagonals r0 + kTile q
    // ... + kTile - 1, row by row (kTile + 1 floats a row, so that the
    // rows' reads of one diagonal fall in distinct banks), in buffer
    // q % kBuffers. Step u of a tile copies element u * nthreads + tid of
    // the tile two ahead: kTile consecutive cells of a row for each group
    // of kTile threads, so a warp's copies touch a few lines, not 32.
    auto fetch = [&](int q, int u) {
      const int e = u * nthreads + tid;
      const int row = r0 + e / kTile, col = e % kTile;
      const int j = r0 + kTile * q + col - row;
      if (row < lt && j >= 0 && j < lp)
        cp_async4(tiles + (q % kBuffers) * nthreads * (kTile + 1) +
                      (e / kTile) * (kTile + 1) + col,
                  c + (int64_t)row * t2 + j);
      cp_async_commit();
    };
#pragma unroll
    for (int u = 0; u < kTile; ++u) fetch(0, u);
#pragma unroll
    for (int u = 0; u < kTile; ++u) fetch(1, u);
    cp_async_wait<0>();
    __syncthreads();
    for (int q = 0, k0 = r0; k0 <= k_last; ++q, k0 += kTile) {
      const float* tile = tiles + (q % kBuffers) * nthreads * (kTile + 1) +
                          tid * (kTile + 1);
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        const int k = k0 + u;
        if (k > k_last) break;  // the same k on every thread
        const int j = k - i;
        const bool active = row_ok && j >= 0 && j < lp;
        // The upper row's value on diagonal k - 1: cell (i - 1, j).
        const float from_edge = edge_in[((k - 1) & 1) * 32];
        const float from_boundary =
            (up_from_boundary && j >= 0 && j < lp) ? boundary[j]
                                                   : CUDART_INF_F;
        const float up = up_from_edge ? from_edge
                         : (lane == 0 ? from_boundary : up_next);
        const float cost = tile[u];
        fetch(q + 2, u);
        // Branch-free: the cell step and its code, then the first row and
        // column's values, then only an active cell's result kept.
        const float left = prev, diag = dprev;
        const float step = __fadd_rn(cost, fminf(fminf(up, left), diag));
        uint32_t code = (up <= left && up <= diag) ? 0u
                        : (left <= diag ? 1u : 2u);
        const bool border = i == 0 || j == 0;
        const float v = border ? ((i == 0 && j == 0) ? 0.0f : CUDART_INF_F)
                               : step;
        code = border ? 0u : code;
        prev = active ? v : prev;
        acc |= active ? code << (2 * (j & 15)) : 0u;
        if (active && ((j & 15) == 15 || j == lp - 1)) {
          codes[(int64_t)i * wpr + (j >> 4)] = acc;
          acc = 0;
        }
        if (hands_on && active) boundary[j] = v;
        dprev = up;
        up_next = __shfl_up_sync(0xffffffffu, prev, 1);
        if (lane == 31) edge[(k & 1) * 32 + warp] = prev;
        // The tile after this one has landed (its copies: every thread's).
        if (u == kTile - 1) cp_async_wait<kTile>();
        __syncthreads();
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // The walk: one code a step, its word and shift followed as i and j fall.
  if (tid != 0) return;
  int i = ei, j = ej;
  const uint32_t* w = codes + (int64_t)i * wpr + (j >> 4);
  int shift = 2 * (j & 15);
  while (i > 0 && j > 0) {
    o[i] = j;
    const uint32_t code = (*w >> shift) & 3u;
    const int di = code != 1u, dj = code != 0u;  // up: i; left: j; diag: both
    i -= di;
    j -= dj;
    shift -= 2 * dj;
    w -= di * wpr + (shift < 0);
    shift &= 31;
  }
}

}  // namespace

extern "C" {

// costs [S, T1, T2] f32, ends [S, 2] int32, out [S, T1] int32, codes
// [S, T1, wpr] uint32 scratch (wpr = ceil(T2 / 16); unused and may be null
// when shared_codes): device pointers, contiguous. threads: a multiple of
// 32, at most 1024; smem_bytes: 256 + 108 * threads (the cost tiles) +
// (4 * round4(T2) when T1 > threads) + (4 * T1 * wpr when shared_codes).
// Returns cudaGetLastError() after the launch.
int dtw_align(const void* costs, const void* ends, void* codes, void* out,
              int s, int t1, int t2, int threads, int wpr, int shared_codes,
              int smem_bytes, void* stream) {
  if (s <= 0 || t1 <= 0 || t2 <= 0 || threads <= 0 || threads % 32 ||
      threads > kMaxThreads || wpr * 16 < t2 || smem_bytes > kMaxSmem ||
      (!shared_codes && codes == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = shared_codes ? &dtw_align_kernel<true> : &dtw_align_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<s, threads, (size_t)smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), static_cast<const int32_t*>(ends),
      static_cast<uint32_t*>(codes), static_cast<int32_t*>(out), t1, t2, wpr);
  return (int)cudaGetLastError();
}

}  // extern "C"
