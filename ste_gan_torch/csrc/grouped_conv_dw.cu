// Weight gradient (dW) of the grouped 1-D convolution in bf16 for Hopper
// (sm_90a), CUDA C++ behind a plain C interface: conv_dw_wgmma_kernel. The
// forward, dX and the f32 routes are in grouped_conv.cu; the helpers both
// use are in hopper.cuh. Layout as there: x [B, Cin, Tin], dy [B, Cout,
// Tout], dW [Cout, cg, K]; sums in f32, no atomics, a fixed order.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// dW in bf16 (Hopper): conv_dw_wgmma_kernel replaces pallas_conv.py:158
// _dw_kernel through _run_dw (:211-234).
//
// dw[o, c, j] = sum_{b, u} dy[b, o, u] * x[b, c, u*s + j - pad_l]: per group a
// GEMM of M = output channels by N = (tap, input channel) columns, summed
// over the B x Tout rows (the wgmma K).
//
// What bounds it: operations, 104.3 GFLOP per six-geometry pass of the main
// path (0.105 ms at 989 TFLOP/s), against ~235 MB of operands (0.07 ms at
// 3.35 TB/s): the rows are the long axis and the output is small (<= 1.2 MB
// of f32 sums a call), so the sums stay in registers while the rows stream
// past, and every staged row has to feed as many products as the registers
// can hold.
//
// The design (ops/grouped_conv.py _plan_dw plans it, emulate_dw replays it
// on the CPU):
//   1. Units. Taps s*m .. s*m + s-1 of tap row m lie in the s planes of the
//      channel-last window [plane][c/8][row][8] (the forward's layout) at
//      the same row, so R planes of CO channels are R*CO columns at one
//      uniform stride: a unit is one wgmma m64nNk16 with N = R*CO (64 at
//      layer 1, 32 at layer 2: both taps of a tap row), and tap row m is a
//      start-row shift of the x descriptor, as a tap is in the forward. 37
//      taps at stride 2 are 19 units (one column half idle in 38).
//   2. Operands. A is dy, 64 output channels x 16 rows, loaded by ldmatrix
//      from an [o][u] tile (rows time-contiguous as dy lies, pitch padded by
//      16 bytes) into registers once per k16 step and used by every unit of
//      the warpgroup; B is the x window through an MN-major (transposed)
//      no-swizzle descriptor: 8 channels of a row are one 16-byte unit,
//      LBO = the next 8 rows (128 bytes), SBO = the next 8 columns (V rows
//      x 16 bytes), as CUTLASS's canonical MN-major interleaved layout
//      ((T,1,m),(8,k)):((1,T,SBO),(1T,LBO)). The A fragments are double-
//      buffered across k16 steps (wgmma_wait<1> before a buffer is loaded
//      again).
//   3. Output-stationary clusters. A cluster of C CTAs (C <= 8, the
//      portable limit) owns one output tile: a group, 64 output channels, a
//      channel tile and a part, one of n_parts near-equal contiguous ranges
//      of the U units (6/6/7 units, 12/12/13 taps at layer 1). Each rank
//      takes a contiguous range of row tiles (BT time steps of one batch
//      row, so the window is contiguous); both consumer warpgroups of a CTA
//      read every staged tile, one holding the first half of the part's
//      units (rounded up), the other the rest, each with up to UW units'
//      accumulators in registers (UW * N / 2 a thread, up to 160; setmaxnreg
//      moves registers from the window warpgroup to them) for all of the
//      rank's rows. A warpgroup one unit short of UW runs a mainloop
//      compiled for UW - 1 units, so it computes no product for the missing
//      one. The plan picks C from how many clusters of each size the card
//      holds at once (_cluster_table: a cluster's CTAs share a GPC; an H100
//      holds 15 of 8 CTAs, 17 of 6). Main path: 96 CTAs a call, 12 tiles
//      (4 groups x 3 parts) of 8 at layer 1, 16 tiles of 6 at layer 2
//      (clusters of 8 would need two waves there).
//   4. On-chip reduction, deterministic. Each warpgroup stores its sums into
//      an f32 [o][c][tap] buffer over the drained ring; after a cluster
//      barrier rank r sums slice r of the tile over ranks 0..C-1, in that
//      order, through distributed shared memory (mapa +
//      ld.shared::cluster), converts to bf16 and stores rows contiguous in
//      K. No f32 slab in device memory, no second launch, no atomics.
//   5. Staging off the critical path. The window warpgroup loads tile k's dy
//      rows into its slot and its x span, time-major as x lies, into a raw
//      buffer with cp.async (16 bytes a copy, zero-filled outside x), while
//      tile k-1's raw x is transposed to channel-last: ldmatrix.trans takes
//      8 channels' rows of 8 time steps, stmatrix stores them as 8 window
//      rows of 8 channels. Completion travels on mbarriers (a ring of 2-4
//      slots), never __syncthreads. Timed on an H100 with parts switched
//      off, starting the copies and transposing each took ~2-3x the
//      products' time until their loops lost every integer division; now
//      the products and the staging take about as long as each other.
//      Lengths that are not a multiple of 8 stage x and dy by 2-byte loads.
// What it does not fix: layer 2 has og = 32 output channels, so the upper
// half of each m64 product computes zeros and the layer caps at half the
// tensor-core rate (0.0356 of the six geometries' 0.106 ms bound); 96 of
// the 132 SMs have a CTA (layer 1: 12 output tiles at the portable limit
// of 8 CTAs a cluster; layer 2: the GPCs hold 15 clusters of 8 for its 16
// tiles, so 6 a cluster); and a part re-stages its row tiles (three times
// at layer 1, mostly from L2).
// ---------------------------------------------------------------------------

struct DwParams {  // field order = DwPlan in ops/grouped_conv.py
  int B, Cin, Cout, Tin, Tout, K, stride, pad_l, G, cg, og;
  int CO, C8, n_ct, n_ot, R, n_pg, U, UW, n_parts;
  int BT, n_tb, n_rt, C, n_tiles, V, JP, planes, dy_pitch;
  int slot_bytes, win_off, n_slots, n_x8, raw_pitch, raw_off;
  int x_async, dy_async, s_shift, b_lbo, b_sbo, nt_w, smem;
};

constexpr int kDwThreads = 384;  // warps 0-7: two consumer warpgroups, 8-11: windows
constexpr int kDwMaxSlots = 4;   // ring slots
constexpr int kDwMaxCluster = 8;
constexpr int kDwProducerRegs = 72;   // setmaxnreg: the window warpgroup gives up
constexpr int kDwConsumerRegs = 216;  // registers the consumer warpgroups take

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster; orders the shared-memory writes
// before it with the reads after it, cluster-wide.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The f32 at the same shared-memory address of cluster rank `rank`.
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N], A in registers (the mma.sync m16n8k16
// A fragment of each warp's 16 rows), B from shared memory MN-major
// (tnspB = 1); accumulators as wgmma_bf16.
template <int N>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_bf16<16>(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_bf16<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_bf16<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The first NU units' products of one k16 step: A from the dy tile at row
// address arow (this lane's ldmatrix row), B at descriptor d (this step's
// rows) plus each unit's start.
template <int NT, int UW, int NU>
__device__ __forceinline__ void dw_step(float (&acc)[UW][NT / 2], uint32_t (&a)[4],
                                        const bf16* arow, uint64_t d,
                                        const uint32_t (&uoff)[UW]) {
  ldsm_x4(arow, a[0], a[1], a[2], a[3]);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < NU; ++u) wgmma_rs_bf16<NT>(acc[u], a, d + uoff[u]);
  wgmma_commit();
}

// A cluster's output tile and this CTA's row tiles, as conv_dw_wgmma_kernel
// decodes them (DwPlan.tile, .rank_rows).
struct DwTile {
  int g, ot, ct, part, n_o, n_c, q_lo, q_hi, m_first, lo, hi;
};

__device__ __forceinline__ DwTile dw_tile(const DwParams& p, uint32_t rank) {
  DwTile t;
  int rest = (int)cluster_id_x();
  t.part = rest % p.n_parts;
  rest /= p.n_parts;
  t.ct = rest % p.n_ct;
  rest /= p.n_ct;
  t.ot = rest % p.n_ot;
  t.g = rest / p.n_ot;
  t.n_o = min(64, p.og - 64 * t.ot);
  t.n_c = min(p.CO, p.cg - p.CO * t.ct);
  t.q_lo = t.part * p.U / p.n_parts;  // the part's units (DwPlan.part_units)
  t.q_hi = (t.part + 1) * p.U / p.n_parts;
  t.m_first = t.q_lo / p.n_pg;
  t.lo = (int)((long long)rank * p.n_rt / p.C);
  t.hi = (int)((long long)(rank + 1) * p.n_rt / p.C);
  return t;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

constexpr int kDwWinThreads = 128;  // the window warpgroup
constexpr int kDwTrUnroll = 4;      // transposition: ldmatrix x4 in flight per warp

// Finishes row tile `slot` once its copies have landed: its x window
// transposed from the time-major raw buffer rk into the slot's channel-last
// window (or, without 16-byte aligned rows, staged from x by 2-byte loads),
// then the slot is handed to the consumers. A warp transposes 8 x 8 units
// four at a time: ldmatrix.trans loads 8 channels' 16-byte rows of 8 time
// steps each, stmatrix stores them as 8 rows of 8 channels, each row at its
// window position (or a scratch row past the window).
__device__ __forceinline__ void dw_finish(const unsigned short* xh, const DwParams& p,
                                          const DwTile& t, const bf16* rk, unsigned char* ring,
                                          uint32_t scratch, int slot, int t0, int b, int ptid,
                                          uint64_t* full) {
  bf16* win = reinterpret_cast<bf16*>(ring + (size_t)slot * p.slot_bytes + p.win_off);
  if (p.x_async) {
    // Unit u = q*C8 + c8 (8-step chunk q of channels 8*c8..); matrix i of
    // warp w's h-th load takes units s + 64j, s = (4w + h)*4 + i, so its
    // c8 stays fixed and q steps by 64 / C8: no division in the loop.
    const int lane = ptid & 31, T0 = t0 & ~7, n_units = p.C8 * p.n_x8, r = lane & 7;
    const int lc8 = __ffs(p.C8) - 1, sv = p.stride * p.V;
    const uint32_t raw_addr = smem_addr(rk), win_addr = smem_addr(win);
    for (int j0 = 0; j0 < n_units; j0 += 16 * kDwTrUnroll) {
      uint32_t v[kDwTrUnroll][4], dst[kDwTrUnroll];
#pragma unroll
      for (int h = 0; h < kDwTrUnroll; ++h) {
        const int sl = ((ptid >> 5) * kDwTrUnroll + h) * 4 + (lane >> 3);
        const int c8 = sl & (p.C8 - 1), q = (sl + j0) >> lc8, pv = T0 + 8 * q + r - t0;
        const bool ok = j0 + sl < n_units;
        dst[h] = (ok && pv >= 0 && pv < sv)
                     ? win_addr + (uint32_t)((((pv & (p.stride - 1)) * p.C8 + c8) * p.V +
                                              (pv >> p.s_shift)) * 16)
                     : scratch;
        ldsm_x4_trans(ok ? raw_addr + (uint32_t)(((c8 * 8 + r) * p.raw_pitch + 8 * q) * 2)
                         : raw_addr,
                      v[h]);
      }
#pragma unroll
      for (int h = 0; h < kDwTrUnroll; ++h) stsm_x4(dst[h], v[h]);
    }
  } else {
    stage_window(win, xh + ((size_t)b * p.Cin + (size_t)t.g * p.cg + p.CO * t.ct) * p.Tin,
                 p.Tin, t.n_c, p.C8, p.V, p.stride, p.s_shift, 0, t0, ptid, kDwWinThreads);
  }
  fence_async_smem();
  mbar_arrive(full + slot);
}

// The window warpgroup. Row tile k's dy rows (into its slot) and x window
// (time-major, into raw buffer k mod 2) are loaded by cp.async, 16 bytes a
// copy; meanwhile tile k-1, whose copies have landed, is finished, so a
// tile's loads stay in flight while the previous one is transposed.
// Without 16-byte aligned rows, dy is staged by 2-byte loads.
__device__ __forceinline__ void dw_windows(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                           const DwParams& p, const DwTile& t, unsigned char* ring,
                                           uint64_t* full, uint64_t* empty) {
  const int ptid = threadIdx.x - 256;
  const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* dyh = reinterpret_cast<const unsigned short*>(dy);
  bf16* raw = reinterpret_cast<bf16*>(ring + p.raw_off);
  const size_t raw_elems = (size_t)p.CO * p.raw_pitch;
  // 16 bytes past the mbarriers: where the transposition drops rows that
  // fall outside the window.
  const uint32_t scratch = smem_addr(ring) - 128;
  int prev_slot = 0, prev_t0 = 0, prev_b = 0, s_idx = 0, s_round = 0, k = 0;
  for (int i = t.lo; i < t.hi; ++i, ++k) {
    const int b = i / p.n_tb, u0 = (i - b * p.n_tb) * p.BT;
    const int n_u = min(p.BT, p.Tout - u0), t0 = (u0 + t.m_first) * p.stride - p.pad_l;
    const int slot = s_idx;
    if (s_round > 0) mbar_wait(empty + slot, (s_round - 1) & 1);
    named_sync(2, kDwWinThreads);  // raw buffer k mod 2 is free: tile k-2 is finished
    unsigned short* dys = reinterpret_cast<unsigned short*>(ring + (size_t)slot * p.slot_bytes);
    const unsigned short* dyb =
        dyh + ((size_t)b * p.Cout + (size_t)t.g * p.og + 64 * t.ot) * p.Tout + u0;
    if (p.dy_async) {
      // Thread: one 8-step chunk column c8 of every (128 / n8)-th row.
      const int ls = p.BT == 128 ? 4 : 3, c8 = ptid & ((1 << ls) - 1);
      const bool ok = 8 * c8 < n_u;  // n_u is a multiple of 8
      for (int o = ptid >> ls; o < t.n_o; o += kDwWinThreads >> ls)
        cp_async16(dys + o * p.dy_pitch + 8 * c8, ok ? dyb + (size_t)o * p.Tout + 8 * c8 : dyb,
                   ok ? 16u : 0u);
    } else {
      for (int e = ptid; e < t.n_o * p.BT; e += kDwWinThreads) {
        const int o = e / p.BT, uu = e - o * p.BT;
        dys[o * p.dy_pitch + uu] = uu < n_u ? dyb[(size_t)o * p.Tout + uu] : (unsigned short)0;
      }
    }
    if (p.x_async) {
      // 8-step chunks from T0 = t0 rounded down to 8: each lies wholly
      // inside or outside x (Tin % 8 == 0); outside ones and channels
      // past n_c are zero-filled. Thread: channel ptid / (128 / CO),
      // every (128 / CO)-th chunk.
      const unsigned short* xb =
          xh + ((size_t)b * p.Cin + (size_t)t.g * p.cg + p.CO * t.ct) * p.Tin;
      unsigned short* rk = reinterpret_cast<unsigned short*>(raw + (k & 1) * raw_elems);
      const int T0 = t0 & ~7, lt = 7 - (__ffs(p.CO) - 1), c = ptid >> lt;
      const unsigned short* xc = xb + (size_t)c * p.Tin;
      for (int q = ptid & ((1 << lt) - 1); q < p.n_x8; q += 1 << lt) {
        const int tt = T0 + 8 * q;
        const bool ok = c < t.n_c && tt >= 0 && tt < p.Tin;
        cp_async16(rk + (size_t)c * p.raw_pitch + 8 * q, ok ? xc + tt : xb, ok ? 16u : 0u);
      }
    }
    cp_async_commit();
    if (k > 0) {
      cp_async_wait<1>();
      named_sync(2, kDwWinThreads);  // every thread's copies of tile k-1 have landed
      dw_finish(xh, p, t, raw + ((k - 1) & 1) * raw_elems, ring, scratch, prev_slot, prev_t0,
                prev_b, ptid, full);
    }
    prev_slot = slot;
    prev_t0 = t0;
    prev_b = b;
    if (++s_idx == p.n_slots) {
      s_idx = 0;
      ++s_round;
    }
  }
  if (k > 0) {
    cp_async_wait<0>();
    named_sync(2, kDwWinThreads);
    dw_finish(xh, p, t, raw + ((k - 1) & 1) * raw_elems, ring, scratch, prev_slot, prev_t0,
              prev_b, ptid, full);
  }
}

// Every row tile of the rank: products into the first NU of the UW
// accumulators (uoff: each unit's first window row, in 16-byte units).
template <int NT, int UW, int NU>
__device__ __forceinline__ void dw_mainloop(const DwParams& p, const DwTile& t,
                                            float (&acc)[UW][NT / 2],
                                            const uint32_t (&uoff)[UW], unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int wwarp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const uint32_t ring_addr = smem_addr(ring);
  const int nks = p.BT >> 4;
  uint32_t a0[4], a1[4];
  int s_idx = 0, s_round = 0;
  for (int i = t.lo; i < t.hi; ++i) {
    const int slot = s_idx;
    mbar_wait(full + slot, s_round & 1);
    const uint32_t sa = ring_addr + (uint32_t)(slot * p.slot_bytes);
    const uint64_t d0 = smem_desc(sa + p.win_off, p.b_lbo * 16, p.b_sbo * 16);
    const bf16* arow = reinterpret_cast<const bf16*>(ring + (size_t)slot * p.slot_bytes) +
                       (wwarp * 16 + (lane & 15)) * p.dy_pitch + (lane >> 4) * 8;
    // Two k16 steps an iteration, one per A buffer: a buffer is loaded
    // again only once the products that read it are done.
    for (int ks = 0; ks < nks; ks += 2) {
      dw_step<NT, UW, NU>(acc, a0, arow + 16 * ks, d0 + (uint32_t)(16 * ks), uoff);
      wgmma_wait<1>();
      dw_step<NT, UW, NU>(acc, a1, arow + 16 * (ks + 1), d0 + (uint32_t)(16 * (ks + 1)), uoff);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    mbar_arrive(empty + slot);
    if (++s_idx == p.n_slots) {
      s_idx = 0;
      ++s_round;
    }
  }
}

// Consumer warpgroup wg: every row tile of the rank, products into the
// accumulators of its nu <= UW units (the first half of the part's units,
// rounded up, or the rest: DwPlan.units), then its sums into the reduce
// buffer. The mainloop is compiled for UW and UW - 1 units, so a warpgroup
// one unit short (layer 1's 7/6/6 units, layer 2's 10 + 9) computes no
// product for the missing one; with fewer, the last unit is repeated and
// its sums are dropped.
template <int NT, int UW>
__device__ __forceinline__ void dw_products(const DwParams& p, const DwTile& t, int wg,
                                            unsigned char* ring, uint64_t* full,
                                            uint64_t* empty) {
  const int wwarp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int mid = t.q_lo + (t.q_hi - t.q_lo + 1) / 2;
  const int q0 = wg ? mid : t.q_lo, nu = (wg ? t.q_hi : mid) - q0;
  uint32_t uoff[UW];
#pragma unroll
  for (int u = 0; u < UW; ++u) {
    const int q = max(q0 + min(u, nu - 1), 0), m = q / p.n_pg, pg = q - m * p.n_pg;
    uoff[u] = (uint32_t)(pg * p.R * p.C8 * p.V + m - t.m_first);
  }
  float acc[UW][NT / 2];
#pragma unroll
  for (int u = 0; u < UW; ++u) {
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) acc[u][q] = 0.f;
    fence_acc(acc[u]);
  }
  if (nu == UW)
    dw_mainloop<NT, UW, UW>(p, t, acc, uoff, ring, full, empty);
  else
    dw_mainloop<NT, UW, UW - 1>(p, t, acc, uoff, ring, full, empty);
#pragma unroll
  for (int u = 0; u < UW; ++u) fence_acc(acc[u]);

  // The sums into the reduce buffer [o][c][tap - s*m_first] (f32, over the
  // drained ring; the two warpgroups' units hold different taps).
  float* red = reinterpret_cast<float*>(ring);
  named_sync(1, 256);
#pragma unroll
  for (int u = 0; u < UW; ++u) {
    const int q = q0 + u;
    if (u >= nu) continue;
    const int m = q / p.n_pg, pg = q - m * p.n_pg;
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) {
      const int o = wwarp * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
      const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      const int r = col / p.CO, c = col - r * p.CO, plane = pg * p.R + r;
      const int j = m * p.stride + plane;
      if (o < t.n_o && c < t.n_c && plane < p.stride && j < p.K)
        red[(o * p.CO + c) * p.JP + j - t.m_first * p.stride] = acc[u][e];
    }
  }
}

// Rank r's slice of the tile's (o, c) rows, summed over the cluster's
// reduce buffers in rank order and stored as bf16, contiguous in K. Run by
// the 256 consumer threads, four elements' loads in flight each.
__device__ __forceinline__ void dw_reduce(bf16* __restrict__ dw, const DwParams& p,
                                          const DwTile& t, uint32_t rank, unsigned char* ring) {
  const int q0 = t.q_lo, q1 = t.q_hi;
  const int j_lo = (q0 / p.n_pg) * p.stride + (q0 % p.n_pg) * p.R;
  const int j_hi = min(p.K, (q1 / p.n_pg) * p.stride + (q1 % p.n_pg) * p.R);
  const int nj = j_hi - j_lo, pairs = t.n_o * t.n_c;
  const int pr0 = (int)((long long)rank * pairs / p.C);
  const int total = (int)((long long)(rank + 1) * pairs / p.C) - pr0;
  const uint32_t red_addr = smem_addr(ring);
  for (int e0 = threadIdx.x; e0 < total * nj; e0 += 4 * 256) {
    float v[4][kDwMaxCluster];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = min(e0 + 256 * h, total * nj - 1), pr = pr0 + e / nj, j = j_lo + e % nj;
      const int o = pr / t.n_c, c = pr - o * t.n_c;
      const uint32_t off =
          red_addr + (uint32_t)(((o * p.CO + c) * p.JP + j - t.m_first * p.stride) * 4);
#pragma unroll
      for (int q = 0; q < kDwMaxCluster; ++q)
        v[h][q] = q < p.C ? ld_cluster_f32(off, (uint32_t)q) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = e0 + 256 * h;
      if (e >= total * nj) break;
      const int pr = pr0 + e / nj, j = j_lo + e % nj;
      const int o = pr / t.n_c, c = pr - o * t.n_c;
      float sum = v[h][0];
#pragma unroll
      for (int q = 1; q < kDwMaxCluster; ++q)
        if (q < p.C) sum += v[h][q];
      dw[((size_t)(t.g * p.og + 64 * t.ot + o) * p.cg + p.CO * t.ct + c) * p.K + j] =
          __float2bfloat16(sum);
    }
  }
}

template <int NT, int UW>
__global__ void __launch_bounds__(kDwThreads, 1)
conv_dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     bf16* __restrict__ dw, const DwParams p) {
  extern __shared__ __align__(128) unsigned char dw_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(dw_smem);  // [slot], 128 window threads
  uint64_t* empty = full + kDwMaxSlots;                   // [slot], 256 consumer threads
  unsigned char* ring = dw_smem + 256;  // slots and raw buffers, then the reduce buffer
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const uint32_t rank = cluster_ctarank();
  const DwTile t = dw_tile(p, rank);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDwMaxSlots; ++i) {
      mbar_init(full + i, kDwWinThreads);
      mbar_init(empty + i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8) {
    // The window warpgroup gives registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDwProducerRegs));
    dw_windows(x, dy, p, t, ring, full, empty);
    cluster_sync();  // every rank's reduce buffer is written
    cluster_sync();  // and read
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kDwConsumerRegs));
    dw_products<NT, UW>(p, t, warp >> 2, ring, full, empty);
    cluster_sync();
    dw_reduce(dw, p, t, rank, ring);
    cluster_sync();  // no CTA leaves while another reads its shared memory
  }
}

typedef void (*DwKernel)(const bf16*, const bf16*, bf16*, const DwParams);

// The instantiation for (wgmma N, units per warpgroup): _DW_UNITS in
// ops/grouped_conv.py. index: its slot in the launcher's attribute cache.
DwKernel dw_kernel(int nt, int uw, int* index) {
  const int key = nt * 64 + uw;
  const int keys[] = {64 * 64 + 4, 32 * 64 + 10, 16 * 64 + 16};
  const DwKernel kerns[] = {conv_dw_wgmma_kernel<64, 4>, conv_dw_wgmma_kernel<32, 10>,
                            conv_dw_wgmma_kernel<16, 16>};
  for (int i = 0; i < 3; ++i)
    if (keys[i] == key) {
      *index = i;
      return kerns[i];
    }
  return nullptr;
}

// The launch configuration of n_clusters clusters of `cluster` CTAs with
// smem bytes of dynamic shared memory (attr: the cluster attribute's store).
cudaLaunchConfig_t dw_config(int n_clusters, int cluster, int smem, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cluster);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises the kernel's dynamic shared-memory limit to smem (never lowers it:
// one attribute call per kernel and size, not per launch).
int dw_smem_limit(DwKernel kern, int index, int smem) {
  static int smem_set[3] = {0, 0, 0};
  if (smem <= smem_set[index]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  smem_set[index] = smem;
  return 0;
}

}  // namespace

extern "C" {

// bf16 dW (conv_dw_wgmma_kernel), one launch of n_tiles clusters of C
// CTAs. params: the DwParams fields in order; dw: [Cout, cg, K] bf16.
int grouped_conv1d_dw_bf16(const void* x, const void* dy, void* dw, const int* params,
                           void* stream) {
  const DwParams& p = *reinterpret_cast<const DwParams*>(params);
  int index = 0;
  const DwKernel kern = dw_kernel(p.nt_w, p.UW, &index);
  if (kern == nullptr || p.C < 1 || p.C > kDwMaxCluster) return (int)cudaErrorInvalidValue;
  int err = dw_smem_limit(kern, index, p.smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      dw_config(p.n_tiles, p.C, p.smem, static_cast<cudaStream_t>(stream), attr);
  err = (int)cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(x),
                                static_cast<const bf16*>(dy), static_cast<bf16*>(dw), p);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs of the dW kernel (one CTA per SM, at
// any shared-memory size the plan takes) the card holds at once, into *out.
int grouped_conv1d_dw_max_clusters(int cluster, int* out) {
  int index = 0;
  const DwKernel kern = dw_kernel(32, 10, &index);
  const int smem = 227 * 1024;
  int err = dw_smem_limit(kern, index, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = dw_config(1, cluster, smem, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

}  // extern "C"
