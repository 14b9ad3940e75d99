// Kernel B1's device code and the choice of its instantiation, shared by
// the two translation units that instantiate it: fused_glm_grad.cu (the
// float32 kernels and the C interface) and fused_glm_grad_bf16.cu (the
// bfloat16 kernels), which nvcc builds in parallel. The design is in
// fused_glm_grad.cu's header comment.

#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "glm_grad_plan.h"

namespace eh_glm {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // plus one producer warp
constexpr int kRegCols = 1024;             // widest F on the row path
constexpr int kMaxCols = 16384;            // widest column tile a CTA holds
constexpr int kMaxCluster = 8;             // CTAs a cluster holds (portable)
constexpr int kMaxStages = 4;
constexpr int kStageBytes = 32768 + 128;   // a stage's least size
constexpr int kRowStageRows = 256;         // row path: rows per stage at most
constexpr int kColStageRows = 8;           // column, cluster paths: rows a stage
constexpr int kSmemBudget = 220 * 1024;    // column, cluster paths: stages' bytes
constexpr int kSmemMax = 232448;           // dynamic shared memory a CTA may use

// How a CTA walks its rows: the row path (a warp per row, F <= kRegCols),
// the column path (the CTA's threads split a row, F <= kMaxCols), the
// cluster path (a cluster's CTAs split a row by column tiles, each tile on
// the column path, F <= kMaxCluster * kMaxCols) and, wider still, the
// re-read path (no stages: each row read twice from global memory).
enum Mode { kRowPath, kColPath, kClusterPath, kRereadPath };

// Shared memory of one CTA, in bytes from its start: the full and empty
// barriers of each stage, each stage's y and w, the column paths' margin
// partials (two buffers), the cluster path's CTA margins (two buffers) and
// residuals, a flag, then the stages. On the cluster path a stage holds
// each row's tile `stride` bytes after the last.
struct Layout {
  int stages, stage_bytes, stage_rows, meta_rows, stride;
  int y_off, w_off, red_off, xb_off, sres_off, flag_off, data_off, smem_bytes;
};

struct Params {
  const void* X;
  const float* y;
  const float* beta;
  const float* w;
  float* out;
  float* partials;   // [n_units, Fp]
  float* gpartials;  // [n_groups, Fp]
  unsigned* tickets;  // [n_groups + 1], zero at launch
  long long n_rows;
  // a unit owns a range of rows and writes one partial: a CTA, or on the
  // cluster path a cluster of `cluster` CTAs
  int R, F, Fp, row_bytes, n_units, cluster, group_size, n_groups, logistic;
  Layout L;
};

__device__ __forceinline__ long long min_ll(long long a, long long b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, unsigned long long src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// the barrier's pending count drops when this thread's cp.async copies so
// far have landed (counted in the barrier's arrivals: no increment)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// the consumer warps only (the producer never waits here)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <typename T, int VEC>
struct Smem;

template <>
struct Smem<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Smem<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
};

template <>
struct Smem<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
};

template <>
struct Smem<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
};

__device__ __forceinline__ float residual(float p, float y, int logistic) {
  return logistic ? -y / (expf(p * y) + 1.0f) : -2.0f * (y - p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
__host__ __device__ constexpr int unroll_for() {
  // registers per lane for one row is N; keep about 32 row values in
  // flight per lane, between 1 and 8 rows at a time
  return N >= 32 ? 1 : (32 / N > 8 ? 8 : 32 / N);
}

// CTAs an SM holds: two where a thread's beta and accumulator take at most
// 16 registers each (F <= 512 on the row path, 1024 < F <= 4096 on the
// column path), one otherwise. make_plan gives the first case the smaller
// ring that lets two CTAs share an SM's shared memory.
__host__ __device__ constexpr int ctas_per_sm(int values_per_thread) {
  return values_per_thread <= 16 ? 2 : 1;
}

// The U rows' margins, summed over the warp: on entry pm[u] is this lane's
// part of row u's; on return this lane holds the whole margin of row
// (lane / (32 / U)). log2(U) halving steps (each lane keeps half of the
// rows it carries and sends the other half to its partner) and then
// butterflies over the 32 / U lanes that share a row: U - 1 + 5 - log2(U)
// shuffles (9 at U = 8) where a butterfly per row takes 5 U (40). The order
// of the sums is fixed.
template <int U>
__device__ __forceinline__ float margin_scatter(float (&pm)[U], int lane) {
#pragma unroll
  for (int half = U / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? pm[half + i] : pm[i];
      const float send = upper ? pm[i] : pm[half + i];
      pm[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float v = pm[0];
#pragma unroll
  for (int off = 16 / U; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Ring {
  uint64_t* bars;
  __device__ __forceinline__ uint32_t full(int s) const { return smem_u32(bars + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return smem_u32(bars + kMaxStages + s); }
};

// Starts the copy of bytes [start, start + n) to `dst` + (start & 15): lane
// 0's bulk copy of the aligned interior (its bytes counted on `bar` by the
// caller's expect_tx), the lanes' direct loads of the head and the tail.
__device__ __forceinline__ void stage_copy(unsigned char* dst, unsigned long long start,
                                           unsigned long long n, uint32_t bar, int lane) {
  const EhSpan sp = eh_plan_bytes(start, start + n);
  // global byte a lands at dst + (a - lo)
  if (lane == 0 && sp.bulk_bytes)
    bulk_copy(smem_u32(dst + (sp.bulk_src - sp.lo)), sp.bulk_src,
              static_cast<uint32_t>(sp.bulk_bytes), bar);
  if (lane < static_cast<int>(sp.head_bytes))
    dst[sp.start - sp.lo + lane] = __ldg(reinterpret_cast<const unsigned char*>(sp.start + lane));
  if (lane >= 16 && lane - 16 < static_cast<int>(sp.tail_bytes))
    dst[sp.tail_src - sp.lo + lane - 16] =
        __ldg(reinterpret_cast<const unsigned char*>(sp.tail_src + lane - 16));
}

// the cluster barrier, which every thread of the cluster takes: arrive
// (release), then wait (acquire) before arriving again
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The producer warp: stage j of this unit's rows [row_begin, row_end) goes
// to slot j % stages as soon as the consumers have released it: one bulk
// copy of X's aligned interior (on the cluster path one for each row's
// tile, columns [col0, col0 + ncols)), the ragged heads and tails by direct
// loads, and each row's y and w by 4-byte cp.async copies. The slot's full
// barrier completes on the bulk copies' bytes, the 32 lanes' cp.async
// copies and one arrival after the heads and tails: the producer never
// waits on a load of its own. On the cluster path it also takes the
// consumers' cluster barrier of each stage: it arrives at stage j's, then
// fills stage j + stages - 1 (whose slot stage j - 1 frees), then waits,
// so that no barrier waits on a refill.
template <int MODE>
__device__ inline void produce(const Params& p, const Ring& ring, unsigned char* data, float* ys,
                               float* ws, long long row_begin, long long row_end, long long n_st,
                               int lane, long long col0, long long ncols, int es) {
  const Layout& L = p.L;
  const unsigned long long base = reinterpret_cast<unsigned long long>(p.X);
  const long long k = L.stage_rows;
  auto fill = [&](long long j) {
    const int s = static_cast<int>(j % L.stages);
    const uint32_t par = static_cast<uint32_t>((j / L.stages) & 1);
    mbar_wait(ring.empty(s), par ^ 1u);
    const long long g0 = row_begin + j * k;
    const long long g1 = min_ll(row_end, g0 + k);
    unsigned char* buf = data + static_cast<size_t>(s) * L.stage_bytes;
    if (lane == 0) {
      // order this slot's earlier generic writes (heads, tails) before the
      // async proxy's copies into it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      unsigned long long bulk = 0;
      if constexpr (MODE == kClusterPath) {
        for (long long g = g0; g < g1; ++g) {
          const unsigned long long a = base + g * p.row_bytes + col0 * es;
          bulk += eh_plan_bytes(a, a + ncols * es).bulk_bytes;
        }
      } else {
        bulk = eh_plan_span(base, g0, g1, p.row_bytes).bulk_bytes;
      }
      mbar_arrive_expect_tx(ring.full(s), static_cast<uint32_t>(bulk));
    }
    if constexpr (MODE == kClusterPath) {
      for (long long g = g0; g < g1; ++g)
        stage_copy(buf + (g - g0) * L.stride, base + g * p.row_bytes + col0 * es, ncols * es,
                   ring.full(s), lane);
    } else {
      stage_copy(buf, base + g0 * p.row_bytes, (g1 - g0) * p.row_bytes, ring.full(s), lane);
    }
    // y and w of each row: the stage's first slot segment, then (a stage
    // longer than what is left of a slot) the next slots in order
    const EhSegment seg = eh_plan_segment(g0, g1, p.R);
    const uint32_t yst = smem_u32(ys + s * L.meta_rows);
    const uint32_t wst = smem_u32(ws + s * L.meta_rows);
    for (int i = lane; i < g1 - g0; i += 32) {
      const long long g = g0 + i;
      const long long m =
          g < seg.end ? seg.slot
                      : seg.slot + 1 +
                            static_cast<unsigned>(g - seg.end) / static_cast<unsigned>(p.R);
      cp_async4(yst + 4 * i, p.y + g);
      cp_async4(wst + 4 * i, p.w + m);
    }
    cp_async_arrive_noinc(ring.full(s));
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.full(s));  // after the heads and tails
  };
  if constexpr (MODE == kClusterPath) {
    const long long pre = min_ll(n_st, L.stages - 1);
    for (long long j = 0; j < pre; ++j) fill(j);
    for (long long j = 0; j < n_st; ++j) {
      __syncwarp();
      cluster_arrive();  // stage j's margins (the consumers' barrier)
      if (j + L.stages - 1 < n_st) fill(j + L.stages - 1);
      __syncwarp();
      cluster_wait();
    }
  } else {
    for (long long j = 0; j < n_st; ++j) fill(j);
  }
}

// Row path: warp `warp` takes rows warp * U, warp * U + 8U, ... of each
// stage; lane l owns columns (32k + l) * VEC + v. On return the CTA's
// warps' accumulators are in red[warp][32 * VEC * CH] (the stages' memory).
template <typename T, int VEC, int CH>
__device__ void consume_rows(const Params& p, const Ring& ring, unsigned char* data,
                             const float* ys, const float* ws, long long row_begin,
                             long long row_end, long long n_st, int warp, int lane) {
  constexpr int U = unroll_for<VEC * CH>();
  const Layout& L = p.L;
  const unsigned long long base = reinterpret_cast<unsigned long long>(p.X);
  bool live[CH];
  float b[CH][VEC];
  float acc[CH][VEC];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c0 = (k * 32 + lane) * VEC;
    live[k] = c0 < p.F;  // F % VEC == 0, so a live vector is whole
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      b[k][v] = live[k] ? p.beta[c0 + v] : 0.0f;
      acc[k][v] = 0.0f;
    }
  }
  for (long long j = 0; j < n_st; ++j) {
    const int s = static_cast<int>(j % L.stages);
    const long long g0 = row_begin + j * L.stage_rows;
    const int rows = static_cast<int>(min_ll(L.stage_rows, row_end - g0));
    const unsigned char* rows0 = data + static_cast<size_t>(s) * L.stage_bytes +
                                 ((base + static_cast<unsigned long long>(g0) * p.row_bytes) & 15);
    const float* yst = ys + s * L.meta_rows;
    const float* wst = ws + s * L.meta_rows;
    mbar_wait(ring.full(s), static_cast<uint32_t>((j / L.stages) & 1));
    for (int i0 = warp * U; i0 < rows; i0 += kConsumerWarps * U) {
      float x[U][CH][VEC];
      float pm[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        const T* row = reinterpret_cast<const T*>(rows0 + static_cast<size_t>(i) * p.row_bytes);
        float acc_p = 0.0f;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          if (i < rows && live[k]) {
            Smem<T, VEC>::load(row + (k * 32 + lane) * VEC, x[u][k]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) x[u][k][v] = 0.0f;
          }
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc_p = fmaf(x[u][k][v], b[k][v], acc_p);
        }
        pm[u] = acc_p;
      }
      // each lane forms the residual of one row, then every lane takes
      // each row's from the first lane that holds it
      const int mine = lane / (32 / U);
      const float margin = margin_scatter<U>(pm, lane);
      // a masked row has x == 0 and s == 0: it contributes exactly 0
      const float s_mine = i0 + mine < rows
                               ? residual(margin, yst[i0 + mine], p.logistic) * wst[i0 + mine]
                               : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float sr = __shfl_sync(0xffffffffu, s_mine, u * (32 / U));
#pragma unroll
        for (int k = 0; k < CH; ++k) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(sr, x[u][k][v], acc[k][v]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }
  consumers_sync();  // every consumer is done with the stages' memory
  float* red = reinterpret_cast<float*>(data) + warp * (32 * VEC * CH);
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[(k * 32 + lane) * VEC + v] = acc[k][v];
  }
}

// Column and cluster paths: consumer thread t owns columns col0 + (256 jj +
// t) * VEC + v of every row (the CTA's tile: all F columns on the column
// path); a stage holds at most kColStageRows rows. A row's margin is summed
// over the warps in warp order and, on the cluster path, over the
// cluster's CTAs in rank order through distributed shared memory: every
// CTA of the cluster forms the same residual. Writes the tile of the
// unit's partial straight to `part` ([Fp]), columns [col0, col0 + pcols).
template <typename T, int VEC, int J, int MODE>
__device__ void consume_cols(const Params& p, const Ring& ring, unsigned char* data,
                             const float* ys, const float* ws, unsigned char* smem,
                             long long row_begin, long long row_end, long long n_st, int warp,
                             int lane, long long col0, int ncols, int pcols, float* part) {
  const Layout& L = p.L;
  const int t = threadIdx.x;
  const unsigned long long base = reinterpret_cast<unsigned long long>(p.X);
  const unsigned long long tile0 = base + static_cast<unsigned long long>(col0) * sizeof(T);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  float* xb = reinterpret_cast<float*>(smem + L.xb_off);
  float* sres = reinterpret_cast<float*>(smem + L.sres_off);
  bool live[J];
  float b[J][VEC];
  float acc[J][VEC];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    const int c0 = (jj * kConsumers + t) * VEC;
    live[jj] = c0 < ncols;  // ncols % VEC == 0, so a live vector is whole
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      b[jj][v] = live[jj] ? p.beta[col0 + c0 + v] : 0.0f;
      acc[jj][v] = 0.0f;
    }
  }
  for (long long j = 0; j < n_st; ++j) {
    const int s = static_cast<int>(j % L.stages);
    const long long g0 = row_begin + j * L.stage_rows;
    const int rows = static_cast<int>(min_ll(L.stage_rows, row_end - g0));
    const unsigned char* buf = data + static_cast<size_t>(s) * L.stage_bytes;
    // row i of the stage in shared memory, at its global alignment
    auto row_at = [&](int i) {
      const unsigned long long a = tile0 + static_cast<unsigned long long>(g0 + i) * p.row_bytes;
      if constexpr (MODE == kClusterPath)
        return reinterpret_cast<const T*>(buf + static_cast<size_t>(i) * L.stride + (a & 15));
      else
        return reinterpret_cast<const T*>(buf + ((tile0 + g0 * p.row_bytes) & 15) +
                                          static_cast<size_t>(i) * p.row_bytes);
    };
    const float* yst = ys + s * L.meta_rows;
    const float* wst = ws + s * L.meta_rows;
    float* rr = red + (j & 1) * (kConsumerWarps * kColStageRows);
    mbar_wait(ring.full(s), static_cast<uint32_t>((j / L.stages) & 1));
    for (int i = 0; i < rows; ++i) {
      const T* row = row_at(i);
      float d = 0.0f;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (live[jj]) {
          float x[VEC];
          Smem<T, VEC>::load(row + (jj * kConsumers + t) * VEC, x);
#pragma unroll
          for (int v = 0; v < VEC; ++v) d = fmaf(x[v], b[jj][v], d);
        }
      }
      d = warp_sum(d);
      if (lane == 0) rr[warp * kColStageRows + i] = d;
    }
    // rr alternates between two buffers: a warp writing stage j + 2's
    // margins has passed stage j + 1's barrier, so every warp is done
    // reading stage j's
    consumers_sync();
    if constexpr (MODE == kClusterPath) {
      // this CTA's part of each row's margin, then the cluster's: xb
      // alternates between two buffers, since a CTA writing stage j + 2's
      // has passed stage j + 1's cluster barrier, which every CTA takes
      // after reading stage j's
      float* xbj = xb + (j & 1) * kColStageRows;
      if (t < rows) {
        float pm = 0.0f;
#pragma unroll
        for (int q = 0; q < kConsumerWarps; ++q) pm += rr[q * kColStageRows + t];
        xbj[t] = pm;
      }
      cluster_sync();
      if (t < rows) {
        cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
        float pm = 0.0f;
        for (int k = 0; k < p.cluster; ++k) pm += *cl.map_shared_rank(xbj + t, k);
        sres[t] = residual(pm, yst[t], p.logistic) * wst[t];
      }
      consumers_sync();
    }
    for (int i = 0; i < rows; ++i) {
      float sr;
      if constexpr (MODE == kClusterPath) {
        sr = sres[i];
      } else {
        float pm = 0.0f;
#pragma unroll
        for (int q = 0; q < kConsumerWarps; ++q) pm += rr[q * kColStageRows + i];
        sr = residual(pm, yst[i], p.logistic) * wst[i];
      }
      const T* row = row_at(i);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (live[jj]) {
          float x[VEC];
          Smem<T, VEC>::load(row + (jj * kConsumers + t) * VEC, x);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[jj][v] = fmaf(sr, x[v], acc[jj][v]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = (jj * kConsumers + t) * VEC + v;
      if (c < pcols) part[col0 + c] = acc[jj][v];  // columns past F hold 0
    }
  }
}

// Re-read path, rows wider than a cluster holds: thread t owns columns
// (256 i + t) * VEC + v, its share of the unit's partial `part` ([Fp], in
// global memory) its accumulator. The CTA takes kRereadRows rows at a time:
// it reads them once for their margins (each summed over the threads, then
// the warps, in a fixed order) and again for s * x, adding the rows to the
// partial in row order, so the partial is read and written once a block.
constexpr int kRereadRows = 4;

template <int VEC>
__device__ __forceinline__ void load_part(const float* p, float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  } else {
    a[0] = *p;
  }
}

template <typename T, int VEC>
__device__ void consume_reread(const Params& p, float* red, long long row_begin,
                               long long row_end, int warp, int lane, float* part) {
  constexpr int B = kRereadRows;
  const int t = threadIdx.x;
  const T* X = reinterpret_cast<const T*>(p.X);
  for (int f = t * VEC; f < p.Fp; f += kConsumers * VEC) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) part[f + v] = 0.0f;
  }
  long long blk = 0;
  for (long long g0 = row_begin; g0 < row_end; g0 += B, ++blk) {
    const int nb = static_cast<int>(min_ll(B, row_end - g0));
    float d[B];
#pragma unroll
    for (int b = 0; b < B; ++b) d[b] = 0.0f;
#pragma unroll 2
    for (int f = t * VEC; f < p.F; f += kConsumers * VEC) {
      float bv[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) bv[v] = __ldg(p.beta + f + v);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (b < nb) {
          float x[VEC];
          Smem<T, VEC>::load(X + (g0 + b) * p.F + f, x);
#pragma unroll
          for (int v = 0; v < VEC; ++v) d[b] = fmaf(x[v], bv[v], d[b]);
        }
      }
    }
    // two buffers, as on the column path
    float* rr = red + (blk & 1) * (kConsumerWarps * B);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float sum = warp_sum(d[b]);
      if (lane == 0) rr[warp * B + b] = sum;
    }
    consumers_sync();
    float sr[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float pm = 0.0f;
#pragma unroll
      for (int q = 0; q < kConsumerWarps; ++q) pm += rr[q * B + b];
      const long long g = g0 + b;
      sr[b] = b < nb ? residual(pm, __ldg(p.y + g), p.logistic) * __ldg(p.w + g / p.R) : 0.0f;
    }
#pragma unroll 2
    for (int f = t * VEC; f < p.F; f += kConsumers * VEC) {
      float acc[VEC];
      load_part<VEC>(part + f, acc);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (b < nb) {
          float x[VEC];
          Smem<T, VEC>::load(X + (g0 + b) * p.F + f, x);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = fmaf(sr[b], x[v], acc[v]);
        }
      }
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(part + f) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        part[f] = acc[0];
      }
    }
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// a[c] = sum over rows i, i + step, ... < n of column q + c * kThreads of
// the [n, cols] float4 rows at `base` (0 past cols), NC columns at once and
// 16 / NC rows of each in flight
template <int NC>
__device__ __forceinline__ void sum_columns(const float4* __restrict__ base, int cols, int n,
                                            int q, int i, int step, float4 (&a)[NC]) {
  constexpr int RB = 16 / NC;
#pragma unroll
  for (int c = 0; c < NC; ++c) a[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (; i < n; i += RB * step) {
    float4 v[NC][RB];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int r = i + u * step;
        const int qc = q + c * kThreads;
        v[c][u] = r < n && qc < cols ? __ldcg(base + static_cast<size_t>(r) * cols + qc)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int u = 0; u < RB; ++u)
        if (i + u * step < n) add4(a[c], v[c][u]);
    }
  }
}

// dst[f] = sum over rows i < n of src[i * Fp + f], the rows added in index
// order (with several lanes per column, lane l sums rows l, l + pl, ... and
// the lanes are added in lane order). To `out` (TO_OUT): f < F, scalar
// stores; else all Fp columns, vector stores. `red` holds kThreads float4.
// Ends with a barrier (the caller's next use of `red` or of dst).
template <bool TO_OUT>
__device__ void sum_rows(const float* __restrict__ src, int n, int Fp, float* __restrict__ dst,
                         int F, float4* red) {
  const int tid = threadIdx.x;
  const int cols = Fp / 4;
  const float4* base = reinterpret_cast<const float4*>(src);
  auto store = [&](int q, const float4& a) {
    if constexpr (TO_OUT) {
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < F) dst[4 * q + e] = v[e];
    } else {
      reinterpret_cast<float4*>(dst)[q] = a;
    }
  };
  int pl = kThreads / cols;
  pl = pl < 1 ? 1 : pl;
  pl = pl > n ? n : pl;
  if (pl == 1) {  // wide: a thread per column, two columns at once
    for (int q = tid; q < cols; q += 2 * kThreads) {
      float4 a[2];
      sum_columns<2>(base, cols, n, q, 0, 1, a);
      store(q, a[0]);
      if (q + kThreads < cols) store(q + kThreads, a[1]);
    }
    __syncthreads();
    return;
  }
  const int cw = kThreads / pl;
  const int q_in = tid % cw;
  const int l = tid / cw;  // == pl for the last few threads: idle
  for (int q0 = 0; q0 < cols; q0 += cw) {
    const int q = q0 + q_in;
    if (l < pl) {
      float4 a[1];
      sum_columns<1>(base, cols, n, q, l, pl, a);
      red[l * cw + q_in] = a[0];
    }
    __syncthreads();
    if (l == 0 && q < cols) {
      float4 t = red[q_in];
      for (int e = 1; e < pl; ++e) add4(t, red[e * cw + q_in]);
      store(q, t);
    }
    __syncthreads();
  }
}

// One launch: the pipeline over this unit's rows, its [Fp] partial, then
// the two-level fixed-order reduction by the last CTAs to finish.
template <typename T, int VEC, int CH, int MODE>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(VEC* CH))
    glm_grad_onepass(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& L = p.L;
  const Ring ring{reinterpret_cast<uint64_t*>(smem)};
  float* ys = reinterpret_cast<float*>(smem + L.y_off);
  float* ws = reinterpret_cast<float*>(smem + L.w_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  int* flag = reinterpret_cast<int*>(smem + L.flag_off);
  unsigned char* data = smem + L.data_off;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int unit = blockIdx.x / p.cluster;
  const long long row_begin = eh_plan_row_begin(p.n_rows, p.n_units, unit);
  const long long row_end = eh_plan_row_begin(p.n_rows, p.n_units, unit + 1);
  float* part = p.partials + static_cast<size_t>(unit) * p.Fp;
  // this CTA's column tile [col0, col0 + ncols), and the partial's columns
  // it writes (the last tile also writes the zeros past F)
  long long col0 = 0;
  int ncols = p.F, pcols = p.Fp;
  if constexpr (MODE == kClusterPath) {
    const int k = static_cast<int>(cooperative_groups::this_cluster().block_rank());
    col0 = eh_plan_tile_begin(p.F, p.cluster, k);
    const long long col1 = eh_plan_tile_begin(p.F, p.cluster, k + 1);
    ncols = static_cast<int>(col1 - col0);
    pcols = static_cast<int>((k + 1 == p.cluster ? p.Fp : col1) - col0);
  }

  if constexpr (MODE == kRereadPath) {
    if (warp < kConsumerWarps) consume_reread<T, VEC>(p, red, row_begin, row_end, warp, lane, part);
  } else {
    const long long n_st = eh_plan_stages(row_begin, row_end, L.stage_rows);
    if (tid == 0) {
      for (int s = 0; s < L.stages; ++s) {
        mbar_init(ring.full(s), 34);  // expect_tx, 32 lanes' cp.async, heads/tails
        mbar_init(ring.empty(s), kConsumerWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == kConsumerWarps) {
      produce<MODE>(p, ring, data, ys, ws, row_begin, row_end, n_st, lane, col0, ncols,
                    sizeof(T));
    } else {
      if constexpr (MODE == kRowPath)
        consume_rows<T, VEC, CH>(p, ring, data, ys, ws, row_begin, row_end, n_st, warp, lane);
      else
        consume_cols<T, VEC, CH, MODE>(p, ring, data, ys, ws, smem, row_begin, row_end, n_st,
                                       warp, lane, col0, ncols, pcols, part);
    }
  }
  // no CTA of a cluster leaves while another may still read its margins
  if constexpr (MODE == kClusterPath) cluster_sync();
  __syncthreads();
  if constexpr (MODE == kRowPath) {  // the warps' accumulators, summed in warp order
    const float* wred = reinterpret_cast<const float*>(data);
    constexpr int kW = 32 * VEC * CH;  // >= Fp
    for (int f = tid; f < p.Fp; f += kThreads) {
      float total = 0.0f;
#pragma unroll
      for (int q = 0; q < kConsumerWarps; ++q) total += wred[q * kW + f];
      part[f] = total;
    }
  }
  // the CTA's writes are ordered before thread 0's fence by the barrier;
  // the fence makes them visible before its ticket (and, in the CTA that
  // draws the last ticket, orders the reads after it). A group's tickets
  // count its CTAs: every CTA of each of its units.
  __syncthreads();
  float4* red4 = reinterpret_cast<float4*>(data);
  const int grp = unit / p.group_size;
  const int first = grp * p.group_size;
  const int units = min(p.group_size, p.n_units - first);
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(p.tickets + grp, 1u) == static_cast<unsigned>(units * p.cluster - 1);
    __threadfence();
  }
  __syncthreads();
  if (!*flag) return;
  if (p.n_groups == 1) {  // one group: its last CTA writes the gradient
    sum_rows<true>(p.partials, units, p.Fp, p.out, p.F, red4);
    return;
  }
  sum_rows<false>(p.partials + static_cast<size_t>(first) * p.Fp, units, p.Fp,
                  p.gpartials + static_cast<size_t>(grp) * p.Fp, p.F, red4);
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(p.tickets + p.n_groups, 1u) == static_cast<unsigned>(p.n_groups - 1);
    __threadfence();
  }
  __syncthreads();
  if (!*flag) return;
  sum_rows<true>(p.gpartials, p.n_groups, p.Fp, p.out, p.F, red4);
}

using KernelFn = void (*)(const Params);

// The kernel, its dynamic shared memory limit raised on `device` (CUDA
// keeps that attribute per device) the first time it is asked for there.
template <typename T, int VEC, int CH, int MODE>
KernelFn kernel_ptr(int device) {
  static std::atomic<bool> attr_set[64];
  KernelFn fn = glm_grad_onepass<T, VEC, CH, MODE>;
  if (device < 0 || device >= 64) return nullptr;
  if (!attr_set[device].load(std::memory_order_acquire)) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax) !=
        cudaSuccess)
      return nullptr;
    attr_set[device].store(true, std::memory_order_release);
  }
  return fn;
}

// The instantiation for this width: the smallest CH (row path: 32-VEC-
// column chunks a lane owns) or J (column and cluster paths: 256-VEC-column
// chunks a thread owns of its tile) of a few that covers F. Fewer
// instantiations build faster; a lane's or thread's chunks past F cost a
// predicate each. The column path's two cover F <= 4096 (two CTAs an SM)
// and F <= kMaxCols; a cluster's tiles are wider than kMaxCols / 2.
template <typename T, int VEC>
KernelFn pick_vec(int F, int mode, int device) {
#define EH_ROW(C) \
  if (need <= C) return kernel_ptr<T, VEC, C, kRowPath>(device);
#define EH_COL(C) \
  if (need <= C) return kernel_ptr<T, VEC, C, kColPath>(device);
  if (mode == kRowPath) {
    const int need = (F + 32 * VEC - 1) / (32 * VEC);
    if constexpr (VEC == 4) {
      EH_ROW(1)
      EH_ROW(2)
      EH_ROW(4)
      EH_ROW(8)
    } else {
      EH_ROW(1)
      EH_ROW(4)
      EH_ROW(16)
      EH_ROW(32)
    }
  } else if (mode == kColPath) {
    const int need = (F + kConsumers * VEC - 1) / (kConsumers * VEC);
    EH_COL(16 / VEC)
    EH_COL(kMaxCols / (kConsumers * VEC))
  } else if (mode == kClusterPath) {
    return kernel_ptr<T, VEC, kMaxCols / (kConsumers * VEC), kClusterPath>(device);
  } else {
    return kernel_ptr<T, VEC, 1, kRereadPath>(device);
  }
#undef EH_ROW
#undef EH_COL
  return nullptr;
}

template <typename T>
KernelFn pick(int F, int mode, bool vec4, int device) {
  return vec4 ? pick_vec<T, 4>(F, mode, device) : pick_vec<T, 1>(F, mode, device);
}

// the kernel for a float32 (bfloat16) stack; each is defined, and its
// kernels instantiated, in its own translation unit
KernelFn pick_f32(int F, int mode, bool vec4, int device);   // fused_glm_grad.cu
KernelFn pick_bf16(int F, int mode, bool vec4, int device);  // fused_glm_grad_bf16.cu

}  // namespace eh_glm
