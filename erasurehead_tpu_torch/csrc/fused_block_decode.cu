// Decoded leaf gradients of the blockwise (layer-coded) step, for Hopper
// (sm_90a): every leaf of a round in one launch, for one trajectory or for a
// cohort of B trajectories at once.
//
// Replaces the Pallas TPU kernel erasurehead_tpu/ops/kernels.py::_decode_kernel
// (launched by erasurehead_tpu/ops/kernels.py::fused_block_decode). For each
// leaf of a table of up to kMaxLeaves leaves it computes
//
//     out[d] = sum_m w_m * g[j(m), d],   m = 0 .. M-1 in order,
//
// over M = W * S slots. The slot weights ws and each leaf g lie as the
// per-slot gradients come out of the step: ws [W, S] float32 and
// g [W, S, D] (row j = w * S + s at g + j * D). The faithful "ws" contract
// reduces s-major, m = s * W + w, so slot m reads row j(m) = (m % W) * S +
// m / W of ws and of g in place: no transposed copy. The partition-major "p"
// contract is the case S = 1 (j = m), and so is the single-leaf entry
// (ops/kernels.fused_block_decode). g is float32 or bfloat16 and out is [D]
// in g's type. For bfloat16 g, w is first rounded to bfloat16 (the JAX
// package's w.astype(g.dtype)), both operands are widened to float32, the
// sum runs in float32, and the result is rounded to bfloat16 once at the end.
//
// Rounding. Every step is acc = __fadd_rn(acc, __fmul_rn(w_m, g[j(m), d])):
// one rounded multiply and one rounded add, never contracted into an FMA,
// slots in order, one thread per column. The plain PyTorch version
// (ops/kernels.py::reference_block_decode on the s-major copy) takes the
// same steps, so the two are bitwise equal, and the treewise and fused
// lowerings of the step, which both reduce through this kernel, are bitwise
// equal to each other. Splitting M across threads would change the rounding,
// so the slots are never split.
//
// Bound: 2 operations per element of g against M*D*sizeof(g) + 4*M +
// D*sizeof(out) bytes, so bytes bound it. A deep round (M = 90; leaves of
// D = 4096, 4096, 128, 32, 1, 32 float32) moves 3.02 MB: 0.91 us at the H100
// SXM's 3.35 TB/s. At that size a launch is latency, not bandwidth.
//
// Design against that latency:
//  - One launch per round. The leaf table (g and out pointers, D, each
//    leaf's first tile) travels by value in the kernel's parameters as a
//    __grid_constant__ struct: no copy to the device, no extra launch. A
//    block finds its (leaf, column tile) from the tiles' prefix sums.
//  - All of a tile's loads in flight at once. A block owns a tile of
//    kTileBytes per row (64 float32 or 128 bfloat16 columns), so a
//    [90, 4096] float32 leaf spreads over 64 blocks, and its kThreads
//    threads stage the [M, tile] slab of g and the M weights into shared
//    memory in one burst of 16-byte cp.async copies (each slot's row index
//    computed once, so a copy's address costs a shared load and a
//    multiply-add). Then thread t sums column t over the slots in order
//    from shared memory (90 dependent adds: a fraction of a microsecond).
//    Where M exceeds kOneStageRows, the slots stage in chunks of
//    kChunkRows, in order, double-buffered: chunk c + 1 is in flight while
//    chunk c is summed.
//  - cp.async, not TMA: a tensor map per leaf would be built on the host at
//    every call (host work on a loop that is already host-bound), would
//    need 128 bytes per leaf in the parameters, and the slot order of the
//    "ws" contract gathers rows in a stride pattern that one box does not
//    describe. cp.async needs only the pointers already in the table. It
//    also beat staging through registers (cooperative 16-byte vector loads,
//    then stores to shared memory): on the H100 a deep round took 1.3x
//    longer that way (PERF.md), since a register load must return before
//    its store to shared memory can issue.
//  - Very wide leaves stream. Staging pays a fixed latency per tile and
//    leaves a tile's bytes idle while it sums; on a leaf whose rows reach
//    kStreamMinRowBytes (deepmlp's W_in at the covtype width: 1.99 MB) the
//    card's bandwidth sets the time instead, and a tile of kThreads * 16
//    bytes per row streams through registers, each thread walking the slots
//    in order with several loads in flight (the previous design of this
//    kernel). The same rounded steps in the same order: the result does not
//    depend on the path. On the H100, staging was the faster or level below
//    the threshold, and only streaming kept [90, 496288] above 85% of its
//    bound in every call; the gap there is about the spread between calls
//    (PERF.md). chip_smoke.py times one width on each side.
//  - Rows whose 16-byte pieces are not aligned (D * sizeof(g) % 16 != 0,
//    or g not 16-byte aligned, e.g. a D = 1 leaf) stage element by element.
//
// Trajectory cohorts (train/trainer.train_cohort). A cohort of B trajectories
// shares one data stack, so each leaf arrives as [B, W, S, D] and the weights
// as [B, W, S]: trajectory b's slots sit at ws + b * M and g + b * M * D, and
// its result at out + b * D. The grid gains a second dimension, blockIdx.y =
// b, so one launch decodes every leaf of every trajectory of a round: the
// cohort's decode costs one launch a round, not B. Each (trajectory, leaf,
// tile) block does exactly what the one-trajectory launch does (B = 1), in
// the same order, so the cohort launch is bitwise equal to B one-trajectory
// launches and to the plain version's per-trajectory loop. The bound is the
// bytes once, B times those of one trajectory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTileBytes = 256;     // one tile row: 64 float32 / 128 bfloat16 columns
constexpr int kThreads = 256;       // a block: all stage, one thread per column sums
constexpr int kMaxLeaves = 32;      // leaves per launch
constexpr int kOneStageRows = 128;  // M up to this stages in one burst
constexpr int kChunkRows = 64;      // beyond it: chunks of this many slots, two buffers
// leaves with rows at least this wide stream through registers instead
constexpr long long kStreamMinRowBytes = 1536 * 1024;

struct Leaf {
  const void* g;         // [W, S, D]
  void* out;             // [D]
  long long D;
  long long first_tile;  // tiles of the leaves before this one
  int vec;               // rows are read as 16-byte pieces
  int stream;            // tiles of kThreads * 16 bytes stream through registers
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// w in g's type, widened: float32 as is, bfloat16 rounded first
template <typename T>
__device__ __forceinline__ float slot_weight(float w);

template <>
__device__ __forceinline__ float slot_weight<float>(float w) {
  return w;
}

template <>
__device__ __forceinline__ float slot_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Slot m of the s-major order reads row j(m) = w * S + s of [W, S, ...].
__device__ __forceinline__ long long slot_row(int m, int W, int S) {
  return static_cast<long long>(m % W) * S + m / W;
}

// Stage slots [m0, m0 + n) of the tile [col0, col0 + cols) into one buffer:
// g rows to gs[n][kCols], their weights to wsm[n]. One commit group. Each
// slot's row is computed once (slot_rows[], shared); then thread t copies
// 16-byte piece t % kPieces of every kThreads / kPieces-th row, so a piece's
// address costs one shared load and one multiply-add.
template <typename T>
__device__ __forceinline__ void stage(const Leaf& leaf, const float* __restrict__ ws,
                                      int W, int S, int m0, int n, long long col0,
                                      int cols, T* gs, float* wsm, int* slot_rows) {
  constexpr int kCols = kTileBytes / sizeof(T);
  const T* g = static_cast<const T*>(leaf.g) + col0;
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const long long j = slot_row(m0 + r, W, S);
    slot_rows[r] = static_cast<int>(j);
    cp_async4(wsm + r, ws + j);
  }
  __syncthreads();
  if (leaf.vec) {
    // cols * sizeof(T) is a multiple of 16 here: D * sizeof(T) is, and
    // col0 is a multiple of the tile
    constexpr int kPer = 16 / sizeof(T), kPieces = kTileBytes / 16;
    const int c = threadIdx.x % kPieces;
    if (c * kPer < cols) {
      for (int r = threadIdx.x / kPieces; r < n; r += kThreads / kPieces) {
        const T* src = g + slot_rows[r] * leaf.D + c * kPer;
        cp_async16(gs + r * kCols + c * kPer, src);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * cols; i += kThreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      gs[r * kCols + c] = g[slot_rows[r] * leaf.D + c];
    }
  }
  cp_async_commit();
}

// 16 bytes of g widened to float32, and 16 / sizeof(T) sums stored in T
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) store(p + k, v[k]);
}

// A streamed tile: thread t owns 16 bytes of columns and walks the slots in
// order, reading each slot's row in place with up to four loads in flight.
// No shared memory and no barrier: on a leaf this wide the card's bandwidth,
// not one tile's latency, sets the time, and loads stay in flight all along.
template <typename T>
__device__ __forceinline__ void stream_tile(const Leaf& leaf, const float* __restrict__ ws,
                                            int W, int S, long long col0) {
  constexpr int VEC = 16 / sizeof(T);
  const long long col = col0 + static_cast<long long>(threadIdx.x) * VEC;
  if (col >= leaf.D) return;
  const T* g = static_cast<const T*>(leaf.g) + col;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  int w = 0, s = 0;  // slot m = s * W + w reads row w * S + s
#pragma unroll 4
  for (int m = 0; m < W * S; ++m) {
    const long long j = static_cast<long long>(w) * S + s;
    const float wm = slot_weight<T>(__ldg(ws + j));
    float v[VEC];
    load16(g + j * leaf.D, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wm, v[k]));
    if (++w == W) {
      w = 0;
      ++s;
    }
  }
  store_cols<T, VEC>(static_cast<T*>(leaf.out) + col, acc);
}

// One block per (leaf, column tile). A staged tile: kThreads stage it, and
// thread t < cols sums column t. A streamed tile: see stream_tile.
// blockIdx.y is the trajectory: its weights, slots and results lie at the
// offsets of the [B, ...] layout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_decode_leaves(const __grid_constant__ LeafTable table,
                        const float* __restrict__ ws, int W, int S) {
  constexpr int kCols = kTileBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];

  int li = 0;
  while (li + 1 < table.n && blockIdx.x >= table.leaf[li + 1].first_tile) ++li;
  const int M = W * S;
  const long long traj = blockIdx.y;
  Leaf leaf = table.leaf[li];
  leaf.g = static_cast<const T*>(leaf.g) + traj * M * leaf.D;
  leaf.out = static_cast<T*>(leaf.out) + traj * leaf.D;
  ws += traj * M;
  if (leaf.stream) {
    stream_tile<T>(leaf, ws, W, S, (blockIdx.x - leaf.first_tile) * (kThreads * 16 / sizeof(T)));
    return;
  }
  const long long col0 = (blockIdx.x - leaf.first_tile) * kCols;
  const int cols = static_cast<int>(min(static_cast<long long>(kCols), leaf.D - col0));

  const int rows = M <= kOneStageRows ? M : kChunkRows;  // slots per stage
  const int chunks = (M + rows - 1) / rows;
  const int bufs = chunks > 1 ? 2 : 1;
  T* gs = reinterpret_cast<T*>(smem);  // [bufs][rows][kCols]
  float* wsm = reinterpret_cast<float*>(smem + bufs * rows * kTileBytes);  // [bufs][rows]
  // [bufs][rows]: a fast thread stages chunk c + 1 while others still read
  // chunk c's rows
  int* rowj = reinterpret_cast<int*>(wsm + bufs * rows);

  stage<T>(leaf, ws, W, S, 0, min(rows, M), col0, cols, gs, wsm, rowj);
  float acc = 0.0f;
  const int t = threadIdx.x;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      const int b = (c + 1) & 1, m0 = (c + 1) * rows;
      stage<T>(leaf, ws, W, S, m0, min(rows, M - m0), col0, cols,
               gs + b * rows * kCols, wsm + b * rows, rowj + b * rows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t < cols) {
      const int b = c & 1, n = min(rows, M - c * rows);
      const T* col = gs + b * rows * kCols + t;
      const float* wc = wsm + b * rows;
#pragma unroll 8
      for (int r = 0; r < n; ++r)
        acc = __fadd_rn(acc, __fmul_rn(slot_weight<T>(wc[r]), widen(col[r * kCols])));
    }
    __syncthreads();  // buffer c & 1 is staged again at c + 2
  }
  if (t < cols) store(static_cast<T*>(leaf.out) + col0 + t, acc);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

int eh_fused_block_decode_max_leaves() { return kMaxLeaves; }

// For each of the B trajectories and each of the n leaves:
// out[i][b, :D[i]] = sum over the W * S slots, s-major, of
// ws[b, w, s] * g[i][b, w, s, :], all in ONE launch on `stream` (B = 1: one
// trajectory's [W, S] weights and [W, S, D] leaves). dtype: 0 = float32,
// 1 = bfloat16 (every g and out). Returns cudaGetLastError() after the
// launch (0 = success), or cudaErrorInvalidValue without launching.
int eh_fused_block_decode_leaves(const void* ws, const void* const* g, void* const* out,
                                 const long long* D, int n, int W, int S, int B, int dtype,
                                 void* stream_ptr) {
  if (n < 1 || n > kMaxLeaves || W < 1 || S < 1 || B < 1 || B > 65535 ||
      static_cast<long long>(W) * S > INT_MAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int itemsize = dtype == 0 ? 4 : 2;
  const long long cols = kTileBytes / itemsize;
  LeafTable table{};
  table.n = n;
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (D[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = (D[i] * itemsize) % 16 == 0 && aligned(g[i], 16);
    const bool stream = vec && D[i] * itemsize >= kStreamMinRowBytes;
    table.leaf[i] = Leaf{g[i], out[i], D[i], tiles, vec, stream};
    const long long tile_cols = stream ? kThreads * 16 / itemsize : cols;
    tiles += (D[i] + tile_cols - 1) / tile_cols;
  }
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);  // grid.x
  const int M = W * S;
  const int rows = M <= kOneStageRows ? M : kChunkRows;
  const size_t smem = static_cast<size_t>(M <= kOneStageRows ? 1 : 2) * rows *
                      (kTileBytes + sizeof(float) + sizeof(int));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* wf = static_cast<const float*>(ws);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  if (dtype == 0)
    block_decode_leaves<float><<<grid, kThreads, smem, stream>>>(table, wf, W, S);
  else
    block_decode_leaves<__nv_bfloat16><<<grid, kThreads, smem, stream>>>(table, wf, W, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
