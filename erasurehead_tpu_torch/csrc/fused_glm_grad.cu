// Decoded GLM gradient in one pass over X, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel erasurehead_tpu/ops/kernels.py::_kernel
// (launched by erasurehead_tpu/ops/kernels.py::fused_glm_grad). It computes
//
//     out[f] = sum_m w[m] * sum_r s(p[m,r], y[m,r]) * X[m,r,f],
//     p[m,r] = sum_f X[m,r,f] * beta[f],
//
// with the residual s = -y / (exp(p*y) + 1) (logistic) or s = -2 (y - p)
// (linear). X is [M, R, F] float32 or bfloat16 (upcast to float32 as it is
// loaded); y [M, R], beta [F] and w [M] are float32; out is [F] float32.
// Every product and sum is plain float32 (no tensor cores, no fast-math,
// expf rather than __expf), so the result matches the two-pass PyTorch
// version to float32 rounding.
//
// Bound: the work is about 4 flops per element of X, so the kernel is bound
// by the bytes it must move: one read of X, plus y, beta and w, plus the [F]
// output. At the flagship shape [90, 4400, 128] float32 that is
// 202,752,000 B of X (1,584,000 B of y): about 61 us at the H100 SXM's
// 3.35 TB/s. XLA's two-pass lowering read X twice.
//
// Design. The TPU kernel ran its (slot, row block) grid in order on one core
// and carried the [F] sum from step to step in its output block. Hopper
// blocks run in parallel and in no order, so the sum is split in two
// stages and nothing is carried between blocks:
//
//   Stage 1 writes one [F] partial per (slot m, chunk of kRowsPerBlock
//   rows) block. Each warp takes rows, reduces each row's margin with
//   butterfly shuffles, forms s = w[m] * residual, and accumulates s * x in
//   per-lane registers; at the end the block sums its warps' partials
//   through shared memory in warp order. Rows past R are masked (no padding
//   copy). Two forms, by width:
//
//   - glm_grad_partials (F <= kRegCols): every lane owns the same columns
//     for the whole launch, so beta lives in registers. A warp loads UNROLL
//     rows at a time with coalesced vector loads (16 B per lane for
//     float32, 8 B for bfloat16) and keeps them in registers between the
//     margin and the accumulate: X is read from device memory exactly once.
//
//   - glm_grad_partials_wide (F > kRegCols): a row no longer fits a lane's
//     registers. Each block also owns one tile of kTileCols columns. With
//     one tile (F <= kTileCols) a warp computes a row's margin over all F
//     columns (beta read through L1), then re-reads the row, which it has
//     just loaded, from L1/L2 for the accumulate: X crosses HBM once. With
//     several tiles every tile needs the row's residual, so a pre-pass,
//     glm_residuals, computes s once per row into scratch and each tile
//     block reads only its columns: X crosses HBM twice, where recomputing
//     the margin in every tile would read it once per tile.
//
//   Stage 2, glm_grad_reduce: sums the per-block partials in a fixed order.
//   There are no float atomics, so reruns are bitwise identical.
//
// Columns: with VEC = 4 (F % 4 == 0 and an aligned X) lane l owns columns
// 4*(32k + l) .. 4*(32k + l) + 3 of its range; with VEC = 1 it owns columns
// 32k + l.
//
// Every slot is computed, including slots whose weight is 0, as on the TPU.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 256;  // rows of one slot per stage-1 block
constexpr int kRegCols = 1024;      // widest F whose row stays in registers
constexpr int kTileCols = 2048;     // columns per block on the wide path
constexpr int kReduceCols = 32;     // stage 2: columns per block
constexpr int kReduceLanes = 16;    // stage 2: partial rows per block

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Loader<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct Loader<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __bfloat162float(__ushort_as_bfloat16(bits));
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

// p = sum_f row[f] * beta[f] over the whole row, reduced over the warp
template <typename T, int VEC>
__device__ __forceinline__ float row_margin(const T* __restrict__ row,
                                            const float* __restrict__ beta,
                                            int F, int lane) {
  float p = 0.0f;
  for (int c = lane * VEC; c < F; c += 32 * VEC) {
    float x[VEC];
    Loader<T, VEC>::load(row + c, x);
#pragma unroll
    for (int v = 0; v < VEC; ++v) p = fmaf(x[v], __ldg(beta + c + v), p);
  }
  return warp_sum(p);
}

// Sums the block's per-lane partials over its warps, in warp order, and
// writes the block's partial for columns [0, ncols) of its range to `out`.
// One 32*VEC-column chunk at a time through `red`, so shared memory stays
// small whatever the width.
template <int VEC, int CHUNKS>
__device__ __forceinline__ void store_block_partial(
    const float (&acc)[CHUNKS][VEC], float* __restrict__ out, int ncols,
    float (&red)[kWarps][32 * VEC]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    if (k * 32 * VEC < ncols) {  // uniform over the block
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[warp][lane * VEC + v] = acc[k][v];
      __syncthreads();
      const int c = k * 32 * VEC + threadIdx.x;
      if (threadIdx.x < 32 * VEC && c < ncols) {
        float total = 0.0f;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) total += red[j][threadIdx.x];
        out[c] = total;
      }
      __syncthreads();
    }
  }
}

// blockIdx.x = m * n_chunks + chunk
template <typename T, int VEC, int CHUNKS, int UNROLL>
__global__ void __launch_bounds__(kThreads)
    glm_grad_partials(const T* __restrict__ X, const float* __restrict__ y,
                      const float* __restrict__ beta,
                      const float* __restrict__ w,
                      float* __restrict__ partials, int R, int F,
                      int n_chunks, int logistic) {
  __shared__ float red[kWarps][32 * VEC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = blockIdx.x;
  const int m = block / n_chunks;
  const int row_begin = (block % n_chunks) * kRowsPerBlock;
  const int row_end = min(R, row_begin + kRowsPerBlock);
  const float wm = w[m];
  const T* Xm = X + static_cast<size_t>(m) * R * F;
  const float* ym = y + static_cast<size_t>(m) * R;

  bool live[CHUNKS];
  float b[CHUNKS][VEC];
  float acc[CHUNKS][VEC];
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int c0 = (k * 32 + lane) * VEC;
    live[k] = c0 < F;  // F % VEC == 0, so a live vector is whole
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      b[k][v] = live[k] ? beta[c0 + v] : 0.0f;
      acc[k][v] = 0.0f;
    }
  }

  for (int r0 = row_begin + warp * UNROLL; r0 < row_end;
       r0 += kWarps * UNROLL) {
    float x[UNROLL][CHUNKS][VEC];
    float p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u;
      const T* row = Xm + static_cast<size_t>(r) * F;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        if (r < row_end && live[k]) {
          Loader<T, VEC>::load(row + (k * 32 + lane) * VEC, x[u][k]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[u][k][v] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float acc_p = 0.0f;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc_p = fmaf(x[u][k][v], b[k][v], acc_p);
      }
      p[u] = acc_p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u;
      // a masked row has x == 0 and s == 0: it contributes exactly 0
      const float s = r < row_end ? residual(p[u], __ldg(ym + r), logistic) * wm
                                  : 0.0f;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(s, x[u][k][v], acc[k][v]);
      }
    }
  }
  store_block_partial<VEC, CHUNKS>(acc, partials + static_cast<size_t>(block) * F,
                                   F, red);
}

// s_out[g] = w[m] * residual(p[g], y[g]) for the flat row g = m * R + r,
// one warp per row and kWarps rows per block (a grid as fine as the rows,
// so that a few wide slots still fill the card)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    glm_residuals(const T* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ beta, const float* __restrict__ w,
                  float* __restrict__ s_out, long long n_rows, int R, int F,
                  int logistic) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= n_rows) return;  // no block-wide sync in this kernel
  const int lane = threadIdx.x & 31;
  const float p = row_margin<T, VEC>(X + g * F, beta, F, lane);
  if (lane == 0) s_out[g] = residual(p, __ldg(y + g), logistic) * w[g / R];
}

// blockIdx.x = (m * n_chunks + chunk) * n_tiles + tile. s_pre holds the
// rows' residuals when n_tiles > 1 (glm_residuals), else is null.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    glm_grad_partials_wide(const T* __restrict__ X,
                           const float* __restrict__ y,
                           const float* __restrict__ beta,
                           const float* __restrict__ w,
                           const float* __restrict__ s_pre,
                           float* __restrict__ partials, int R, int F,
                           int n_chunks, int n_tiles, int logistic) {
  constexpr int CHUNKS = kTileCols / (32 * VEC);
  __shared__ float red[kWarps][32 * VEC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = blockIdx.x / n_tiles;
  const int col0 = (blockIdx.x % n_tiles) * kTileCols;
  const int ncols = min(kTileCols, F - col0);
  const int m = block / n_chunks;
  const int row_begin = (block % n_chunks) * kRowsPerBlock;
  const int row_end = min(R, row_begin + kRowsPerBlock);
  const float wm = w[m];
  const T* Xm = X + static_cast<size_t>(m) * R * F;
  const float* ym = y + static_cast<size_t>(m) * R;

  float acc[CHUNKS][VEC];
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.0f;
  }

  for (int r = row_begin + warp; r < row_end; r += kWarps) {
    const T* row = Xm + static_cast<size_t>(r) * F;
    // one tile: the margin here, then the accumulate re-reads the row this
    // warp loaded a moment ago (L1/L2)
    const float s =
        s_pre != nullptr
            ? __ldg(s_pre + static_cast<size_t>(m) * R + r)
            : residual(row_margin<T, VEC>(row, beta, F, lane), __ldg(ym + r),
                       logistic) * wm;
    const T* tile = row + col0;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int c = (k * 32 + lane) * VEC;
      if (c < ncols) {
        float x[VEC];
        Loader<T, VEC>::load(tile + c, x);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = fmaf(s, x[v], acc[k][v]);
      }
    }
  }
  store_block_partial<VEC, CHUNKS>(
      acc, partials + static_cast<size_t>(block) * F + col0, ncols, red);
}

// out[c] = sum over the n_partials rows of partials[:, c], in a fixed order:
// lane row t sums rows t, t + kReduceLanes, ... in turn, then the block adds
// the kReduceLanes row sums in order.
__global__ void __launch_bounds__(kReduceCols * kReduceLanes)
    glm_grad_reduce(const float* __restrict__ partials,
                    float* __restrict__ out, int n_partials, int F) {
  __shared__ float sums[kReduceLanes][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  float total = 0.0f;
  if (c < F) {
    for (int b = threadIdx.y; b < n_partials; b += kReduceLanes)
      total += partials[static_cast<size_t>(b) * F + c];
  }
  sums[threadIdx.y][threadIdx.x] = total;
  __syncthreads();
  if (threadIdx.y == 0 && c < F) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kReduceLanes; ++j) acc += sums[j][threadIdx.x];
    out[c] = acc;
  }
}

template <int N>
constexpr int unroll_for() {
  // registers per lane for one row is VEC * CHUNKS; keep about 16 row
  // values in flight per lane, between 1 and 4 rows at a time
  return N >= 16 ? 1 : (16 / N > 4 ? 4 : 16 / N);
}

struct Shape {
  int M, R, F, n_chunks, n_tiles, logistic;
};

template <typename T, int VEC, int CHUNKS>
void launch_partials(const T* X, const float* y, const float* beta,
                     const float* w, float* partials, const Shape& s,
                     cudaStream_t stream) {
  constexpr int U = unroll_for<VEC * CHUNKS>();
  glm_grad_partials<T, VEC, CHUNKS, U><<<s.M * s.n_chunks, kThreads, 0, stream>>>(
      X, y, beta, w, partials, s.R, s.F, s.n_chunks, s.logistic);
}

// the register path with the smallest power-of-two CHUNKS that covers F,
// else the wide path
template <typename T, int VEC>
void launch_stage1(const T* X, const float* y, const float* beta,
                   const float* w, float* partials, const Shape& s,
                   cudaStream_t stream) {
  const int need = (s.F + 32 * VEC - 1) / (32 * VEC);
#define EH_CASE(C)                                                    \
  if (need <= C) {                                                    \
    launch_partials<T, VEC, C>(X, y, beta, w, partials, s, stream);   \
    return;                                                           \
  }
  EH_CASE(1)
  EH_CASE(2)
  EH_CASE(4)
  EH_CASE(8)
  if constexpr (VEC == 1) {
    EH_CASE(16)
    EH_CASE(32)
  }
#undef EH_CASE
  float* s_pre = nullptr;
  if (s.n_tiles > 1) {  // residuals after the partials in scratch
    s_pre = partials + static_cast<size_t>(s.M) * s.n_chunks * s.F;
    const long long n_rows = static_cast<long long>(s.M) * s.R;
    glm_residuals<T, VEC>
        <<<static_cast<int>((n_rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
            X, y, beta, w, s_pre, n_rows, s.R, s.F, s.logistic);
  }
  glm_grad_partials_wide<T, VEC>
      <<<s.M * s.n_chunks * s.n_tiles, kThreads, 0, stream>>>(
          X, y, beta, w, s_pre, partials, s.R, s.F, s.n_chunks, s.n_tiles,
          s.logistic);
}

template <typename T>
void launch_typed(const void* X, const float* y, const float* beta,
                  const float* w, float* partials, const Shape& s,
                  cudaStream_t stream) {
  const T* Xt = static_cast<const T*>(X);
  // rows start on 4-element boundaries when F % 4 == 0 and X itself does
  const bool vec4 = s.F % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(X) % (4 * sizeof(T)) == 0;
  if (vec4)
    launch_stage1<T, 4>(Xt, y, beta, w, partials, s, stream);
  else
    launch_stage1<T, 1>(Xt, y, beta, w, partials, s, stream);
}

long long n_chunks_for(int R) { return (R + kRowsPerBlock - 1) / kRowsPerBlock; }

long long n_tiles_for(int F) {
  return F <= kRegCols ? 1 : (F + kTileCols - 1) / kTileCols;
}

}  // namespace

extern "C" {

// Floats of scratch that eh_fused_glm_grad needs: one [F] partial per
// (slot, row chunk), then the [M, R] residuals when F takes several tiles.
long long eh_fused_glm_grad_scratch_floats(int M, int R, int F) {
  const long long partials = static_cast<long long>(M) * n_chunks_for(R) * F;
  return partials + (n_tiles_for(F) > 1 ? static_cast<long long>(M) * R : 0);
}

// Launches both stages on `stream`. `scratch` holds
// eh_fused_glm_grad_scratch_floats(M, R, F) floats. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launches (0 = success).
int eh_fused_glm_grad(const void* X, const void* y, const void* beta,
                      const void* w, void* out, void* scratch, int M, int R,
                      int F, int dtype, int logistic, void* stream_ptr) {
  if (M < 1 || R < 1 || F < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = n_chunks_for(R);
  const long long n_tiles = n_tiles_for(F);
  // grid.x and the block indices are int
  if (M * n_chunks * n_tiles > INT_MAX ||
      (n_tiles > 1 && (static_cast<long long>(M) * R + kWarps - 1) / kWarps > INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{M, R, F, static_cast<int>(n_chunks), static_cast<int>(n_tiles),
                logistic};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(beta);
  const float* wf = static_cast<const float*>(w);
  float* partials = static_cast<float*>(scratch);
  if (dtype == 0)
    launch_typed<float>(X, yf, bf, wf, partials, s, stream);
  else
    launch_typed<__nv_bfloat16>(X, yf, bf, wf, partials, s, stream);
  const dim3 grid((F + kReduceCols - 1) / kReduceCols);
  const dim3 block(kReduceCols, kReduceLanes);
  glm_grad_reduce<<<grid, block, 0, stream>>>(
      partials, static_cast<float*>(out), M * s.n_chunks, F);
  return static_cast<int>(cudaGetLastError());
}

const char* eh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
