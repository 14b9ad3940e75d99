// Decoded leaf gradient of the blockwise (layer-coded) step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel erasurehead_tpu/ops/kernels.py::_decode_kernel
// (launched by erasurehead_tpu/ops/kernels.py::fused_block_decode). It computes
//
//     out[d] = sum_m w[m] * g[m, d],   m = 0 .. M-1 in order,
//
// for w [M] float32 and g [M, D] float32 or bfloat16; out is [D] in g's
// type. For bfloat16 g, w is first rounded to bfloat16 (the JAX package's
// w.astype(g.dtype)), both operands are widened to float32, the sum runs in
// float32, and the result is rounded to bfloat16 once at the end.
//
// Rounding. Every step is acc = __fadd_rn(acc, __fmul_rn(w[m], g[m, d])):
// one rounded multiply and one rounded add, never contracted into an FMA,
// slots in order. The plain PyTorch version (ops/kernels.py::
// reference_block_decode) takes the same steps, so the two are bitwise
// equal, and the treewise and fused lowerings of the step, which both
// reduce through this kernel, are bitwise equal to each other.
//
// Bound: the kernel does 2 operations per element of g and moves
// M*D*sizeof(g) + 4*M + D*sizeof(out) bytes, so bytes bound it. At the deep
// path's six leaves (M = 90, D = 4096, 4096, 128, 32, 32, 1, float32) that
// is about 3.0 MB a round, 0.9 us at the H100 SXM's 3.35 TB/s: far below
// one launch's cost, so the kernel is launch-bound there.
//
// Design. The TPU kernel ran one HIGHEST-precision dot over a column block
// of up to 2048 columns (sized for VMEM) per grid step. Here a column
// belongs to exactly one thread, which walks the M slots in order: no
// atomics, no reduction across threads or blocks, no scratch, and reruns
// are bitwise identical. Each thread owns VEC adjacent columns: VEC = 4
// (one 16-byte load per slot) for float32 when D % 4 == 0 and both pointers
// are 16-byte aligned; VEC = 2 (one __nv_bfloat162) for bfloat16 when
// D % 2 == 0 and the pointers are 4-byte aligned; VEC = 1 otherwise.
// Neighbouring threads own neighbouring columns, so each slot's row is read
// coalesced. The ragged tail of D is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct Cols;

template <>
struct Cols<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Cols<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};

template <>
struct Cols<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[2]) {
    const unsigned int bits = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 q =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
    v[0] = q.x;
    v[1] = q.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[2]) {
    __nv_bfloat162 q;
    q.x = __float2bfloat16_rn(v[0]);
    q.y = __float2bfloat16_rn(v[1]);
    *reinterpret_cast<__nv_bfloat162*>(p) = q;
  }
};

template <>
struct Cols<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __bfloat162float(__ushort_as_bfloat16(bits));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

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

// One thread per VEC adjacent columns. The entry takes VEC > 1 only when
// D % VEC == 0, so a thread's columns lie all below D or all past it, and
// `col < D` masks the grid's ragged tail.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    block_decode(const float* __restrict__ w, const T* __restrict__ g,
                 T* __restrict__ out, int M, long long D) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (col >= D) return;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  const T* p = g + col;
#pragma unroll 4
  for (int m = 0; m < M; ++m) {
    const float wm = slot_weight<T>(__ldg(w + m));
    float v[VEC];
    Cols<T, VEC>::load(p + static_cast<long long>(m) * D, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wm, v[k]));
  }
  Cols<T, VEC>::store(out + col, acc);
}

template <typename T, int VEC>
void launch(const float* w, const void* g, void* out, int M, long long D,
            cudaStream_t stream) {
  const long long groups = (D + VEC - 1) / VEC;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  block_decode<T, VEC><<<blocks, kThreads, 0, stream>>>(
      w, static_cast<const T*>(g), static_cast<T*>(out), M, D);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// out[D] = sum_m w[m] * g[m, :] on `stream`. dtype: 0 = float32,
// 1 = bfloat16 (g and out). Returns cudaGetLastError() after the launch
// (0 = success).
int eh_fused_block_decode(const void* w, const void* g, void* out, int M,
                          long long D, int dtype, void* stream_ptr) {
  if (M < 1 || D < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // grid.x is at most 2^31 - 1 blocks
  if ((D + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) {
    if (D % 4 == 0 && aligned(g, 16) && aligned(out, 16))
      launch<float, 4>(wf, g, out, M, D, stream);
    else
      launch<float, 1>(wf, g, out, M, D, stream);
  } else {
    if (D % 2 == 0 && aligned(g, 4) && aligned(out, 4))
      launch<__nv_bfloat16, 2>(wf, g, out, M, D, stream);
    else
      launch<__nv_bfloat16, 1>(wf, g, out, M, D, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
