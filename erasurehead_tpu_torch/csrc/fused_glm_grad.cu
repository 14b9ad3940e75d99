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
// read); y [M, R], beta [F] and w [M] are float32; out is [F] float32.
// Every product and sum is plain float32 (no tensor cores, no fast-math,
// expf rather than __expf), so the result matches the two-pass PyTorch
// version to float32 rounding. Every slot is computed, including slots
// whose weight is 0, as on the TPU.
//
// Bound: about 4 flops per element of X, so the bytes bound it: one read of
// X, plus y, beta and w, plus the [F] output. At the flagship shape
// [90, 4400, 128] float32 that is 202,752,000 B of X (1,584,000 B of y):
// about 61 us at the H100 SXM's 3.35 TB/s.
//
// Design. The TPU kernel ran its (slot, row block) grid in order on one core
// and carried the [F] sum from step to step in its output block. Here one
// launch does it all, at every width:
//
//   - A persistent grid sized from the card (make_plan): two CTAs an SM
//     where a thread's beta and accumulator fit 16 registers each
//     (F <= 512, and 1024 < F <= 4096), one otherwise, never more CTAs
//     than rows. A unit (a CTA, or on the cluster path a cluster) owns one
//     contiguous range of the flat rows g = m * R + r (glm_grad_plan.h), so
//     its share of X is one contiguous byte span whatever F is; a range may
//     cross slot boundaries, and each row carries its own slot's w[m].
//
//   - A ring of shared-memory stages fed by one producer warp: per stage,
//     one TMA bulk copy (cp.async.bulk with an mbarrier) of the span's
//     16-byte-aligned interior and direct loads of its ragged head and tail
//     (so F = 17, F = 15509 or an offset base pointer need no scalar-only
//     global path), plus each row's y and w by 4-byte cp.async copies that
//     complete on the same mbarrier, so the producer never waits on a load.
//     Three stages where two CTAs share an SM, four otherwise (three where
//     a stage is wider than a quarter of the budget); the producer refills
//     a stage as soon as 8 consumer warps release it, so the loads overlap
//     the margin, the exp and the accumulate.
//
//   - X crosses HBM once up to 131,072 columns: consumers take a row's
//     margin from shared memory and accumulate s * x from the same staged
//     bytes.
//       * Row path, F <= kRegCols: a warp takes a row at a time (UNROLL rows
//         interleaved), each lane owning fixed columns with beta and its
//         accumulator in registers; a reduce-scatter of shuffles gives each
//         lane one row's margin. At the end the CTA sums its warps'
//         accumulators in warp order.
//       * Column path, kRegCols < F <= kMaxCols: a stage holds 1-8 whole
//         rows and all 256 consumer threads split the columns, each with
//         its beta and accumulator in registers; a row's margin is summed
//         over the warps in warp order through shared memory.
//       * Cluster path, kMaxCols < F <= kMaxCluster * kMaxCols: a cluster
//         of ceil(F / kMaxCols) CTAs shares each row range; CTA k stages
//         column tile k of the same rows (each tile at its global
//         alignment) and runs the column path on it. Each CTA's part of a
//         row's margin goes to its shared memory; after a cluster barrier
//         every CTA adds the parts in rank order through distributed shared
//         memory, so all form the same residual. The grid holds as many
//         clusters as the card runs at once (cudaOccupancyMaxActiveClusters).
//     Wider rows than a cluster holds take the re-read path: one CTA an
//     SM reads a block of kRereadRows rows once for their margins and
//     again for s * x, and adds them to its partial in global memory.
//
//   - A deterministic reduction in the same launch: every unit writes its
//     [F] partial to scratch, fences, and each CTA takes a ticket of its
//     group; the last CTA of the group to finish sums the group's partials
//     in unit order. Small partials (units * F <= 65,536 floats, as at
//     F = 128) form one group, so that CTA writes the gradient; wider ones
//     form groups of about sqrt(units), whose last CTAs write group sums,
//     fence and take a ticket of the groups, and the last group sums the
//     group sums in group order. No float atomics: reruns, and CUDA-graph
//     replays, are bitwise equal. The tickets are zeroed by a memset node
//     before the kernel.

#include "fused_glm_grad.cuh"

namespace eh_glm {

KernelFn pick_f32(int F, int mode, bool vec4, int device) {
  return pick<float>(F, mode, vec4, device);
}

// ---------------------------------------------------------------------------
// Host side

int align_up(int v, int a) { return (v + a - 1) / a * a; }

struct Plan {
  int mode, Fp, row_bytes, n_units, cluster, n_ctas, group_size, n_groups;
  long long n_rows, tickets_floats, total_floats;
  Layout L;
};

int device_attr(cudaDeviceAttr attr, int device) {
  // one card's attributes, read once (a race writes the same value)
  static std::atomic<int> cache[2][64];
  const int slot = attr == cudaDevAttrMultiProcessorCount ? 0 : 1;
  if (device < 0 || device >= 64) return 0;
  int v = cache[slot][device].load(std::memory_order_relaxed);
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, attr, device) != cudaSuccess) return 0;
    cache[slot][device].store(v, std::memory_order_relaxed);
  }
  return v;
}

// A launch's configuration on the cluster path: clusters of `cluster` CTAs.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int n_ctas, int cluster, int smem_bytes, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(n_ctas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Clusters of `cluster` CTAs that `device` holds at once: a cluster's CTAs
// share one GPC, so the SM count alone overstates it. Asked once per card
// and cluster size (every cluster layout holds one CTA an SM); 0 if the
// runtime cannot say.
int active_clusters(int cluster, int smem_bytes, int dtype, int device) {
  static std::atomic<int> cache[64][kMaxCluster + 1];
  if (device < 0 || device >= 64) return 0;
  int v = cache[device][cluster].load(std::memory_order_relaxed);
  if (v == 0) {
    KernelFn fn = dtype == 0 ? pick_f32(0, kClusterPath, true, device)
                             : pick_bf16(0, kClusterPath, true, device);
    ClusterLaunch cl(cluster, cluster, smem_bytes, nullptr);
    if (fn == nullptr || cudaOccupancyMaxActiveClusters(&v, fn, &cl.cfg) != cudaSuccess || v < 1) {
      cudaGetLastError();  // clear it: the caller falls back to the SM count
      return 0;
    }
    cache[device][cluster].store(v, std::memory_order_relaxed);
  }
  return v;
}

// The launch's grid, shared memory and scratch for this shape on `device`;
// false if the kernel does not take it.
bool make_plan(int M, int R, int F, int dtype, int device, Plan* out) {
  if (M < 1 || R < 1 || F < 1 || (dtype != 0 && dtype != 1)) return false;
  Plan pl{};
  const int es = dtype == 0 ? 4 : 2;
  if (F > (1 << 28)) return false;  // a row's bytes are an int
  pl.Fp = align_up(F, 4);
  pl.row_bytes = F * es;
  pl.n_rows = static_cast<long long>(M) * R;
  pl.cluster = 1;
  if (F <= kRegCols) {
    pl.mode = kRowPath;
  } else if (F <= kMaxCols) {
    pl.mode = kColPath;
  } else if (eh_plan_tiles(F, kMaxCols) <= kMaxCluster) {
    pl.mode = kClusterPath;
    pl.cluster = eh_plan_tiles(F, kMaxCols);
  } else {
    pl.mode = kRereadPath;
  }
  Layout& L = pl.L;
  // F <= 512, or 1024 < F <= 4096: two CTAs an SM (ctas_per_sm), each
  // with a three-stage ring; otherwise one, with four stages where they fit
  const bool two = F <= 512 || (pl.mode == kColPath && F <= 4096);
  if (pl.mode == kRowPath) {
    L.stages = two ? 3 : kMaxStages;
    L.stage_bytes = kStageBytes;
    L.meta_rows = kRowStageRows;
    L.stage_rows = (kStageBytes - 16) / pl.row_bytes;
    if (L.stage_rows > kRowStageRows) L.stage_rows = kRowStageRows;
  } else if (pl.mode != kRereadPath) {
    L.meta_rows = kColStageRows;
    if (pl.mode == kColPath) {  // whole rows, contiguous
      L.stage_bytes = align_up(pl.row_bytes + 16, 128);
      if (L.stage_bytes < kStageBytes) L.stage_bytes = kStageBytes;
      L.stage_rows = (L.stage_bytes - 16) / pl.row_bytes;
    } else {
      // a row's tile every `stride` bytes, at its global alignment; as many
      // as a quarter of the budget holds, since a stage costs a cluster
      // barrier
      L.stride = align_up(static_cast<int>(eh_plan_tile_begin(F, pl.cluster, 1)) * es + 15, 16);
      L.stage_rows = kSmemBudget / kMaxStages / L.stride;
      if (L.stage_rows < 1) L.stage_rows = 1;
      L.stage_bytes = align_up(L.stage_rows * L.stride, 128);
    }
    if (L.stage_rows > kColStageRows) L.stage_rows = kColStageRows;
    L.stages = kSmemBudget / L.stage_bytes;
    if (L.stages > (two ? 3 : kMaxStages)) L.stages = two ? 3 : kMaxStages;
    if (L.stages < 2 || L.stage_rows < 1) return false;
  }
  L.y_off = 16 * kMaxStages;  // the barriers
  L.w_off = L.y_off + 4 * L.stages * L.meta_rows;
  L.red_off = L.w_off + 4 * L.stages * L.meta_rows;
  L.xb_off = L.red_off + 4 * 2 * kConsumerWarps * kColStageRows;
  L.sres_off = L.xb_off + 4 * 2 * kColStageRows;
  L.flag_off = L.sres_off + 4 * kColStageRows;
  L.data_off = align_up(L.flag_off + 16, 128);
  // the stages' memory later holds the row path's warp accumulators and
  // the reduction's lane sums
  int data_bytes = L.stages * L.stage_bytes;
  if (pl.mode == kRowPath && data_bytes < kConsumerWarps * kRegCols * 4) return false;
  if (data_bytes < kThreads * 16) data_bytes = kThreads * 16;
  L.smem_bytes = L.data_off + data_bytes;
  if (L.smem_bytes > kSmemMax) return false;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, device);
  const int smem_sm = device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (sms < 1 || smem_sm < 1) return false;
  int per_sm = smem_sm / (L.smem_bytes + 1024);  // 1 KB the runtime reserves per CTA
  if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
  if (per_sm < 1) return false;
  long long max_units = static_cast<long long>(sms) * per_sm / pl.cluster;
  if (pl.mode == kClusterPath) {
    const int held = active_clusters(pl.cluster, L.smem_bytes, dtype, device);
    if (held > 0 && held < max_units) max_units = held;
  }
  if (pl.mode == kRereadPath) max_units = sms;  // a partial of F floats each
  if (max_units < 1) max_units = 1;
  pl.n_units = static_cast<int>(eh_plan_grid(pl.n_rows, max_units));
  pl.n_ctas = pl.n_units * pl.cluster;
  pl.group_size = eh_plan_group_size(pl.n_units, pl.Fp);
  pl.n_groups = eh_plan_groups(pl.n_units, pl.Fp);
  pl.tickets_floats = align_up(pl.n_groups + 1, 4);
  pl.total_floats =
      pl.tickets_floats + static_cast<long long>(pl.n_units + pl.n_groups) * pl.Fp;
  *out = pl;
  return true;
}

}  // namespace eh_glm

using namespace eh_glm;

extern "C" {

// Floats of scratch that eh_fused_glm_grad needs on `device`: the tickets,
// one [Fp] partial per unit (a CTA, or a cluster of them) and one per
// reduction group (Fp = F rounded up to 4). 0 if the kernel does not take
// the shape.
long long eh_fused_glm_grad_scratch_floats(int M, int R, int F, int dtype, int device) {
  Plan pl;
  return make_plan(M, R, F, dtype, device, &pl) ? pl.total_floats : 0;
}

// Zeroes the tickets and launches the kernel on `stream` (of `device`, the
// current device). `scratch` holds eh_fused_glm_grad_scratch_floats(...)
// floats, 16-byte aligned. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = success).
int eh_fused_glm_grad(const void* X, const void* y, const void* beta, const void* w, void* out,
                      void* scratch, int M, int R, int F, int dtype, int logistic, int device,
                      void* stream_ptr) {
  Plan pl;
  if (!make_plan(M, R, F, dtype, device, &pl) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  // rows (and tiles, 4-column multiples) start on 4-element boundaries
  // when F % 4 == 0 and X itself does; a row keeps its global alignment in
  // shared memory
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(X) % (4 * es) == 0;
  KernelFn fn =
      dtype == 0 ? pick_f32(F, pl.mode, vec4, device) : pick_bf16(F, pl.mode, vec4, device);
  if (fn == nullptr) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* base = static_cast<float*>(scratch);
  Params p;
  p.X = X;
  p.y = static_cast<const float*>(y);
  p.beta = static_cast<const float*>(beta);
  p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  p.tickets = reinterpret_cast<unsigned*>(base);
  p.partials = base + pl.tickets_floats;
  p.gpartials = p.partials + static_cast<size_t>(pl.n_units) * pl.Fp;
  p.n_rows = pl.n_rows;
  p.R = R;
  p.F = F;
  p.Fp = pl.Fp;
  p.row_bytes = pl.row_bytes;
  p.n_units = pl.n_units;
  p.cluster = pl.cluster;
  p.group_size = pl.group_size;
  p.n_groups = pl.n_groups;
  p.logistic = logistic;
  p.L = pl.L;
  cudaError_t e = cudaMemsetAsync(p.tickets, 0, sizeof(unsigned) * (pl.n_groups + 1), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pl.cluster == 1) {
    fn<<<pl.n_ctas, kThreads, pl.L.smem_bytes, stream>>>(p);
  } else {
    ClusterLaunch cl(pl.n_ctas, pl.cluster, pl.L.smem_bytes, stream);
    e = cudaLaunchKernelEx(&cl.cfg, fn, p);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* eh_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
