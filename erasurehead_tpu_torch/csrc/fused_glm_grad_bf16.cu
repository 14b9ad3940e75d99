// Kernel B1's bfloat16 kernels (the design is in fused_glm_grad.cu): a
// translation unit of their own, so that nvcc builds them beside the
// float32 half.

#include "fused_glm_grad.cuh"

namespace eh_glm {

KernelFn pick_bf16(int F, int mode, bool vec4, int device) {
  return pick<__nv_bfloat16>(F, mode, vec4, device);
}

}  // namespace eh_glm
