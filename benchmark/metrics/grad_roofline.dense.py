"""Step GLM on a dense stack (parallel/step.py; ops/kernels.py and csrc/fused_glm_grad*, kernel B1):
the round loop's share of its bytes roofline (roofline.loop_share)."""

import roofline


def read(ctx):
    return roofline.loop_share(ctx)
