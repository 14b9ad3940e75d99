"""Step GLM on a sparse stack (parallel/step.py; ops/features.py, the gathers and scatters):
the round loop's share of its bytes roofline (roofline.loop_share)."""

import roofline


def read(ctx):
    return roofline.loop_share(ctx)
