"""Whole step: model FLOPs of the window's trajectory-rounds (roofline.py:
4 n F dense, 4 n K sparse, the faithful copies not counted) over the
window's seconds, against the card's float32 peak outside the tensor cores
(TF32 off), in %."""

import roofline


def read(ctx):
    if ctx.device_name is None or ctx.window_s <= 0:
        return None
    flops = ctx.traj_rounds * roofline.flops_per_trajectory_round(ctx.config)
    return 100.0 * flops / ctx.window_s / ctx.peaks()["fp32_flops_per_s"]
