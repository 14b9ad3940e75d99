"""Sweep runner, set-up and replay (train/experiments.py, train()'s set-up,
train/evaluate.py): the window's seconds outside the round loops, a
trajectory, in milliseconds."""


def read(ctx):
    if not ctx.trajectories:
        return None
    return 1e3 * (ctx.window_s - ctx.loop_s) / ctx.trajectories
