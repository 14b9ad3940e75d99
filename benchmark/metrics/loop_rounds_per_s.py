"""Round loop (train/trainer.py, train/graphs.py): trajectory-rounds of the
window over the round loops' own seconds, the trainer's clock between
synchronizes (RunSummary.real_steps_per_sec; a cohort's loop counted once)."""


def read(ctx):
    return ctx.traj_rounds / ctx.loop_s if ctx.loop_s > 0 else None
