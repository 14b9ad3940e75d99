"""Device: the share of a dispatch's wall time with no kernel, copy or
memset on the card, in %. The busy seconds are the traced stretch's (one
dispatch after the window, under torch.profiler); the wall time is the same
dispatch's, inputs and all, run untraced just before it, since the
profiler's records of every launch lengthen the traced stretch by 1.3 to 2
times."""


def read(ctx):
    p = ctx.prof
    if p is None or p["n_device_events"] == 0 or p["untraced_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["untraced_s"])
