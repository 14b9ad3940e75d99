"""Faults planted in the port underneath a run, to see ``correct`` come out
false (tests/test_bench_faults.py on the CPU, calibrate.py ``--faults`` on
the card at a cell's full size). Each is a context manager that patches a
function of the port and puts it back on exit:

  unchanged   a step that returns its state unchanged
  half_rows   half of each gradient's rows left out, the rest counted double
  loss        a round's replayed train loss altered by 1e-3 where it is made
  clock       a round's simulated clock altered by 1e-9 s where it is made

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(*triples):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    try:
        for obj, name, value in triples:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def unchanged():
    from erasurehead_tpu_torch.train import optimizer

    return _patched(
        (optimizer, "make_table_update_fn",
         lambda rule, recip: lambda state, g, coef, alpha, n: state),
        (optimizer, "make_cohort_table_update_fn",
         lambda rule, recip: lambda state, g, eta, alpha, n, coef: state))


def _half_rows(grad_fn):
    """The gradient over the first half of each block's rows, counted
    double: the other half's labels are zeroed, so their residuals are."""
    import torch

    def half(params, X, y, w):
        keep = (torch.arange(y.shape[-1], device=y.device) < y.shape[-1] // 2).to(y.dtype)
        return 2.0 * grad_fn(params, X, y * keep, w)

    return half


def half_rows():
    from erasurehead_tpu_torch.train import trainer

    lowering, cohort = trainer._grad_lowering, trainer._cohort_lowering

    def halved(*args, **kw):
        fn, how = lowering(*args, **kw)
        return _half_rows(fn), how

    def halved_cohort(*args, **kw):
        fn, *rest = cohort(*args, **kw)
        return (_half_rows(fn), *rest)

    return _patched((trainer, "_grad_lowering", halved),
                    (trainer, "_cohort_lowering", halved_cohort))


def loss():
    import numpy as np

    from erasurehead_tpu_torch.train import evaluate

    replay = evaluate.replay

    def altered(*args, **kw):
        ev = replay(*args, **kw)
        out = np.array(ev.training_loss)
        out[len(out) // 2] *= 1.0 + 1e-3
        return dataclasses.replace(ev, training_loss=out)

    return _patched((evaluate, "replay", altered))


def clock():
    from erasurehead_tpu_torch.train import trainer

    build = trainer.build_schedule

    def late(*args, **kw):
        s = build(*args, **kw)
        t = s.sim_time.copy()
        t[-1] += 1e-9
        return dataclasses.replace(s, sim_time=t)

    return _patched((trainer, "build_schedule", late))


FAULTS = {"unchanged": unchanged, "half_rows": half_rows, "loss": loss, "clock": clock}
