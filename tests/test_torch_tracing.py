"""The port's tracing (utils/tracing.py): ``device_trace`` around a run and
``annotate``'s named regions.

``device_trace(None)`` does nothing; ``device_trace(dir)`` on the CPU writes
one Chrome trace whose host spans carry the JAX package's region names
(``eh_scan/coded_step``, ``eh_scan/update``, ``eh_step/partial_grads``,
``eh_step/decode``) once a round; ``annotate`` takes no profiler call while
no trace is active (the round loop's cost of an untraced run); a failed
export raises; traces do not nest; ``StepTimer`` keeps JAX's laps.
"""

import json
import os

import numpy as np
import pytest
import torch

from erasurehead_tpu.utils import tracing as j_tracing
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import tracing as t_tracing
from erasurehead_tpu_torch.utils.config import RunConfig

W, ROWS, COLS, ROUNDS = 4, 256, 16, 10


@pytest.fixture(scope="module")
def data():
    return generate_gmm(ROWS, COLS, n_partitions=W, seed=0)


def _cfg(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=3, rounds=ROUNDS,
                n_rows=ROWS, n_cols=COLS, lr_schedule=1.0, add_delay=True, seed=0)
    base.update(kw)
    return RunConfig(**base)


def _untraced() -> bool:
    """No trace in progress: every region is the one shared null context."""
    return t_tracing.annotate("a") is t_tracing.annotate("b")


def _span_names(trace):
    events = json.load(open(trace.path))["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_no_directory_is_a_no_op():
    with t_tracing.device_trace(None) as tr:
        assert tr is None and _untraced()
    with t_tracing.device_trace("") as tr:
        assert tr is None


@pytest.mark.parametrize("kw,regions", [
    (dict(), ("eh_scan/coded_step", "eh_scan/update", "eh_step/partial_grads")),
    (dict(use_pallas="off", compute_mode="deduped"),
     ("eh_scan/coded_step", "eh_scan/update", "eh_step/partial_grads", "eh_step/decode")),
    (dict(model="deepmlp", layer_coding="on", update_rule="GD", lr_schedule=0.5),
     ("eh_scan/coded_step", "eh_scan/update", "eh_step/partial_grads", "eh_step/decode")),
])
def test_cpu_trace_holds_a_span_per_round(data, tmp_path, kw, regions):
    cfg = _cfg(**kw)
    plain = t_trainer.train(cfg, data, device="cpu")
    with t_tracing.device_trace(str(tmp_path), device="cpu") as tr:
        assert not _untraced() and tr.path is None
        traced = t_trainer.train(cfg, data, device="cpu")
    assert _untraced()
    assert os.listdir(tmp_path) == [os.path.basename(tr.path)]
    assert tr.path.endswith(".pt.trace.json")
    names = _span_names(tr)
    for region in regions:
        assert names.count(region) == ROUNDS, region
    for a, b in zip(torch.utils._pytree.tree_leaves(plain.params_history),
                    torch.utils._pytree.tree_leaves(traced.params_history)):
        assert torch.equal(a, b)


def test_annotate_takes_no_profiler_call_without_a_trace(monkeypatch, data, tmp_path):
    calls = []

    class Spy:
        def __init__(self, name):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    t_trainer.train(_cfg(rounds=3), data, device="cpu")
    with t_tracing.annotate("eh_scan/coded_step"):
        pass
    assert calls == []
    assert t_tracing.annotate("a") is t_tracing.annotate("b")  # one shared null region
    with t_tracing.device_trace(str(tmp_path), device="cpu"):
        with t_tracing.annotate("eh_scan/coded_step"):
            pass
    assert calls == ["eh_scan/coded_step"]


def test_traces_do_not_nest_and_a_failed_export_raises(tmp_path, monkeypatch):
    with t_tracing.device_trace(str(tmp_path / "a"), device="cpu"):
        with pytest.raises(RuntimeError, match="nest"):
            with t_tracing.device_trace(str(tmp_path / "b"), device="cpu"):
                pass
    assert _untraced()

    def broken(self, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", broken)
    with pytest.raises(OSError, match="disk full"):
        with t_tracing.device_trace(str(tmp_path / "c"), device="cpu"):
            pass
    assert _untraced()


def test_an_error_in_the_block_propagates_and_clears_the_trace(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with t_tracing.device_trace(str(tmp_path), device="cpu"):
            raise ValueError("inside")
    assert _untraced()


def test_step_timer_is_jax():
    for lib in (t_tracing, j_tracing):
        timer = lib.StepTimer()
        assert timer.total == 0 and timer.mean == 0.0
        for _ in range(3):
            with timer:
                sum(range(1000))
        assert len(timer.laps) == 3 and timer.total == pytest.approx(sum(timer.laps))
        assert timer.mean == pytest.approx(timer.total / 3)
        assert np.all(np.asarray(timer.laps) >= 0)
