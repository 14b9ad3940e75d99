"""Card-side pins of the telemetry plane: with a capture and a
``--trace-dir`` trace on, a GLM run launches B1 once a round and a
layer-coded deep run B2 once a round, exactly as with both off, and their
histories are bitwise the untraced runs'; the trace holds the kernels by
their device symbols (``glm_grad_onepass``, ``block_decode_leaves``) and the round loop's host spans; the ``compile``
record is the kernel library's load; the determinism audit is bitwise on the
card. Every test is marked ``cuda`` and skips without a card.

The module imports the port only: ``python -m pytest --noconftest -m cuda
tests/test_torch_telemetry_cuda.py``.
"""

import json

import pytest
import torch

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.obs import events
from erasurehead_tpu_torch.ops import blocks, kernels
from erasurehead_tpu_torch.train import trainer
from erasurehead_tpu_torch.utils import audit
from erasurehead_tpu_torch.utils.config import RunConfig
from erasurehead_tpu_torch.utils.tracing import device_trace

W, ROUNDS, N_ROWS, N_COLS = 8, 12, 8 * 64, 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cfg(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=6, rounds=ROUNDS,
                n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
                add_delay=True, seed=0)
    base.update(kw)
    return RunConfig(**base)


def _traced(cfg, data, tmp_path):
    kernels.reset_launches()
    plain = trainer.train(cfg, data, device="cuda")
    off = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    path = str(tmp_path / "e.jsonl")
    with events.capture(path), device_trace(str(tmp_path / "trace"), device="cuda") as tr:
        seen = trainer.train(cfg, data, device="cuda")
    assert dict(kernels.LAUNCHES) == off
    for a, b in zip(blocks.tree_leaves(plain.params_history),
                    blocks.tree_leaves(seen.params_history)):
        assert torch.equal(a, b)
    assert events.validate_file(path) == []
    trace = json.load(open(tr.path))["traceEvents"]
    return off, [json.loads(line) for line in open(path)], trace


def _kernel_names(trace):
    return [e["name"] for e in trace if e.get("cat") == "kernel"]


@pytest.mark.cuda
def test_traced_glm_run_launches_b1_as_untraced(tmp_path):
    _card()
    data = t_syn.generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)
    launches, recs, trace = _traced(_cfg(), data, tmp_path)
    assert launches == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}
    compiles = [r for r in recs if r["type"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["cache_hit"] is True  # loaded by the first run
    start = next(r for r in recs if r["type"] == "run_start")
    assert start["platform"] == "cuda" and start["lowering"] == "fused"
    names = _kernel_names(trace)
    # B1 is one kernel a call: one device event a launch
    assert 1 <= sum("glm_grad_onepass" in n for n in names) <= ROUNDS
    assert not any("glm_grad" in n and "glm_grad_onepass" not in n for n in names)
    spans = [e["name"] for e in trace if e.get("cat") == "user_annotation"]
    assert spans.count("eh_scan/coded_step") == spans.count("eh_scan/update") == ROUNDS


@pytest.mark.cuda
def test_traced_deep_run_launches_b2_as_untraced(tmp_path):
    _card()
    data = t_syn.generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)
    cfg = _cfg(model="deepmlp", layer_coding="on", update_rule="GD", lr_schedule=0.5)
    launches, _, trace = _traced(cfg, data, tmp_path)
    assert launches == {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}
    assert 1 <= sum("block_decode_leaves" in n for n in _kernel_names(trace)) <= ROUNDS
    spans = [e["name"] for e in trace if e.get("cat") == "user_annotation"]
    assert spans.count("eh_step/decode") == ROUNDS


@pytest.mark.cuda
def test_audit_is_bitwise_on_the_card():
    _card()
    data = t_syn.generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)
    kernels.reset_launches()
    res = audit.audit(_cfg(), data, device="cuda")
    assert all(res.values()) and res["training"].max_abs_diff == 0.0
    assert kernels.LAUNCHES["fused_glm_grad"] == 2 * ROUNDS


@pytest.mark.cuda
def test_captured_streamed_run_keeps_no_window_alive(tmp_path, monkeypatch):
    """Under a capture a windowed streamed run peaks no higher on the card
    than without one: the records carry byte counts, never window tensors."""
    _card()
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    data = t_syn.generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)
    cfg = _cfg(compute_mode="deduped", stack_residency="streamed", stream_window=2)
    plain = trainer.train(cfg, data, device="cuda")
    with events.capture(str(tmp_path / "e.jsonl")):
        seen = trainer.train(cfg, data, device="cuda")
    assert seen.cache_info["device_peak_bytes"] <= plain.cache_info["device_peak_bytes"]
    assert torch.equal(plain.params_history, seen.params_history)
