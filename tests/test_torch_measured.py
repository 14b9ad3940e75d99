"""The port's measured-arrival trainer against the JAX package's.

Mirrors tests/test_measured.py with a deterministic clock in place of the
host's: ``train_measured``'s private ``_clock`` is the per-worker timer, so
the collection it feeds is driven exactly, and no test here is a timing
test (the card's real-clock imbalance check is in
tests/test_torch_dynamic_cuda.py).

  - a clock that reports zero compute: the run equals the port's ``train``
    on the same config within rtol 1e-5, its clocks and collection byte-equal
    to the schedule JAX's ``train`` builds on the host;
  - a clock that charges ``mult[w]`` units to worker w: avoidstragg drops
    workers 0 and 1 in every round;
  - every refusal with JAX's message (the trainer's and RunConfig's);
  - ``work_multiplier``: validated with JAX's message; an n-fold message is
    bitwise the one-fold message;
  - several devices in one process (``device=[...]``, CPU devices here):
    JAX's multi-device imbalance and queue-contention tests on the real
    clock, and under a clock that advances by each message's work the
    per-device queue replay equals JAX's simulated ``train`` on the
    arrivals that replay implies;
  - the cohort paths and the CLI.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.parallel import collect as j_collect
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import features as t_features
from erasurehead_tpu_torch.parallel import mesh as mesh_lib
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import PipelineRefusal, RunConfig

W, S, R = 8, 2, 6


def jax_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: np.asarray(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_leaves(tree):
    if isinstance(tree, dict):
        return [np.asarray(tree[k]) for k in sorted(tree)]
    return [np.asarray(tree)]


def _kw(**kw):
    base = dict(scheme="avoidstragg", n_workers=W, n_stragglers=S, rounds=R,
                n_rows=32 * W, n_cols=32, lr_schedule=1.0, update_rule="AGD",
                add_delay=True, seed=0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def data():
    return generate_gmm(32 * W, 32, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(32 * W, 32, n_partitions=W, seed=0)


def _zero():
    return 0.0


def _charging(mult):
    """A clock read twice per worker (before and after its message): the
    second read of worker w is ``mult[w]`` units after the first."""
    calls = itertools.count()

    def clock():
        n = next(calls)
        return float((n % 2) * mult[(n // 2) % len(mult)])

    return clock


@pytest.mark.parametrize("scheme,extra", [
    ("avoidstragg", {}), ("approx", dict(n_stragglers=1, num_collect=5)),
    ("cyccoded", {}), ("approx", dict(n_stragglers=1, num_collect=5, model="mlp",
                                      update_rule="GD")),
])
def test_zero_compute_clock_equals_train(data, scheme, extra):
    cfg = RunConfig(**_kw(scheme=scheme, **extra))
    got = t_trainer.train_measured(cfg, data, device="cpu", _clock=_zero)
    want = t_trainer.train(cfg, data, device="cpu")
    assert got.lowering == "measured"
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        assert getattr(got, field).tobytes() == getattr(want, field).tobytes(), field
    for a, b in zip(blocks.tree_leaves(got.params_history),
                    blocks.tree_leaves(want.params_history)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    # the collection is the JAX trainer's host schedule, byte for byte
    jcfg = JRunConfig(**_kw(scheme=scheme, **extra))
    jsched = j_collect.build_schedule(
        jcfg.scheme, j_straggler.arrival_schedule(R, W, True, jcfg.delay_mean),
        j_trainer.build_layout(jcfg), num_collect=jcfg.num_collect,
    )
    for field, jfield in (("timeset", "sim_time"), ("worker_times", "worker_times"),
                          ("collected", "collected")):
        a, b = getattr(got, field), np.asarray(getattr(jsched, jfield))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("fmt", ["padded", "fields"])
def test_sparse_stacks_equal_train(fmt):
    """A one-hot CSR dataset stacks as PaddedRows or FieldOnehot; each
    worker's message takes the GLM's closed form over its slots."""
    from erasurehead_tpu_torch.data.synthetic import generate_onehot

    ds = generate_onehot(240, 60, 6, n_fields=4, seed=0)
    cfg = RunConfig(scheme="avoidstragg", n_workers=6, n_stragglers=1, rounds=3, n_rows=240,
                    n_cols=60, lr_schedule=1.0, sparse_format=fmt, add_delay=True)
    got = t_trainer.train_measured(cfg, ds, device="cpu", _clock=_zero)
    want = t_trainer.train(cfg, ds, device="cpu")
    assert got.collected.tobytes() == want.collected.tobytes()
    np.testing.assert_allclose(got.params_history.numpy(), want.params_history.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_charged_clock_drops_the_slow_workers(data):
    mult = np.ones(W, dtype=np.int64)
    mult[:2] = 400
    res = t_trainer.train_measured(RunConfig(**_kw(add_delay=False)), data, device="cpu",
                                   _clock=_charging(mult))
    assert not res.collected[:, :2].any()
    assert res.collected[:, 2:].all()
    assert (res.worker_times[:, :2] == -1.0).all()
    assert (res.worker_times[:, 2:] == 1.0).all() and (res.timeset == 1.0).all()
    # the simulated schedule of the same config collects by index instead
    sim = t_trainer.train(RunConfig(**_kw(add_delay=False)), data, device="cpu")
    assert sim.collected[:, :W - S].all()


def test_delays_compose_with_measured_compute(data):
    """arrivals = measured compute + the injected delay (the reference's
    compute-then-sleep): a clock charging 0.25 s to every worker shifts
    every stamp by 0.25 and keeps the delay schedule's collection."""
    res = t_trainer.train_measured(RunConfig(**_kw()), data, device="cpu",
                                   _clock=_charging(np.full(W, 0.25)))
    delays = j_straggler.arrival_schedule(R, W, True, 0.5)
    want = j_collect.collect_avoidstragg(delays + 0.25, S)
    assert res.collected.tobytes() == want.collected.tobytes()
    np.testing.assert_array_equal(res.worker_times, want.worker_times)


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return ei.value


@pytest.mark.parametrize("extra", [
    dict(worker_speed_spread=0.5),
    dict(compute_time=0.1),
    dict(compute_mode="deduped"),
    dict(use_pallas="on"),
    dict(flat_grad="on"),
    dict(margin_flat="on"),
    dict(scheme="partialcyccoded", n_stragglers=1, partitions_per_worker=3),
    dict(scheme="partialrepcoded", n_stragglers=1, partitions_per_worker=3),
    dict(scheme="approx", n_stragglers=1, num_collect=5, update_rule="GD", pipeline_depth=1),
])
def test_trainer_refusals_match_jax(data, jdata, extra):
    got = _error(lambda: t_trainer.train_measured(RunConfig(**_kw(**extra)), data,
                                                  device="cpu"))
    want = _error(lambda: j_trainer.train_measured(JRunConfig(**_kw(**extra)), jdata))
    assert str(got) == str(want) and type(got).__name__ == type(want).__name__
    if extra.get("pipeline_depth"):
        assert isinstance(got, PipelineRefusal) and got.reason == "measured_arrivals"


@pytest.mark.parametrize("extra", [
    dict(arrival_mode="bogus"),
    dict(arrival_mode="measured", layer_coding="on"),
    dict(arrival_mode="measured", arrival_trace="trace.npy"),
    dict(arrival_mode="measured", stack_dtype="int8"),
    dict(arrival_mode="measured", stack_residency="streamed"),
    dict(arrival_mode="measured", scheme="approx", n_stragglers=1, num_collect=5,
         update_rule="GD", pipeline_depth=1),
])
def test_config_refusals_match_jax(extra):
    got = _error(lambda: RunConfig(**_kw(**extra)))
    want = _error(lambda: JRunConfig(**_kw(**extra)))
    assert str(got) == str(want) and type(got).__name__ == type(want).__name__


def test_multi_device_requests_are_refused(data):
    """A device list drives its devices from one process: under a world of
    several ranks it is refused (the worker mesh runs one process per
    device), and so is an empty list."""
    two = mesh_lib.WorkerMesh(ranks=(0, 1), world=2)
    with pytest.raises(ValueError, match="one process per device") as ei:
        t_trainer.train_measured(RunConfig(**_kw()), data, device=["cpu", "cpu"], mesh=two)
    assert "A9" not in str(ei.value)
    with pytest.raises(ValueError, match="device list is empty"):
        t_trainer.train_measured(RunConfig(**_kw()), data, device=[])


# ---------------------------------------------------------------------------
# several devices in one process: the per-device queue replay


MULT = 400  # the heavy workers' work: dwarfs timing noise, as JAX's tests


def test_measured_multidevice_imbalance_changes_collection(data):
    """JAX's test of the same name, on four CPU devices of one process:
    overloading one DEVICE (both of its workers, 0 and 4) pushes exactly
    its workers out of the collected set, in a majority of rounds (the
    host clock is real)."""
    mult = np.ones(W, dtype=np.int64)
    mult[[0, 4]] = MULT
    res = t_trainer.train_measured(RunConfig(**_kw(add_delay=False)), data,
                                   device=["cpu"] * 4, work_multiplier=mult)
    slow_excluded = (res.worker_times[:, [0, 4]] == -1.0).all(axis=1)
    assert slow_excluded.sum() > R // 2, res.worker_times
    fast = [w for w in range(W) if w not in (0, 4)]
    assert res.collected[slow_excluded][:, fast].all()


def test_measured_multidevice_queue_contention(data):
    """JAX's test of the same name: a LIGHT worker (4) sharing a device with
    a heavy one (0) arrives late because it queues behind it, and is
    excluded alongside it in most rounds."""
    mult = np.ones(W, dtype=np.int64)
    mult[0] = MULT
    res = t_trainer.train_measured(RunConfig(**_kw(add_delay=False)), data,
                                   device=["cpu"] * 4, work_multiplier=mult)
    both_excluded = (res.worker_times[:, [0, 4]] == -1.0).all(axis=1)
    assert both_excluded.sum() > R // 2, res.worker_times


def _unit_clock(monkeypatch):
    """A clock that advances by n units whenever a worker's message of
    n-fold work is computed, and a record of the devices each message ran
    on: the replay's arrivals are then exact."""
    now, where = [0.0], []
    real = t_trainer._make_worker_msg

    def make(model):
        msg = real(model)

        def timed(params, Xs, ys, n=1):
            where.append(blocks.tree_leaves(params)[0].device)
            now[0] += n
            return msg(params, Xs, ys, n=n)

        return timed

    monkeypatch.setattr(t_trainer, "_make_worker_msg", make)
    return (lambda: now[0]), where


def _queue_arrivals(mult, D):
    """Each worker's arrival on its device's queue: the work of the workers
    before it on that device, plus its own."""
    t = np.zeros(len(mult))
    for d in range(D):
        t[d::D] = np.cumsum(mult[d::D])
    return t


@pytest.mark.parametrize("D,scheme,extra", [
    (4, "avoidstragg", {}),
    (4, "approx", dict(n_stragglers=1, num_collect=5)),
    (3, "cyccoded", {}),
    (2, "approx", dict(n_stragglers=1, num_collect=5, model="mlp", update_rule="GD")),
])
def test_device_list_replay_equals_jax_on_its_arrivals(data, jdata, monkeypatch, D, scheme,
                                                       extra):
    """Under a clock that advances by mult[w] units per message, the replay
    over D devices gives worker w the arrival ``sum of its queue up to w``
    plus the injected delay. The port's clocks and collection then equal,
    byte for byte, the JAX package's simulated ``train`` on that arrival
    matrix, and its iterates JAX's within rtol 2e-4 / atol 1e-5 (the port
    started from JAX's init draw)."""
    mult = np.array([5, 1, 3, 1, 1, 7, 2, 1], dtype=np.int64)
    kw = _kw(scheme=scheme, **extra)
    clock, where = _unit_clock(monkeypatch)
    jcfg = JRunConfig(**kw)
    init = jax_tree_numpy(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), 32))
    got = t_trainer.train_measured(RunConfig(**kw), data, device=["cpu"] * D,
                                   work_multiplier=mult, init_params=init, _clock=clock)
    assert len(where) == W * (R + 1)  # the warm-up and R rounds, W messages each
    arrivals = _queue_arrivals(mult, D)[None, :] + j_straggler.arrival_schedule(
        R, W, True, jcfg.delay_mean)
    want = j_trainer.train(jcfg, jdata, arrivals=arrivals, measure=False)
    for field in ("timeset", "worker_times", "collected"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for a, b in zip(blocks.tree_leaves(got.params_history),
                    jax_leaves(want.params_history)):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-5)


def test_a_list_of_one_device_is_the_one_device_run(data):
    mult = np.arange(1, W + 1)
    one = t_trainer.train_measured(RunConfig(**_kw()), data, device="cpu", _clock=_zero,
                                   work_multiplier=mult)
    listed = t_trainer.train_measured(RunConfig(**_kw()), data, device=["cpu"], _clock=_zero,
                                      work_multiplier=mult)
    assert torch.equal(one.params_history, listed.params_history)
    assert one.collected.tobytes() == listed.collected.tobytes()


def test_the_decode_is_one_launch_a_round_on_the_first_device(data, monkeypatch):
    """The replay stages every message on device[0] and decodes there with
    one call of B2's wrapper a round."""
    calls = []
    real = t_trainer.kernels.fused_block_decode_leaves

    def spy(ws, leaves):
        calls.append({str(ws.device)} | {str(t.device) for t in leaves})
        return real(ws, leaves)

    monkeypatch.setattr(t_trainer.kernels, "fused_block_decode_leaves", spy)
    t_trainer.train_measured(RunConfig(**_kw()), data, device=["cpu"] * 4, _clock=_zero)
    assert calls == [{"cpu"}] * R


def test_work_multiplier(data, jdata):
    for bad in (np.zeros(W, dtype=np.int64), np.ones(3)):
        got = _error(lambda: t_trainer.train_measured(RunConfig(**_kw()), data, device="cpu",
                                                      work_multiplier=bad))
        want = _error(lambda: j_trainer.train_measured(JRunConfig(**_kw()), jdata,
                                                       work_multiplier=bad))
        assert str(got) == str(want)
    # an n-fold message is the one-fold message, bit for bit
    for model_kind in ("logistic", "mlp"):
        cfg = RunConfig(**_kw(model=model_kind))
        model = t_trainer.build_model(cfg)
        params = model.init_params(0, 32)
        Xw = torch.randn(W, 1, 32, 32)
        yw = torch.randn(W, 1, 32).sign()
        msg = t_trainer._make_worker_msg(model)
        one = msg(params, t_features.take_lead(Xw, 3), yw[3], n=1)
        three = msg(params, t_features.take_lead(Xw, 3), yw[3], n=3)
        for a, b in zip(blocks.tree_leaves(one), blocks.tree_leaves(three)):
            assert torch.equal(a, b)
    # and so is the whole run (a zero clock: the collection is the same)
    base = t_trainer.train_measured(RunConfig(**_kw()), data, device="cpu", _clock=_zero)
    more = t_trainer.train_measured(RunConfig(**_kw()), data, device="cpu", _clock=_zero,
                                    work_multiplier=np.arange(1, W + 1))
    assert torch.equal(base.params_history, more.params_history)


def test_cohort_paths_refuse_measured(data, jdata):
    cfg = RunConfig(**_kw(arrival_mode="measured"))
    assert not t_trainer.cohort_eligible(cfg)
    assert t_trainer.cohort_signature(cfg) is None
    jcfg = JRunConfig(**_kw(arrival_mode="measured"))
    for got_fn, want_fn in (
        (lambda: t_trainer.train_cohort([cfg], data, device="cpu"),
         lambda: j_trainer.train_cohort([jcfg], jdata)),
        (lambda: t_trainer.train_batch(cfg, data, [0, 1], device="cpu"),
         lambda: j_trainer.train_batch(jcfg, jdata, [0, 1])),
    ):
        assert str(_error(got_fn)) == str(_error(want_fn))


def test_cli_measured_run_and_refusals(tmp_path, capsys):
    args = ["--scheme", "avoidstragg", "--workers", "4", "--stragglers", "1", "--rounds", "3",
            "--rows", "128", "--cols", "8", "--add-delay", "--quiet", "--device", "cpu",
            "--arrival-mode", "measured", "--output-dir", str(tmp_path)]
    assert t_cli.main(args) == 0
    wt = np.loadtxt(os.path.join(tmp_path, "avoidstragg_acc_1_worker_timeset.dat"))
    assert wt.shape == (3, 4) and (wt == -1.0).sum() == 3 and (wt[wt >= 0] > 0).all()
    for extra, msg in (
        (["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"],
         "checkpoint/resume is implemented for the scan trainer only"),
        (["--kill-workers", "1:1"], "--kill-workers needs the simulated-arrival trainer"),
    ):
        with pytest.raises(SystemExit) as ei:
            t_cli.main(args + extra)
        assert ei.value.code == 2 and msg in capsys.readouterr().err
