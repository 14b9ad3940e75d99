"""The port's host control plane against the JAX package, byte for byte.

Both sides are numpy float64 with the same MT19937 / PCG64 draws, so the
synthetic data, layouts, arrival schedules, collection schedules, slot
weights and decode-error series must be identical bytes, not merely close.
"""

import dataclasses

import numpy as np
import pytest

from erasurehead_tpu.data import synthetic as j_synthetic
from erasurehead_tpu.obs import decode as j_decode
from erasurehead_tpu.parallel import collect as j_collect
from erasurehead_tpu.parallel import step as j_step
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch.data import synthetic as t_synthetic
from erasurehead_tpu_torch.obs import decode as t_decode
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.parallel import straggler as t_straggler
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

SCHEMES = (
    "naive", "approx", "repcoded", "cyccoded", "avoidstragg",
    "partialcyccoded", "partialrepcoded", "randreg", "sparsegraph",
    "expander", "deadline",
)


def _extras(scheme, s):
    """The scheme-specific knobs each grid point runs under: two slot counts
    for the partial schemes, three deadlines for deadline collection (the
    first catches no worker in any round)."""
    if scheme.startswith("partial"):
        return [dict(partitions_per_worker=s + 2), dict(partitions_per_worker=s + 3)]
    if scheme == "deadline":
        return [dict(deadline=1e-9), dict(deadline=0.3), dict(deadline=1.5)]
    return [{}]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _cfgs(scheme, W, s, collect, seed, **extra):
    kw = dict(
        scheme=scheme, n_workers=W, n_stragglers=s, num_collect=collect,
        rounds=12, seed=seed, add_delay=True, **extra,
    )
    return j_config.RunConfig(**kw), t_config.RunConfig(**kw)


@pytest.mark.parametrize("gen", ["generate_gmm", "generate_linear"])
@pytest.mark.parametrize("shape", [(120, 16, 6, 0), (240, 33, 12, 5)])
def test_synthetic_data_bytes(gen, shape):
    n, F, P, seed = shape
    want = getattr(j_synthetic, gen)(n, F, P, seed=seed)
    got = getattr(t_synthetic, gen)(n, F, P, seed=seed)
    for field in ("X_train", "y_train", "X_test", "y_test"):
        _same(getattr(got, field), getattr(want, field))
    assert got.name == want.name


GRID = [
    (scheme, W, s, collect, seed)
    for scheme in SCHEMES
    for (W, s, collect) in ((6, 2, 3), (12, 1, 5), (12, 3, 8))
    for seed in (0, 7)
]


@pytest.mark.parametrize("scheme,W,s,collect,seed", GRID)
def test_layout_schedule_and_weights_bytes(scheme, W, s, collect, seed):
    """Layouts, arrivals, collection schedules under the fixed and the
    optimal decode, slot weights and decode errors: the same bytes."""
    for extra in _extras(scheme, s):
        jcfg, tcfg = _cfgs(scheme, W, s, collect, seed, **extra)
        _check_control_plane(jcfg, tcfg)


def _check_control_plane(jcfg, tcfg):
    jl, tl = j_trainer.build_layout(jcfg), t_trainer.build_layout(tcfg)
    for field in ("assignment", "coeffs", "slot_is_coded"):
        _same(getattr(tl, field), getattr(jl, field))
    for field in ("groups", "B"):
        if getattr(jl, field) is None:
            assert getattr(tl, field) is None
        else:
            _same(getattr(tl, field), getattr(jl, field))
    assert (tl.n_workers, tl.n_partitions, tl.n_stragglers, tl.name) == (
        jl.n_workers, jl.n_partitions, jl.n_stragglers, jl.name
    )
    assert (tl.storage_overhead, tl.uncoded_frac) == (
        jl.storage_overhead, jl.uncoded_frac
    )
    _same(tl.effective_matrix(), jl.effective_matrix())

    t_arr = t_trainer.default_arrivals(tcfg)
    _same(t_arr, j_straggler.arrival_schedule(
        jcfg.rounds, jcfg.n_workers, True, jcfg.delay_mean
    ))

    for decode in ("fixed", "optimal"):
        kw = dict(num_collect=jcfg.num_collect, deadline=jcfg.deadline, decode=decode)
        js = j_collect.build_schedule(jcfg.scheme.value, t_arr, jl, **kw)
        ts = t_trainer.build_schedule(dataclasses.replace(tcfg, decode=decode), t_arr, tl)
        for field in ("message_weights", "sim_time", "worker_times", "collected"):
            _same(getattr(ts, field), getattr(js, field))

        args = (js.message_weights, jl.coeffs, np.asarray(jl.slot_is_coded))
        jw = np.asarray(j_step.expand_slot_weights(*args))
        tw = t_step.expand_slot_weights(*args)
        _same(tw, jw)
        _same(tl.fold_slot_weights(tw), jl.fold_slot_weights(jw))
        _same(
            t_decode.decode_error_series(tl, ts.message_weights),
            j_decode.decode_error_series(jl, js.message_weights),
        )


@pytest.mark.parametrize("add_delay", [True, False])
@pytest.mark.parametrize("mean", [0.5, 2.0])
def test_arrival_schedule_bytes(add_delay, mean):
    _same(
        t_straggler.arrival_schedule(9, 7, add_delay, mean),
        j_straggler.arrival_schedule(9, 7, add_delay, mean),
    )


def test_reference_delay_schedule_bytes():
    _same(
        t_straggler.reference_delay_schedule(5, 4, 0.5, seed_offset=3),
        j_straggler.reference_delay_schedule(5, 4, 0.5, seed_offset=3),
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(use_pallas="maybe"),
        dict(scheme="approx", n_workers=7, n_stragglers=1),
        dict(scheme="repcoded", n_workers=9, n_stragglers=3),
        dict(dataset="nope"),
        dict(decode="best"),
        dict(scheme="nope"),
        dict(scheme="deadline"),
        dict(scheme="deadline", deadline=-1.0),
        dict(scheme="partialcyccoded", n_stragglers=2, partitions_per_worker=3),
        dict(scheme="partialrepcoded"),
    ],
)
def test_config_validation_messages_match(kw):
    with pytest.raises(ValueError) as want:
        j_config.RunConfig(**kw)
    with pytest.raises(ValueError) as got:
        t_config.RunConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(rounds=7, lr_schedule=0.3, alpha=0.01),
        dict(dataset="kc_house_data", rounds=5),
        dict(n_rows=1000, lr_schedule=[0.1, 0.2, 0.3], rounds=3),
    ],
)
def test_config_defaults_and_lr_match(kw):
    jcfg, tcfg = j_config.RunConfig(**kw), t_config.RunConfig(**kw)
    _same(tcfg.resolve_lr_schedule(), jcfg.resolve_lr_schedule())
    assert tcfg.effective_alpha == jcfg.effective_alpha
    assert tcfg.num_collect == jcfg.num_collect
    for field in (
        "n_workers", "n_stragglers", "rounds", "add_delay", "delay_mean",
        "n_rows", "n_cols", "seed", "dtype", "use_pallas", "deadline",
        "decode", "partitions_per_worker", "is_real_data",
    ):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    for field in ("scheme", "model", "update_rule", "compute_mode"):
        assert getattr(tcfg, field).value == getattr(jcfg, field).value, field
