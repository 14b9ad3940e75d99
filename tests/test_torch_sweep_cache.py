"""The port's device data cache (train/cache.py) against the JAX package's.

Mirrors tests/test_sweep_cache.py's data-cache half:

  - a sequential multi-scheme compare() hits and misses exactly as the JAX
    package's data cache does for the same layouts (deduped stacks are
    scheme-independent; faithful stacks key on the assignment's content);
  - cached runs are bitwise equal to uncached ones, dense, sparse, int8,
    and a cached sparse stack keeps the plans it built at first use;
  - the key separates devices, dtypes, the int8 stack and sparse formats,
    and a FieldOnehot stack takes each run's lowering after the lookup;
  - LRU eviction at DATA_CACHE_MAX; the out-of-memory bisection drops the
    cache's pins; ``--sweep-cache off`` and ``ERASUREHEAD_SWEEP_CACHE``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.train import cache as j_cache
from erasurehead_tpu.train import experiments as j_exp
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm, generate_onehot
from erasurehead_tpu_torch.obs.metrics import REGISTRY
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import features as t_features
from erasurehead_tpu_torch.train import cache
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig

W, ROUNDS = 8, 4
N_ROWS, N_COLS = 512, 24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gmm():
    return generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def onehot():
    return generate_onehot(480, 60, W, n_fields=6, seed=0)


@pytest.fixture(autouse=True)
def fresh_cache():
    """Every test starts and ends with an empty cache and zero counters."""
    for c in (cache, j_cache):
        c.clear()
        c.set_enabled(True)
    yield
    cache.clear()
    cache.set_enabled(True)
    j_cache.clear()


def _kw(**kw):
    base = dict(
        scheme="approx", n_workers=W, n_stragglers=1, num_collect=6,
        rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD",
        lr_schedule=0.5, add_delay=True, seed=3,
    )
    base.update(kw)
    return base


def _bits(res):
    return [h.numpy().tobytes() for h in blocks.tree_leaves(res.params_history)]


SEVEN = {
    "naive": {}, "cyccoded": {}, "repcoded": {}, "approx": {"num_collect": 6},
    "avoidstragg": {}, "randreg": {"num_collect": 6}, "deadline": {"deadline": 1.0},
}


@pytest.mark.parametrize("mode", ["deduped", "faithful"])
def test_sequential_compare_counts_are_jax(gmm, mode):
    """batch='off' over the seven schemes: the port's data hits and misses
    equal the JAX cache's for the same layouts (deduped: one upload;
    faithful: one per distinct assignment)."""
    kws = {s: _kw(scheme=s, compute_mode=mode, **extra) for s, extra in SEVEN.items()}
    j_exp.compare({k: JRunConfig(**v) for k, v in kws.items()},
                  j_generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0), batch="off")
    rows = t_exp.compare({k: RunConfig(**v) for k, v in kws.items()}, gmm, batch="off",
                         device="cpu")
    s, js = cache.stats(), j_cache.stats()
    assert (s.data_hits, s.data_misses) == (js.data_hits, js.data_misses)
    assert s.data_hits + s.data_misses == 7
    if mode == "deduped":
        assert s.data_misses == 1
    # the prediction from the layouts alone
    sigs = {t_trainer._stack_signature(c, t_trainer.build_layout(c)) for c in
            (RunConfig(**v) for v in kws.values())}
    assert s.data_misses == len(sigs)
    assert len(rows) == 7
    assert (s.bytes_reused > 0) == (s.data_hits > 0)


def test_two_scheme_faithful_share_a_stack(gmm):
    """FRC and AGC share an assignment, so the second run hits."""
    a = t_trainer.train(RunConfig(**_kw(scheme="approx", compute_mode="faithful")), gmm,
                        device="cpu")
    b = t_trainer.train(RunConfig(**_kw(scheme="repcoded", compute_mode="faithful")), gmm,
                        device="cpu")
    assert a.cache_info["data_hit"] is False and b.cache_info["data_hit"] is True
    assert b.cache_info["bytes_reused"] == a.cache_info["stack_bytes"] > 0
    assert a.cache_info["stack_mode"] == "materialized"
    assert a.cache_info["setup_seconds"] > 0 and a.cache_info["enabled"] is True


CACHED_CASES = {
    "dense": (dict(), "gmm"),
    "deduped_bf16": (dict(compute_mode="deduped", dtype="bfloat16"), "gmm"),
    "int8": (dict(stack_dtype="int8"), "gmm"),
    "padded": (dict(sparse_format="padded", lr_schedule=1.0), "onehot"),
    "fields": (dict(sparse_format="fields", lr_schedule=1.0), "onehot"),
    "deep": (dict(model="deepmlp", update_rule="GD", layer_coding="on"), "gmm"),
}


@pytest.mark.parametrize("case", list(CACHED_CASES))
def test_cached_runs_bitwise_uncached(gmm, onehot, case):
    kw, data = CACHED_CASES[case]
    ds = gmm if data == "gmm" else onehot
    if data == "onehot":
        kw = dict(kw, n_rows=480, n_cols=60)
    cfg = RunConfig(**_kw(**kw))
    first = t_trainer.train(cfg, ds, device="cpu")
    again = t_trainer.train(cfg, ds, device="cpu")
    assert not first.cache_info["data_hit"] and again.cache_info["data_hit"]
    cache.set_enabled(False)
    off = t_trainer.train(cfg, ds, device="cpu")
    assert off.cache_info["data_hit"] is False and off.cache_info["enabled"] is False
    assert _bits(first) == _bits(again) == _bits(off)
    assert first.timeset.tobytes() == off.timeset.tobytes()


def test_cached_sparse_stack_keeps_its_plans(onehot):
    """The scatter plan a PaddedRows stack builds at first use stays on the
    cached stack, and a hit reuses it (it is a deterministic function of
    the stack)."""
    cfg = RunConfig(**_kw(sparse_format="padded", n_rows=480, n_cols=60, lr_schedule=1.0))
    layout = t_trainer.build_layout(cfg)
    X, *_ = t_trainer._device_stack(cfg, onehot, layout, True, torch.device("cpu"))
    t_trainer.train(cfg, onehot, device="cpu")
    plans = dict(X._cache)
    assert plans, "the run built no plan on the cached stack"
    X2, _, _, hit = t_trainer._device_stack(cfg, onehot, layout, True, torch.device("cpu"))
    assert hit and X2 is X
    t_trainer.train(cfg, onehot, device="cpu")
    assert all(X._cache[k] is v for k, v in plans.items())


@pytest.mark.parametrize("a,b", [
    (dict(), dict(dtype="bfloat16")),
    (dict(), dict(stack_dtype="int8")),
    (dict(stack_dtype="bfloat16"), dict(dtype="bfloat16")),
    (dict(compute_mode="faithful"), dict(compute_mode="deduped")),
])
def test_key_separates_storage(gmm, a, b):
    t_trainer.train(RunConfig(**_kw(**a)), gmm, device="cpu")
    res = t_trainer.train(RunConfig(**_kw(**b)), gmm, device="cpu")
    assert res.cache_info["data_hit"] is False
    assert cache.stats().data_misses == 2


def test_key_separates_sparse_formats_and_keeps_lowerings(onehot):
    kw = dict(n_rows=480, n_cols=60, lr_schedule=1.0)
    t_trainer.train(RunConfig(**_kw(sparse_format="padded", **kw)), onehot, device="cpu")
    fields = t_trainer.train(RunConfig(**_kw(sparse_format="fields", **kw)), onehot,
                             device="cpu")
    assert fields.cache_info["data_hit"] is False
    # the lowering is applied after the lookup: one stack, each run its own
    cfg_onehot = RunConfig(**_kw(sparse_format="fields", fields_margin="onehot",
                                 fields_scatter="onehot", **kw))
    layout = t_trainer.build_layout(cfg_onehot)
    X, _, _, hit = t_trainer._device_stack(cfg_onehot, onehot, layout, True,
                                           torch.device("cpu"))
    assert hit and isinstance(X, t_features.FieldOnehot)
    assert (X.margin, X.scatter) == ("onehot", "onehot")
    got = t_trainer.train(cfg_onehot, onehot, device="cpu")
    cache.set_enabled(False)
    want = t_trainer.train(cfg_onehot, onehot, device="cpu")
    assert _bits(got) == _bits(want)


def test_key_separates_devices(gmm):
    """A stack built for one device never serves another: the key carries
    the device (here two spellings of the CPU device, the only one the test
    machine has; the card-side pin is in chip_smoke.py)."""
    cfg = RunConfig(**_kw())
    layout = t_trainer.build_layout(cfg)
    *_, hit0 = t_trainer._device_stack(cfg, gmm, layout, True, torch.device("cpu"))
    *_, hit1 = t_trainer._device_stack(cfg, gmm, layout, True, torch.device("cpu", 0))
    *_, hit2 = t_trainer._device_stack(cfg, gmm, layout, True, torch.device("cpu"))
    assert (hit0, hit1, hit2) == (False, False, True)


def test_key_separates_dataset_objects(gmm):
    cfg = RunConfig(**_kw())
    t_trainer.train(cfg, gmm, device="cpu")
    other = generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=9)
    assert t_trainer.train(cfg, other, device="cpu").cache_info["data_hit"] is False
    assert cache.dataset_token(gmm) == cache.dataset_token(gmm)
    assert cache.dataset_token(gmm) != cache.dataset_token(other)


def test_lru_eviction_at_the_cap(gmm):
    datasets = [generate_gmm(64, 8, n_partitions=4, seed=s)
                for s in range(cache.DATA_CACHE_MAX + 2)]
    cfg = RunConfig(**_kw(n_workers=4, num_collect=3, n_rows=64, n_cols=8, rounds=2))
    for ds in datasets:
        t_trainer.train(cfg, ds, device="cpu")
    assert len(cache._data_cache) == cache.DATA_CACHE_MAX
    # the oldest two were evicted, the newest hits
    assert t_trainer.train(cfg, datasets[0], device="cpu").cache_info["data_hit"] is False
    assert t_trainer.train(cfg, datasets[-1], device="cpu").cache_info["data_hit"] is True
    assert cache.data_cache_bytes() > 0
    dropped = REGISTRY.counter("sweep_cache.data_dropped_bytes").value
    released = cache.drop_data_cache()
    assert released > 0 and cache.data_cache_bytes() == 0
    assert REGISTRY.counter("sweep_cache.data_dropped_bytes").value == dropped + released


def test_oom_bisection_drops_the_cache(gmm, monkeypatch):
    kws = {s: _kw(scheme=s, compute_mode="deduped", **e) for s, e in SEVEN.items()}
    configs = {k: RunConfig(**v) for k, v in kws.items()}
    t_trainer.train(configs["naive"], gmm, device="cpu")  # one pinned stack
    assert cache.data_cache_bytes() > 0
    real = t_trainer.train_cohort
    seen = []

    def oom_once(cfgs, *a, **k):
        if not seen:
            seen.append(cache.data_cache_bytes())
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        seen.append(cache.data_cache_bytes())
        return real(cfgs, *a, **k)

    monkeypatch.setattr(t_trainer, "train_cohort", oom_once)
    t_exp.reset_counters()
    rows = t_exp.compare(configs, gmm, batch="auto", device="cpu")
    assert len(rows) == 7 and t_exp.COUNTERS["cohort.split"] == 1
    assert seen[0] > 0 and seen[1] == 0  # the halves started from no pins


def test_cli_sweep_cache_off(tmp_path):
    args = ["--scheme", "approx", "--workers", "4", "--stragglers", "1", "--num-collect", "3",
            "--rows", "64", "--cols", "8", "--rounds", "2", "--device", "cpu", "--quiet",
            "--output-dir", str(tmp_path)]
    assert t_cli._flags_parser().parse_args(args).sweep_cache == "on"
    assert t_cli.main(args) == 0 and cache.enabled()
    assert cache.stats().data_misses == 1
    assert t_cli.main(args + ["--sweep-cache", "off"]) == 0
    assert not cache.enabled() and cache.stats().data_misses == 1


@pytest.mark.parametrize("value,want", [("0", False), ("off", False), ("1", True), ("", True)])
def test_env_switch_read_at_import(value, want):
    code = ("from erasurehead_tpu_torch.train import cache; "
            "print(cache.enabled())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "ERASUREHEAD_SWEEP_CACHE": value})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == str(want)


def test_device_nbytes_walks_containers(gmm, onehot):
    t = torch.zeros(3, 4)
    assert cache.device_nbytes(t) == 48
    assert cache.device_nbytes((t, {"a": t, "b": [t]}, None, 3)) == 144
    cfg = RunConfig(**_kw(sparse_format="padded", n_rows=480, n_cols=60))
    X, y, _, _ = t_trainer._device_stack(cfg, onehot, t_trainer.build_layout(cfg), True,
                                         torch.device("cpu"))
    assert cache.device_nbytes(X) == sum(
        v.numel() * v.element_size() for v in (X.indices, X.values))
    assert cache.device_nbytes((X, y)) == cache.device_nbytes(X) + y.numel() * 4


def test_cache_stats_view():
    s = cache.stats()
    assert s.snapshot() == {"exec_hits": 0, "exec_misses": 0, "data_hits": 0,
                            "data_misses": 0, "compile_seconds_saved": 0, "bytes_reused": 0}
    assert s.exec_hits == 0  # the executable cache (train/graphs.py's programs)
    with pytest.raises(AttributeError):
        s.no_such_field
    assert np.isscalar(s.data_hits)
