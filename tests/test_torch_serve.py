"""The port's serve daemon (erasurehead_tpu_torch/serve/) against the JAX
package's, on the CPU.

What is held, and how:
  - the kernel library under two threads: the launch counters lose no
    increment and the library builds once when many threads make their
    first call together (the launch and the build are stubbed here; the
    card-side pins are in tests/test_torch_serve_cuda.py);
  - the wire model: ``config_payload`` gives the JAX package's dict for
    every config both packages express, the four JAX fields the port's
    RunConfig lacks are refused naming their ROADMAP item, and a WAL
    written by either package reads back into the same payloads in the
    other;
  - the packer's plans, the footprint estimates and a scripted admission
    sequence's verdicts and records equal the JAX package's exactly;
  - dispatch: packed rows bitwise equal to the same requests dispatched
    alone (each at another column), rows' simulated clocks equal to the
    JAX daemon's and losses/AUC within rtol 1e-4 of them from JAX's initial
    params, divergence and errors isolated per cohort, a transient retried
    on the non-batchable path, per-tenant resume bitwise, backpressure,
    timeouts, warm restart from the WAL (the daemon across ranks is in
    tests/test_torch_serve_ranks.py);
  - the event logs validate, the report's serve section is the JAX
    report's text, and ``cli serve --device cpu`` answers, dies with exit
    43 under a chaos kill and replays its WAL on restart.

Sizes: W = 4, 256 x 16 synthetic GMM rows, 10 rounds. Waits are on the
results and records asserted, or on chaos stalls; no test sleeps to order
events.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.obs import report as j_report
from erasurehead_tpu.serve import admission as j_admission
from erasurehead_tpu.serve import packer as j_packer
from erasurehead_tpu.serve import queue as j_queue
from erasurehead_tpu.serve import server as j_server
from erasurehead_tpu.serve import wal as j_wal
from erasurehead_tpu.train import cache as j_cache
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models import glm as t_glm
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs import report as report_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.serve import admission as admission_lib
from erasurehead_tpu_torch.serve import packer as packer_lib
from erasurehead_tpu_torch.serve import queue as serve_queue
from erasurehead_tpu_torch.serve import server as serve_server
from erasurehead_tpu_torch.serve import wal as wal_lib
from erasurehead_tpu_torch.serve.client import ServeClient, ServeUnavailableError, backoff_s
from erasurehead_tpu_torch.train import cache, experiments
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.train import trainer
from erasurehead_tpu_torch.utils import chaos
from erasurehead_tpu_torch.utils.config import (
    RunConfig,
    parse_bytes,
    resolve_serve_budget,
    resolve_serve_max_cohort,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, R = 4, 10
N_ROWS, N_COLS = 256, 16
#: the JAX daemon's and the port's losses and AUC from the same initial
#: params: float32 sums taken in another order
LOSS_RTOL = 1e-4
WIRE = {
    "scheme": "naive", "n_workers": W, "n_stragglers": 1, "rounds": R,
    "n_rows": N_ROWS, "n_cols": N_COLS, "lr_schedule": 0.5, "add_delay": True,
    "compute_mode": "deduped",
}


@pytest.fixture(scope="module")
def gmm():
    return generate_gmm(N_ROWS, N_COLS, W, 0)


@pytest.fixture(scope="module")
def j_gmm():
    return j_generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Chaos disarmed, the data cache empty, and the kernel build directory
    (process-global, set by ``cli serve --cache-dir``) restored after."""
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    monkeypatch.setattr(t_kernels, "_BUILD_DIR", t_kernels._BUILD_DIR)
    chaos.reset()
    cache.clear()
    yield
    cache.clear()
    chaos.reset()


def _kw(**kw):
    base = dict(
        scheme="naive", n_workers=W, n_stragglers=1, rounds=R,
        n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=0.5,
        add_delay=True, seed=0, compute_mode="deduped",
    )
    base.update(kw)
    return base


def _cfg(**kw):
    return RunConfig(**_kw(**kw))


def _req(gmm, tenant="t", label="naive", **cfg_kw):
    return serve_queue.RunRequest(tenant=tenant, label=label, config=_cfg(**cfg_kw), dataset=gmm)


def _j_req(j_gmm, tenant="t", label="naive", **cfg_kw):
    return j_queue.RunRequest(
        tenant=tenant, label=label, config=JRunConfig(**_kw(**cfg_kw)), dataset=j_gmm
    )


def _serving(**kw):
    return serve_server.serving(device="cpu", **kw)


def _science(summary) -> str:
    return json.dumps(
        journal_lib.science_row(journal_lib.summary_payload(summary)), sort_keys=True
    )


def _counter(name):
    return REGISTRY.counter(name).value


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _arm(monkeypatch, spec):
    monkeypatch.setenv(chaos.CHAOS_ENV, spec)
    chaos.reset()


# ---------------------------------------------------------------------------
# the kernel library under threads (the launch and the build stubbed)


class _Yielding(dict):
    """A dict that hands the interpreter to another thread between the read
    and the write of an increment, so two threads' ``d[k] += 1`` interleave
    as they can on any interpreter without a global lock."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_lose_nothing_under_threads(monkeypatch):
    """More threads than cores count 300 launches each through the
    wrappers' one counting path (kernels._count_launch), the interpreter
    switching threads as often as it can: every increment lands."""
    counts = _Yielding(t_kernels.LAUNCHES)
    monkeypatch.setattr(t_kernels, "LAUNCHES", counts)
    t_kernels.reset_launches()
    n_threads, n_each = 2 * (os.cpu_count() or 4), 300
    start = threading.Barrier(n_threads)

    def launch(name):
        start.wait()
        for _ in range(n_each):
            t_kernels._count_launch(name)

    threads = [threading.Thread(target=launch, args=(name,))
               for name in ("fused_glm_grad", "fused_block_decode") * (n_threads // 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    want = n_threads // 2 * n_each
    assert dict(counts) == {"fused_glm_grad": want, "fused_block_decode": want}


def test_library_builds_and_loads_once_under_concurrent_first_calls(monkeypatch, tmp_path):
    """Many threads make their first kernel call together: one build and one
    load, every caller gets the same library object."""
    builds, loads = [], []
    gate = threading.Barrier(6)

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a build takes long enough for the others to arrive
        return tmp_path / "eh_kernels-fake.so"

    def fake_load(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(t_kernels, "_LIB", None)
    monkeypatch.setattr(t_kernels, "_build", fake_build)
    monkeypatch.setattr(t_kernels, "_load", fake_load)
    got = []

    def first_call():
        gate.wait()
        got.append(t_kernels._library())

    threads = [threading.Thread(target=first_call) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert len({id(lib) for lib in got}) == 1 and t_kernels.library_loaded()
    # a loaded library stays where it was built from
    with pytest.raises(RuntimeError, match="before the first kernel call"):
        t_kernels.set_build_dir(tmp_path / "elsewhere")


def test_build_counts_each_compile_and_none_warm(monkeypatch, tmp_path):
    """The real build path with a stand-in compiler that writes what ``-o``
    names: the first build compiles and counts one in ``BUILDS``; a second
    call on the same sources finds the library and counts none."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(t_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(t_kernels, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_kernels, "BUILDS", 0)
    so = t_kernels._build()
    assert so == t_kernels.library_path() and so.exists() and t_kernels.BUILDS == 1
    assert sorted(f.name for f in so.parent.iterdir()) == sorted(
        [so.name, so.with_suffix(".log").name])
    assert t_kernels._build() == so and t_kernels.BUILDS == 1


def test_the_daemon_records_cache_dir_and_leaves_the_build_directory(tmp_path):
    """``SweepServer(cache_dir=...)`` records the directory; the kernel
    layer's build directory (one per process) stays where it was."""
    before = t_kernels._BUILD_DIR
    srv = serve_server.SweepServer(cache_dir=str(tmp_path / "c"), device="cpu")
    assert srv.cache_dir == str(tmp_path / "c") and t_kernels._BUILD_DIR == before


def test_cli_serve_sets_the_build_directory_before_the_daemon(tmp_path):
    """``cli serve --cache-dir C`` points the kernel layer at C before it
    constructs the daemon (which then refuses here: no card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the daemon would start and serve")
    from erasurehead_tpu_torch import cli

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["serve", "--socket", str(tmp_path / "s.sock"),
                  "--cache-dir", str(tmp_path / "c")])
    assert t_kernels._BUILD_DIR == (tmp_path / "c").resolve()


# ---------------------------------------------------------------------------
# config resolvers and the wire model


def test_budget_resolvers_as_jax():
    from erasurehead_tpu.utils import config as j_config

    assert parse_bytes("2g") == 2 << 30
    for args in ((None, ""), ("1m", None), (None, "2k")):
        assert resolve_serve_budget(*args) == j_config.resolve_serve_budget(*args)
    assert resolve_serve_budget(None, env="") is None
    for args in ((None, ""), (8, None), (None, "16")):
        assert resolve_serve_max_cohort(*args) == j_config.resolve_serve_max_cohort(*args)
    with pytest.raises(ValueError):
        resolve_serve_max_cohort(0)
    with pytest.raises(ValueError, match="must be an integer"):
        resolve_serve_max_cohort(None, env="many")


PAYLOAD_CASES = [
    {},
    {"scheme": "approx", "num_collect": 3, "seed": 7},
    {"compute_mode": "faithful", "scheme": "cyccoded", "update_rule": "GD"},
    {"stack_dtype": "bfloat16", "dtype": "bfloat16"},
    {"stack_dtype": "int8", "use_pallas": "off"},
    {"model": "deepmlp", "layer_coding": "on", "deep_layers": 2, "lr_schedule": [0.5] * R},
    {"stack_residency": "streamed", "stream_window": 2, "decode": "optimal",
     "scheme": "approx", "num_collect": 3},
]


@pytest.mark.parametrize("extra", PAYLOAD_CASES, ids=range(len(PAYLOAD_CASES)))
def test_config_payload_is_jax_dict(extra):
    """Every config both packages express: the port's payload is the JAX
    package's dict, and it round-trips to an equal config."""
    cfg = _cfg(**extra)
    got = serve_queue.config_payload(cfg)
    want = j_queue.config_payload(JRunConfig(**_kw(**extra)))
    assert got == want
    assert serve_queue.config_from_payload(got) == cfg
    assert events_lib.config_hash(serve_queue.config_from_payload(got)) == events_lib.config_hash(cfg)


@pytest.mark.parametrize("field,value,item", [
    ("donate", "off", "A5r"), ("scan_unroll", 2, "A5r"),
])
def test_absent_payload_fields_refused_naming_their_item(field, value, item):
    """The two fields ROADMAP item A5r (the compiled round loop) brought:
    the wire takes them as the JAX package's does (the port's payload is the
    JAX package's dict and round-trips to an equal config), and the packer
    keys them: a request that sets one never shares a cohort with one that
    does not."""
    j_cfg = j_queue.config_from_payload({"scheme": "naive", field: value})
    got = serve_queue.config_from_payload({"scheme": "naive", field: value})
    assert getattr(got, field) == getattr(j_cfg, field) == value
    assert serve_queue.config_payload(got) == j_queue.config_payload(j_cfg)
    assert serve_queue.config_from_payload(serve_queue.config_payload(got)) == got
    gmm = generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)
    plain = packer_lib.pack_key(_req(gmm))
    keyed = packer_lib.pack_key(_req(gmm, **{field: value}))
    assert plain is not None and keyed is not None and plain != keyed
    assert packer_lib.pack_key(_req(gmm, **{field: value})) == keyed


@pytest.mark.parametrize("field,value", [
    ("stack_mode", "ring"), ("ring_pipeline", "off"),
])
def test_ring_payload_fields_are_served_as_jax_serves_them(field, value):
    """The ring transport's two knobs ride the wire: the port's payload is
    the JAX package's dict, and it round-trips to an equal config."""
    got = serve_queue.config_from_payload({"scheme": "naive", field: value})
    assert getattr(got, field) == value
    want = j_queue.config_from_payload({"scheme": "naive", field: value})
    assert serve_queue.config_payload(got) == j_queue.config_payload(want)


def test_config_from_payload_validates():
    cfg = serve_queue.config_from_payload({"scheme": "approx", "n_workers": 8, "num_collect": 4})
    assert cfg.scheme.value == "approx" and cfg.num_collect == 4
    with pytest.raises(ValueError, match="unserveable"):
        serve_queue.config_from_payload({"input_dir": "/x"})
    with pytest.raises(ValueError, match="JSON object"):
        serve_queue.config_from_payload(["not", "a", "dict"])
    # host-path fields make a config non-WAL-replayable
    assert serve_queue.config_payload(
        _cfg(is_real_data=True, input_dir="/x", dataset="covtype")) is None


def test_request_digest_keys_what_not_when():
    d = serve_queue.request_digest("t", "l", _cfg())
    assert d == serve_queue.request_digest("t", "l", _cfg())
    assert d != serve_queue.request_digest("t", "l", _cfg(seed=1))
    assert d != serve_queue.request_digest("u", "l", _cfg())
    assert d != serve_queue.request_digest("t", "l", _cfg(), data_seed=1)
    a = serve_queue.RunRequest(tenant="t", label="l", config=_cfg(), priority=3, retry=2)
    b = serve_queue.RunRequest(tenant="t", label="l", config=_cfg())
    assert a.request_id != b.request_id and a.request_id.startswith("t-req-")
    with pytest.raises(ValueError, match="tenant"):
        serve_queue.RunRequest(tenant="", label="l", config=_cfg())


# ---------------------------------------------------------------------------
# the intake WAL


def test_wal_append_dedupes_by_digest(tmp_path):
    w = wal_lib.IntakeWAL(str(tmp_path))
    rec = dict(tenant="t", request_id="t-req-1", label="l", digest="d1",
               config_payload={"scheme": "naive"})
    assert w.append(**rec)
    assert not w.append(**{**rec, "request_id": "t-req-2"})
    assert w.seen("d1") and not w.seen("d2") and len(w.replay()) == 1
    w.close()
    w2 = wal_lib.IntakeWAL(str(tmp_path))  # a fresh WAL rereads the digests
    assert w2.seen("d1") and len(w2) == 1
    w2.close()


def test_wal_torn_final_line_tolerated(tmp_path):
    w = wal_lib.IntakeWAL(str(tmp_path))
    w.append(tenant="t", request_id="r1", label="l", digest="d1",
             config_payload={"scheme": "naive"})
    w.close()
    with open(w.path, "a") as f:
        f.write('{"type": "request", "digest": "d2", "conf')  # torn
    w2 = wal_lib.IntakeWAL(str(tmp_path))
    assert [r["digest"] for r in w2.replay()] == ["d1"]
    w2.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_is_read_alike_by_both_packages(tmp_path, writer):
    """A WAL either package wrote reads back, through the other's
    read_records/dedup_records, into the same acceptances."""
    mod = j_wal if writer == "jax" else wal_lib
    w = mod.IntakeWAL(str(tmp_path))
    for k, (digest, seed) in enumerate((("d1", 0), ("d2", 1), ("d1", 0))):
        payload = serve_queue.config_payload(_cfg(seed=seed))
        w.append(tenant="t", request_id=f"t-req-{k}", label=f"l{seed}", digest=digest,
                 config_payload=payload, data_seed=seed, priority=k)
    w.close()
    path = os.path.join(str(tmp_path), wal_lib.WAL_NAME)
    assert wal_lib.WAL_NAME == j_wal.WAL_NAME

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in ("seq", "t")} for r in recs]

    got = strip(wal_lib.dedup_records(wal_lib.read_records(path)))
    want = strip(j_wal.dedup_records(j_wal.read_records(path)))
    assert got == want and [r["digest"] for r in got] == ["d1", "d2"]
    for r in got:
        assert serve_queue.config_from_payload(r["config"]) == _cfg(seed=r["data_seed"])


def test_wal_adopt_has_one_winner(tmp_path):
    """Adoption of a dead peer's WAL: refused while its owner answers, and
    of the adopters racing for it exactly one wins (the O_EXCL sentinel);
    records this WAL accepted itself are dropped."""
    dead = wal_lib.IntakeWAL(str(tmp_path / "dead"))
    for d in ("d1", "d2"):
        dead.append(tenant="t", request_id=f"r-{d}", label=d, digest=d,
                    config_payload={"scheme": "naive"})
    dead.close()
    mine = wal_lib.IntakeWAL(str(tmp_path / "mine"))
    with pytest.raises(wal_lib.WalAdoptionError, match="cannot adopt itself"):
        mine.adopt(mine.path)
    with pytest.raises(wal_lib.WalAdoptionError, match="still answers"):
        mine.adopt(dead.path, owner_alive=lambda: True)
    mine.append(tenant="t", request_id="r-d1", label="d1", digest="d1",
                config_payload={"scheme": "naive"})
    adopters = [mine] + [wal_lib.IntakeWAL(str(tmp_path / f"peer{k}")) for k in range(5)]
    gate = threading.Barrier(len(adopters))
    won, refused = [], []

    def adopt(w):
        gate.wait()
        try:
            won.append((w, w.adopt(dead.path)))
        except wal_lib.WalAdoptionError:
            refused.append(w)

    threads = [threading.Thread(target=adopt, args=(w,)) for w in adopters]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(won) == 1 and len(refused) == len(adopters) - 1
    w, recs = won[0]
    assert [r["digest"] for r in recs] == (["d2"] if w is mine else ["d1", "d2"])
    assert os.path.exists(dead.path + wal_lib.ADOPT_SENTINEL_SUFFIX)
    for a in adopters:
        a.close()


# ---------------------------------------------------------------------------
# the packer, against the JAX package's plans


class TestPacker:
    def test_same_signature_packs_across_tenants(self, gmm):
        packs = packer_lib.plan_packs(
            [_req(gmm, tenant=f"t{k}", label=f"r{k}", seed=k) for k in range(4)])
        assert len(packs) == 1 and packs[0].batchable
        assert packs[0].tenants == ["t0", "t1", "t2", "t3"]

    def test_distinct_datasets_never_pack(self, gmm):
        other = generate_gmm(N_ROWS, N_COLS, W, 0)
        assert len(packer_lib.plan_packs([_req(gmm), _req(other, tenant="u")])) == 2

    def test_memory_knobs_never_pack(self, gmm):
        packs = packer_lib.plan_packs([_req(gmm, tenant="a"),
                                       _req(gmm, tenant="b", stack_dtype="int8")])
        assert len(packs) == 2

    @pytest.mark.parametrize("kw", [
        dict(arrival_mode="measured", compute_mode="faithful"),
        dict(use_pallas="on", compute_mode="faithful"),
    ], ids=["measured", "use_pallas_on"])
    def test_ineligible_is_sequential_singleton(self, gmm, kw):
        packs = packer_lib.plan_packs([_req(gmm, **kw), _req(gmm, label="b", **kw)])
        assert [len(p.requests) for p in packs] == [1, 1]
        assert not any(p.batchable for p in packs) and packs[0].key is None
        assert packs[0].key_digest == "sequential"

    def test_max_cohort_chunks(self, gmm):
        reqs = [_req(gmm, label=f"r{k}", seed=k) for k in range(5)]
        assert [len(p.requests) for p in packer_lib.plan_packs(reqs, max_cohort=2)] == [2, 2, 1]
        with pytest.raises(ValueError, match="max_cohort"):
            packer_lib.plan_packs(reqs, max_cohort=0)
        with pytest.raises(ValueError, match="tenant_quota"):
            packer_lib.plan_packs(reqs, tenant_quota=0)


def _flood_specs():
    """The starvation pattern: tenant a's 6-deep backlog arrives before b's
    and c's 2 each, then a bf16 request and an ineligible one."""
    return (
        [("a", f"a{k}", dict(seed=k)) for k in range(6)]
        + [("b", f"b{k}", dict(seed=10 + k)) for k in range(2)]
        + [("c", f"c{k}", dict(seed=20 + k)) for k in range(2)]
        + [("c", "c_bf16", dict(stack_dtype="bfloat16", dtype="bfloat16")),
           ("b", "b_measured", dict(arrival_mode="measured", compute_mode="faithful"))]
    )


PLAN_CASES = {
    "fair": dict(max_cohort=4),
    "fifo": dict(max_cohort=4, fair=False),
    "quota": dict(max_cohort=4, tenant_quota=1),
    "priority": dict(max_cohort=2),
    "lone_window": dict(max_cohort=16),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plans_equal_jax(gmm, j_gmm, case):
    """On the same request list the port plans JAX's cohorts: labels,
    tenants, order and batchable."""
    specs = _flood_specs()
    t_reqs = [_req(gmm, tenant=t, label=label, **kw) for t, label, kw in specs]
    j_reqs = [_j_req(j_gmm, tenant=t, label=label, **kw) for t, label, kw in specs]
    if case == "priority":
        for reqs in (t_reqs, j_reqs):
            reqs[3].priority = 5
            reqs[7].priority = 2

    def shape(packs):
        return [(p.labels, p.tenants, p.batchable) for p in packs]

    got = shape(packer_lib.plan_packs(t_reqs, **PLAN_CASES[case]))
    assert got == shape(j_packer.plan_packs(j_reqs, **PLAN_CASES[case]))
    if case == "fair":
        assert got[0][0] == ["a0", "b0", "c0", "a1"]
    if case == "quota":
        assert got[0][0] == ["a0", "b0", "c0"]


# ---------------------------------------------------------------------------
# footprint estimates and admission, against the JAX package's


ESTIMATE_CASES = {
    "deduped": {},
    "faithful": dict(scheme="cyccoded", compute_mode="faithful"),
    "bf16": dict(stack_dtype="bfloat16", dtype="bfloat16"),
    "int8": dict(stack_dtype="int8"),
    "streamed": dict(stack_residency="streamed", stream_window=1),
    "streamed_faithful": dict(scheme="cyccoded", compute_mode="faithful",
                              stack_residency="streamed", stream_window=2),
}


@pytest.mark.parametrize("case", sorted(ESTIMATE_CASES))
def test_footprint_estimates_equal_jax(gmm, j_gmm, case):
    kw = ESTIMATE_CASES[case]
    assert trainer.estimate_stack_bytes(_cfg(**kw), gmm) == j_trainer.estimate_stack_bytes(
        JRunConfig(**_kw(**kw)), j_gmm)
    t_cohort = packer_lib.plan_packs([_req(gmm, **kw)])[0]
    j_cohort = j_packer.plan_packs([_j_req(j_gmm, **kw)])[0]
    for width in (None, 1, 8):
        assert admission_lib.estimate_cohort_bytes(t_cohort, width=width) == (
            j_admission.estimate_cohort_bytes(j_cohort, width=width))


def test_sparse_estimate_equals_jax():
    from erasurehead_tpu.data import sharding as j_sharding
    from erasurehead_tpu.data.synthetic import generate_onehot as j_onehot
    from erasurehead_tpu_torch.data import sharding
    from erasurehead_tpu_torch.data.synthetic import generate_onehot

    ds = generate_onehot(240, 60, W, n_fields=3, seed=0)
    jds = j_onehot(240, 60, W, n_fields=3, seed=0)
    for kw in ({}, dict(scheme="cyccoded", compute_mode="faithful")):
        cfg = _cfg(n_rows=240, n_cols=60, **kw)
        assert trainer.estimate_stack_bytes(cfg, ds) == j_trainer.estimate_stack_bytes(
            JRunConfig(**_kw(n_rows=240, n_cols=60, **kw)), jds)
    layout = trainer.build_layout(_cfg())
    assert sharding.estimate_worker_stack_bytes(ds, layout, "float32") == (
        j_sharding.estimate_worker_stack_bytes(jds, j_trainer.build_layout(JRunConfig(**_kw())),
                                               np.float32))


def _admission_script(adm, pkg_cache, cohort, capture, path):
    """try_admit / release / observe in a fixed order; returns the verdicts
    and the admit/evict records."""
    est = adm.estimate_cohort_bytes(cohort)
    ctl = adm.AdmissionController(budget_bytes=int(est * 1.5))
    verdicts = []
    with capture(path):
        verdicts.append(ctl.try_admit(cohort, "d1"))  # admits
        verdicts.append(ctl.try_admit(cohort, "d2"))  # defers: d1 in flight
        pkg_cache._data_cache["pin"] = (None, est // 4)
        verdicts.append(ctl.try_admit(cohort, "d3"))  # busy: defer, cache kept
        verdicts.append(pkg_cache.data_cache_bytes())
        ctl.release("d1")
        pkg_cache._data_cache["pin"] = (None, est)
        verdicts.append(ctl.try_admit(cohort, "d2"))  # idle: evict, then admit
        verdicts.append(pkg_cache.data_cache_bytes())
        ctl.release("d2")
        verdicts.append(ctl.pressure())
        verdicts.append(ctl.try_admit(cohort, "d4", width=64))  # over budget alone: admits
        ctl.release("d4")
    recs = [{k: v for k, v in r.items() if k not in ("seq", "t", "cohort")}
            for r in _records(path) if r["type"] in ("admit", "evict")]
    return verdicts, recs


def test_admission_script_equals_jax(gmm, j_gmm, tmp_path):
    got = _admission_script(admission_lib, cache, packer_lib.plan_packs([_req(gmm)])[0],
                            events_lib.capture, str(tmp_path / "t.jsonl"))
    j_cache.clear()
    try:
        want = _admission_script(j_admission, j_cache,
                                 j_packer.plan_packs([_j_req(j_gmm)])[0],
                                 j_events.capture, str(tmp_path / "j.jsonl"))
    finally:
        j_cache.clear()
    assert got == want
    assert got[0][:3] == [True, False, False] and got[0][4] is True
    assert [r["type"] for r in got[1]].count("evict") == 1
    assert events_lib.validate_file(str(tmp_path / "t.jsonl")) == []


def test_measured_footprint_only_ratchets_up(gmm):
    """A measured peak raises the signature's charge; a smaller one, or no
    measurement (the CPU, a concurrent dispatch), leaves it."""
    cohort = packer_lib.plan_packs([_req(gmm)])[0]
    est = admission_lib.estimate_cohort_bytes(cohort)
    ctl = admission_lib.AdmissionController()
    for info in (None, {}, {"device_peak_bytes": None}, {"device_peak_bytes": 10}):
        ctl.observe(cohort, info)
        assert ctl.charge_for(cohort) == est
    ctl.observe(cohort, {"device_peak_bytes": 3 * est})
    ctl.observe(cohort, {"device_peak_bytes": 2 * est})
    assert ctl.charge_for(cohort) == 3 * est
    assert ctl.measured_bytes(cohort.key_digest) == 3 * est


def test_cpu_dispatch_measures_nothing(gmm):
    with _serving(window_s=0.01, max_cohort=2) as srv:
        assert srv.submit(tenant="t", label="l", config=_cfg(), dataset=gmm).result(
            timeout=60).status == "ok"
        cohort = packer_lib.plan_packs([_req(gmm)])[0]
        assert srv.admission.measured_bytes(cohort.key_digest) is None


def test_device_defaults_to_the_card():
    """SweepServer() means cuda: without a card it raises at construction;
    the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve_server.SweepServer()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        with serve_server.serving():
            pass
    assert serve_server.SweepServer(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# dispatch: packing, bitwise invariance, the JAX daemon's rows


SPECS = [
    (f"t{k}", f"{s}_{k}", dict(scheme=s, seed=k, **extra))
    for k in range(4)
    for s, extra in (("naive", {}), ("approx", {"num_collect": 3}))
]


def test_concurrent_tenants_pack_and_rows_are_bitwise_alone(gmm):
    """4 tenants on 4 threads submit 8 same-signature requests: they pack
    (fewer dispatches than requests), and every row is bitwise the row of the
    same request dispatched ALONE (column 0 of its own padded dispatch),
    whatever column it packed into."""
    d0 = _counter("serve.dispatches")
    with _serving(window_s=0.2, max_cohort=8, dispatch_workers=2) as srv:
        handles, lock = [], threading.Lock()

        def client(tenant):
            for tn, label, kw in SPECS:
                if tn == tenant:
                    h = srv.submit(tenant=tn, label=label, config=_cfg(**kw), dataset=gmm)
                    with lock:
                        handles.append(h)

        threads = [threading.Thread(target=client, args=(f"t{k}",)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        packed = {h.result(timeout=120).label: h.result() for h in handles}
    assert _counter("serve.dispatches") - d0 < len(SPECS)
    assert {r.status for r in packed.values()} == {"ok"}
    with _serving(window_s=0.001, max_cohort=8) as srv:
        for tn, label, kw in SPECS:
            res = srv.submit(tenant=tn, label=label, config=_cfg(**kw), dataset=gmm).result(
                timeout=120)
            assert res.status == "ok"
            assert _science(res.summary) == _science(packed[label].summary), (
                f"row {label} changed bits when packed")


def test_rows_match_the_jax_daemon(gmm, j_gmm, monkeypatch):
    """The same requests through the JAX daemon and the port's, the port
    started from JAX's initial params: simulated clocks and statuses equal,
    losses and AUC within rtol 1e-4."""
    cfgs = {"naive": {}, "agc": dict(scheme="approx", num_collect=3, seed=1)}
    inits = {}
    for kw in cfgs.values():
        jcfg = JRunConfig(**_kw(**kw))
        inits[jcfg.seed] = np.asarray(
            j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), N_COLS))
    monkeypatch.setattr(t_glm.LogisticModel, "init_params",
                        lambda self, seed, F, device="cpu": torch.from_numpy(
                            inits[seed]).to(device))
    with j_server.serving(window_s=0.05, max_cohort=2) as srv:
        want = {label: srv.submit(tenant="t", label=label, config=JRunConfig(**_kw(**kw)),
                                  dataset=j_gmm).result(timeout=300).summary
                for label, kw in cfgs.items()}
    with _serving(window_s=0.05, max_cohort=2) as srv:
        got = {label: srv.submit(tenant="t", label=label, config=_cfg(**kw),
                                 dataset=gmm).result(timeout=120).summary
               for label, kw in cfgs.items()}
    for label in cfgs:
        g, w = got[label], want[label]
        assert g.status == w.status == "ok"
        assert g.sim_total_time == w.sim_total_time
        np.testing.assert_array_equal(g.timeset, w.timeset)
        np.testing.assert_allclose(g.training_loss, w.training_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(g.final_auc, w.final_auc, rtol=LOSS_RTOL)


def test_results_match_plain_compare(gmm):
    """Serve rows agree with a local compare() of the same configs to float
    tolerance (other cohort widths), the control-plane columns equal."""
    cfgs = {"naive": _cfg(), "agc": _cfg(scheme="approx", num_collect=3)}
    arrivals = {label: trainer.default_arrivals(c) for label, c in cfgs.items()}
    with _serving(window_s=0.05) as srv:
        rows = {label: srv.submit(tenant="t", label=label, config=c, dataset=gmm,
                                  arrivals=arrivals[label]).result(timeout=120).summary
                for label, c in cfgs.items()}
    for label, c in cfgs.items():
        local = experiments.compare({label: c}, gmm, arrivals=arrivals[label], batch="off",
                                    device="cpu")[0]
        s = rows[label]
        assert s.sim_total_time == local.sim_total_time and s.status == local.status == "ok"
        np.testing.assert_array_equal(s.timeset, local.timeset)
        np.testing.assert_allclose(s.training_loss, local.training_loss, rtol=2e-5, atol=1e-6)


def test_admission_queues_behind_running_cohort(gmm, monkeypatch, tmp_path):
    """A budget of one cohort: a second (other-signature) cohort QUEUES
    while the first dispatch runs (held by a chaos stall) and dispatches
    only once it released its charge."""
    _arm(monkeypatch, "stall:serve_dispatch:1:0.5")
    one = packer_lib.plan_packs([_req(gmm)])[0]
    budget = admission_lib.estimate_cohort_bytes(one, width=2) + 1
    done = []
    events_lib.add_observer(lambda r: done.append(r["label"])
                            if r["type"] == "request" and r.get("phase") == "done" else None)
    path = str(tmp_path / "admit.jsonl")
    try:
        with events_lib.capture(path):
            with _serving(budget_bytes=budget, window_s=0.01, max_cohort=2) as srv:
                h1 = srv.submit(tenant="a", label="first", config=_cfg(), dataset=gmm)
                h2 = srv.submit(tenant="b", label="second", dataset=gmm,
                                config=_cfg(scheme="approx", num_collect=3,
                                            stack_dtype="bfloat16", dtype="bfloat16"))
                r1, r2 = h1.result(timeout=120), h2.result(timeout=120)
    finally:
        events_lib._observers.clear()
    assert r1.status == r2.status == "ok"
    admits = [r["admitted"] for r in _records(path) if r["type"] == "admit"]
    assert admits[0] is True and False in admits and admits[-1] is True
    assert done.index("first") < done.index("second")
    assert events_lib.validate_file(path) == []


def test_divergence_quarantined_per_tenant(gmm):
    with _serving(window_s=0.05) as srv:
        bad = srv.submit(tenant="boomer", label="boom", dataset=gmm,
                         config=_cfg(scheme="avoidstragg", lr_schedule=1e12, model="linear"))
        good = srv.submit(tenant="steady", label="fine", config=_cfg(), dataset=gmm)
        rb, rg = bad.result(timeout=120), good.result(timeout=120)
    assert rb.status == "diverged" and rg.status == "ok"
    assert np.isfinite(rg.summary.final_train_loss)


def test_errors_isolated_to_their_request_and_cohort(gmm, monkeypatch):
    """A request whose dataset cannot load fails alone; an injected dispatch
    failure fails only its own cohort, and the daemon serves on."""
    with _serving(window_s=0.01) as srv:
        broken = srv.submit(tenant="t", label="broken",
                            config=_cfg(dataset="covtype", is_real_data=True,
                                        input_dir="/nonexistent"))
        rb = broken.result(timeout=60)
        _arm(monkeypatch, "raise:serve_dispatch:1:BOOM")
        hit = [srv.submit(tenant=t, label=f"hit_{t}", config=_cfg(seed=k), dataset=gmm)
               for k, t in enumerate(("a", "b"))]
        rh = [h.result(timeout=60) for h in hit]
        healthy = srv.submit(tenant="c", label="ok", config=_cfg(seed=5), dataset=gmm)
        rok = healthy.result(timeout=120)
    assert rb.status == "error" and "FileNotFoundError" in rb.error
    assert [r.status for r in rh] == ["error", "error"]
    assert all("BOOM" in r.error and "serve_dispatch" in r.error for r in rh)
    assert rok.status == "ok"


def test_per_tenant_journal_resume(gmm, tmp_path):
    jdir = str(tmp_path / "serve-journal")
    cfg = _cfg()
    with _serving(window_s=0.01, journal_dir=jdir) as srv:
        first = srv.submit(tenant="alice", label="naive", config=cfg, dataset=gmm).result(
            timeout=120)
    jpath = os.path.join(jdir, "alice", journal_lib.JOURNAL_NAME)
    assert events_lib.validate_file(jpath) == []
    d0, r0 = _counter("serve.dispatches"), _counter("serve.resumed")
    with _serving(window_s=0.01, journal_dir=jdir) as srv:
        again = srv.submit(tenant="alice", label="naive", config=cfg, dataset=gmm).result(
            timeout=60)
        bob = srv.submit(tenant="bob", label="naive", config=cfg, dataset=gmm).result(
            timeout=120)
    assert again.resumed and not bob.resumed
    assert _counter("serve.resumed") == r0 + 1 and _counter("serve.dispatches") == d0 + 1
    assert json.dumps(again.row, sort_keys=True) == json.dumps(first.row, sort_keys=True)
    assert _science(bob.summary) == _science(first.summary)


def test_use_pallas_on_is_its_own_sequential_singleton(gmm, tmp_path):
    """A forced-kernel request dispatches alone through train() (the
    non-batchable path), beside a packed cohort; its row is train()'s."""
    path = str(tmp_path / "pack.jsonl")
    with events_lib.capture(path):
        with _serving(window_s=0.2, max_cohort=4) as srv:
            hs = [srv.submit(tenant="t", label=f"p{k}", config=_cfg(seed=k), dataset=gmm)
                  for k in range(2)]
            hs.append(srv.submit(tenant="u", label="fused", dataset=gmm,
                                 config=_cfg(compute_mode="faithful", use_pallas="on")))
            res = {h.result(timeout=120).label: h.result() for h in hs}
    assert {r.status for r in res.values()} == {"ok"}
    packs = [r for r in _records(path) if r["type"] == "pack"]
    assert sorted((p["labels"], p["batchable"]) for p in packs) == [
        (["fused"], False), (["p0", "p1"], True)]
    direct = trainer.train(_cfg(compute_mode="faithful", use_pallas="on"), gmm, device="cpu")
    assert direct.lowering == "fused"
    np.testing.assert_array_equal(res["fused"].summary.timeset, direct.timeset)


def test_the_non_batchable_path_retries_a_transient(gmm, monkeypatch):
    """A forced-kernel request goes through sequential train(), the
    non-batchable path: a transient failure of its train() is retried, as
    the JAX daemon's guarded path retries it (one ``cohort.retry``), and
    its row is bitwise the undisturbed daemon's."""
    cfg = _cfg(compute_mode="faithful", use_pallas="on")
    with _serving(window_s=0.01) as srv:
        clean = srv.submit(tenant="t", label="fused", config=cfg, dataset=gmm).result(timeout=120)
    monkeypatch.setattr(experiments, "COHORT_BACKOFF_S", 0.001)
    real, fails = trainer.train, [chaos.ChaosInjection("UNAVAILABLE: injected")]

    def flaky(*a, **k):
        if fails:
            raise fails.pop()
        return real(*a, **k)

    monkeypatch.setattr(trainer, "train", flaky)
    r0 = _counter("cohort.retry")
    with _serving(window_s=0.01) as srv:
        res = srv.submit(tenant="t", label="fused", config=cfg, dataset=gmm).result(timeout=120)
    assert res.status == clean.status == "ok" and not fails
    assert _counter("cohort.retry") == r0 + 1
    assert _science(res.summary) == _science(clean.summary)


def test_two_dispatch_threads_run_glm_and_deep_cohorts_together(gmm):
    """Two cohorts of different signatures (a GLM cohort and a layer-coded
    deepmlp cohort) in flight on the two dispatch threads at once: every
    row ok and bitwise its alone row."""
    deep = dict(model="deepmlp", layer_coding="on", update_rule="GD", compute_mode="faithful",
                scheme="approx", num_collect=3, deep_layers=2)
    specs = [("g", f"glm{k}", dict(seed=k)) for k in range(2)] + [
        ("d", f"deep{k}", dict(seed=k, **deep)) for k in range(2)]
    with _serving(window_s=0.2, max_cohort=2, dispatch_workers=2) as srv:
        hs = [srv.submit(tenant=t, label=label, config=_cfg(**kw), dataset=gmm)
              for t, label, kw in specs]
        packed = {h.result(timeout=120).label: h.result() for h in hs}
    assert {r.status for r in packed.values()} == {"ok"}
    with _serving(window_s=0.001, max_cohort=2, dispatch_workers=1) as srv:
        for t, label, kw in specs:
            alone = srv.submit(tenant=t, label=label, config=_cfg(**kw), dataset=gmm).result(
                timeout=120)
            assert _science(alone.summary) == _science(packed[label].summary), label


# ---------------------------------------------------------------------------
# the socket front, backpressure, timeouts, unavailability


def test_socket_submit_roundtrip_and_bad_payload(tmp_path):
    sock = str(tmp_path / "eh.sock")
    with _serving(window_s=0.01) as srv:
        front = serve_server.SocketFront(srv, sock)
        try:
            client = ServeClient(sock)
            rid = client.submit("wire-tenant", "naive-wire", WIRE)
            res = client.result(timeout=120)
            assert res["request_id"] == rid and res["status"] == "ok"
            assert res["row"]["label"] == "naive-wire"
            with pytest.raises(RuntimeError, match="unserveable"):
                client.submit("w", "bad", {"scheme": "naive", "warp_drive": 9})
            with pytest.raises(RuntimeError, match="unserveable"):
                client.submit("w", "bad2", {"input_dir": "/etc"})
            # a donate payload is served as the JAX package serves it
            client.submit("w", "donate-wire", {**WIRE, "donate": "off"})
            res = client.result(timeout=120)
            assert res["status"] == "ok" and res["row"]["label"] == "donate-wire"
            client.close()
        finally:
            front.close()
    assert not os.path.exists(sock)


def test_max_pending_rejects_with_retry_after(gmm, tmp_path, monkeypatch):
    """Past the high-water mark submit() raises ServeOverloadedError with a
    positive retry-after and a ``reject`` record; the held request (a chaos
    stall keeps its dispatch in flight) then lands."""
    _arm(monkeypatch, "stall:serve_dispatch:1:0.5")
    path = str(tmp_path / "reject.jsonl")
    with events_lib.capture(path):
        with _serving(window_s=0.01, max_pending=1, max_cohort=2) as srv:
            h1 = srv.submit(tenant="a", label="one", config=_cfg(), dataset=gmm)
            with pytest.raises(serve_queue.ServeOverloadedError) as ei:
                srv.submit(tenant="b", label="two", config=_cfg(seed=1), dataset=gmm)
            assert ei.value.retry_after_s > 0
            assert h1.result(timeout=120).status == "ok"
    rejects = [r for r in _records(path) if r["type"] == "reject"]
    assert rejects and rejects[0]["tenant"] == "b" and rejects[0]["reason"] == "overloaded"
    assert rejects[0]["retry_after_s"] > 0
    assert events_lib.validate_file(path) == []


def test_socket_client_retries_on_rejected(tmp_path, monkeypatch):
    """'rejected' replies retried on the capped-exponential schedule land
    each submission exactly once."""
    _arm(monkeypatch, "stall:serve_dispatch:1+:0.2")
    sock = str(tmp_path / "eh.sock")
    with _serving(window_s=0.01, max_pending=1, max_cohort=1) as srv:
        front = serve_server.SocketFront(srv, sock)
        try:
            client = ServeClient(sock)
            rids = [client.submit("t", f"r{k}", {**WIRE, "seed": k}, max_retries=20)
                    for k in range(3)]
            assert client.rejected_total > 0 and client.retried_total == client.rejected_total
            got = {client.result(timeout=120)["request_id"] for _ in range(3)}
            assert got == set(rids)
            client.close()
        finally:
            front.close()


def test_backoff_schedule_is_deterministic():
    from erasurehead_tpu.serve.client import backoff_s as j_backoff

    assert backoff_s(0, 5.0) == 5.0
    assert backoff_s(0, None) == pytest.approx(0.1)
    assert backoff_s(3, 0.2) == pytest.approx(0.8)
    assert backoff_s(30, 0.0) == 10.0
    for a in range(6):
        for q in (None, 0.0, 0.3, 7.0):
            assert backoff_s(a, q) == j_backoff(a, q)


def test_retry_after_scales_with_queue_depth():
    srv = serve_server.SweepServer(max_cohort=4, device="cpu")
    srv._dispatch_ewma_s = 2.0
    assert srv.retry_after_s() == pytest.approx(2.0)
    with srv._state_lock:
        srv._queued = 12  # 4 windows ahead (ceil(13/4))
    assert srv.retry_after_s() == pytest.approx(8.0)
    srv._dispatch_ewma_s = 100.0
    assert srv.retry_after_s() == 60.0  # clamped


def test_stalled_dispatch_times_out_typed(gmm, tmp_path, monkeypatch):
    _arm(monkeypatch, "stall:serve_dispatch:1:1.0")
    path = str(tmp_path / "timeout.jsonl")
    r0 = _counter("serve.results")
    with events_lib.capture(path):
        with _serving(window_s=0.01, request_timeout_s=0.3) as srv:
            res = srv.submit(tenant="t", label="stalled", config=_cfg(), dataset=gmm).result(
                timeout=30)
    assert res.status == "error" and "RequestTimeout" in res.error and "0.3" in res.error
    # the late dispatch landed during the drain and lost the deliver-once race
    assert _counter("serve.results") == r0 + 1
    warn = [r for r in _records(path)
            if r["type"] == "warning" and r.get("kind") == "request_timeout"]
    assert warn and "stalled" in warn[0]["message"]
    assert events_lib.validate_file(path) == []


def test_validates_knobs():
    with pytest.raises(ValueError, match="request_timeout_s"):
        serve_server.SweepServer(request_timeout_s=0.0, device="cpu")
    with pytest.raises(ValueError, match="max_pending"):
        serve_server.SweepServer(max_pending=0, device="cpu")
    with pytest.raises(ValueError, match="budget_bytes"):
        serve_server.SweepServer(budget_bytes=0, device="cpu")


def test_connect_refused_is_typed(tmp_path):
    with pytest.raises(ServeUnavailableError, match="nope.sock"):
        ServeClient(str(tmp_path / "nope.sock"))


def test_daemon_death_translates_queue_empty(tmp_path):
    sock = str(tmp_path / "eh.sock")
    srv = serve_server.SweepServer(window_s=0.01, device="cpu").start()
    front = serve_server.SocketFront(srv, sock)
    client = ServeClient(sock)
    rid = client.submit("t", "ok", WIRE)
    assert client.result(timeout=120)["request_id"] == rid
    front.close()
    srv.stop()
    with pytest.raises(ServeUnavailableError) as ei:
        client.result(timeout=30)
    assert sock in str(ei.value) and ei.value.last_event == "result"
    with pytest.raises(ServeUnavailableError):
        client.submit("t", "again", WIRE)
    client.close()


# ---------------------------------------------------------------------------
# digest coalescing and the warm restart


def test_digest_coalesces_inflight_resubmission(tmp_path, monkeypatch):
    """An idempotent resubmission of an in-flight request rides the original
    dispatch (one dispatch, two replies)."""
    _arm(monkeypatch, "stall:serve_dispatch:1:0.3")
    d0, c0 = _counter("serve.dispatches"), _counter("serve.coalesced")
    with _serving(window_s=0.05, journal_dir=str(tmp_path / "j")) as srv:
        h1 = srv.submit(tenant="t", label="same", config=_cfg())
        h2 = srv.submit(tenant="t", label="same", config=_cfg())
        r1, r2 = h1.result(timeout=120), h2.result(timeout=120)
    assert r1.status == r2.status == "ok" and r2.resumed
    assert _counter("serve.dispatches") == d0 + 1 and _counter("serve.coalesced") == c0 + 1
    assert json.dumps(r1.row, sort_keys=True) == json.dumps(r2.row, sort_keys=True)


def test_restart_replays_the_wal_and_rehydrates_bitwise(tmp_path, monkeypatch):
    """Leg 1 serves r0, then every dispatch fails (raise:serve_dispatch:1+):
    r1 and r2 are accepted and WAL'd with no row. Leg 2, with the in-process
    caches cleared, replays the WAL: r0 rehydrates from the journal, r1 and
    r2 re-dispatch, and every resubmission is served from the journal with
    rows bitwise an uninterrupted daemon's."""
    jdir, cdir = str(tmp_path / "journal"), str(tmp_path / "build")
    cfgs = {f"r{k}": _cfg(seed=k) for k in range(3)}
    with _serving(window_s=0.01, journal_dir=jdir, cache_dir=cdir) as srv:
        first = srv.submit(tenant="t", label="r0", config=cfgs["r0"]).result(timeout=120)
        assert first.status == "ok"
        _arm(monkeypatch, "raise:serve_dispatch:1+")
        for h in [srv.submit(tenant="t", label=label, config=cfgs[label])
                  for label in ("r1", "r2")]:
            assert h.result(timeout=120).status == "error"
    monkeypatch.delenv(chaos.CHAOS_ENV)
    chaos.reset()
    cache.clear()
    path = str(tmp_path / "restart.jsonl")
    with events_lib.capture(path):
        with _serving(window_s=0.01, journal_dir=jdir, cache_dir=cdir) as srv:
            restart = None
            while restart is None:  # the replayed dispatches land before the rows are asked
                restart = next((r for r in _records(path) if r["type"] == "restart"), None)
                time.sleep(0.01)
            rows = {label: srv.submit(tenant="t", label=label, config=c).result(timeout=120)
                    for label, c in cfgs.items()}
    assert restart["wal_records"] == 3
    assert restart["rehydrated"] == 1 and restart["resubmitted"] == 2
    assert all(r.status == "ok" and r.resumed for r in rows.values())
    assert rows["r0"].row == first.row
    with _serving(window_s=0.01) as srv:  # the uninterrupted daemon
        for label, c in cfgs.items():
            clean = srv.submit(tenant="t", label=label, config=c).result(timeout=120)
            assert _science(clean.summary) == _science(rows[label].summary), label
    # the CPU builds no kernel library: the build directory stays empty
    assert not os.listdir(cdir) if os.path.isdir(cdir) else True
    assert events_lib.validate_file(path) == []


# ---------------------------------------------------------------------------
# events and the report


def test_serve_records_validate():
    def validate(recs):
        return events_lib.validate_lines(
            [json.dumps({"seq": i, "t": 0.0, **r}) for i, r in enumerate(recs)])

    assert validate([
        {"type": "request", "tenant": "a", "request_id": "a-req-1", "label": "agc"},
        {"type": "pack", "n_trajectories": 2, "labels": ["x", "y"], "tenants": ["a", "b"]},
        {"type": "admit", "est_bytes": 100, "budget_bytes": None, "admitted": True},
        {"type": "evict", "reason": "data_cache_pressure"},
        {"type": "reject", "tenant": "a", "reason": "overloaded", "retry_after_s": 1.5},
        {"type": "stream", "tenant": "a", "event": "close", "dropped": 7},
        {"type": "restart", "wal_records": 3, "resubmitted": 2, "rehydrated": 1},
    ]) == []
    joined = "\n".join(validate([
        {"type": "request", "tenant": "", "request_id": "r", "label": "l"},
        {"type": "pack", "n_trajectories": 3, "labels": ["x"], "tenants": []},
        {"type": "restart", "wal_records": 1, "resubmitted": 0},
    ]))
    assert "request tenant" in joined and "pack n_trajectories 3 != 1 labels" in joined
    assert "missing required ['rehydrated']" in joined


def _serve_section(out: str) -> list:
    lines = out.splitlines()
    i = next(k for k, line in enumerate(lines) if "serve (multi-tenant cohort packing)" in line)
    j = next((k for k in range(i + 1, len(lines)) if not lines[k].strip()), len(lines))
    return lines[i:j]


def test_report_serve_section_is_the_jax_report(gmm, tmp_path, capsys):
    path = str(tmp_path / "serve_events.jsonl")
    with events_lib.capture(path):
        with _serving(window_s=0.05) as srv:
            srv.submit(tenant="alice", label="ok", config=_cfg(), dataset=gmm).result(timeout=120)
            srv.submit(tenant="bob", label="boom", dataset=gmm,
                       config=_cfg(scheme="avoidstragg", lr_schedule=1e12,
                                   model="linear")).result(timeout=120)
    assert events_lib.validate_file(path) == []
    assert report_lib.main([path, "--validate"]) == 0
    got = _serve_section(capsys.readouterr().out)
    j_report.main([path])
    want = _serve_section(capsys.readouterr().out)
    assert got == want
    bob = [line for line in got if line.strip().startswith("bob")]
    assert bob and bob[0].split()[3] == "1"  # bob's diverged row


def test_journal_and_logger_under_concurrent_threads(gmm, tmp_path):
    rows = experiments.compare({"naive": _cfg()}, gmm, batch="off", device="cpu")
    j = journal_lib.SweepJournal(str(tmp_path), resume=False)
    lg = events_lib.EventLogger(str(tmp_path / "events.jsonl"), mode="a")

    def write(k):
        for i in range(20):
            j.record(f"k{k}-{i}", f"l{k}-{i}", rows[0])
            lg.emit("warning", kind="t", message=f"th{k}-{i}")

    threads = [threading.Thread(target=write, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    j.close()
    lg.close()
    assert len(j) == 80 and events_lib.validate_file(j.path) == []
    assert events_lib.validate_file(lg.path) == []
    assert len({json.loads(line)["message"] for line in open(lg.path)}) == 80


# ---------------------------------------------------------------------------
# the chaos sites and the CLI


@pytest.mark.parametrize("site", ["serve_intake", "serve_dispatch", "serve_reply"])
def test_serve_chaos_sites_are_wired(gmm, monkeypatch, site):
    """Each serve site parses and fires where the JAX daemon fires it: a
    raise at intake fails the submit, at dispatch and reply the cohort's
    requests."""
    assert site in chaos.WIRED_SITES and site not in chaos.UNWIRED_SITES
    assert not chaos.UNWIRED_SITES and "fleet_replica" in chaos.WIRED_SITES
    _arm(monkeypatch, f"raise:{site}:1:BOOM")
    with _serving(window_s=0.01) as srv:
        if site == "serve_intake":
            with pytest.raises(chaos.ChaosInjection, match="serve_intake"):
                srv.submit(tenant="t", label="x", config=_cfg(), dataset=gmm)
            res = srv.submit(tenant="t", label="y", config=_cfg(), dataset=gmm).result(
                timeout=120)
            assert res.status == "ok"
        else:
            res = srv.submit(tenant="t", label="x", config=_cfg(), dataset=gmm).result(
                timeout=120)
            assert res.status == "error" and site in res.error


def _daemon(tmp_path, jdir, events, env_extra=None):
    sock = str(tmp_path / "eh.sock")
    env = {k: v for k, v in os.environ.items() if k != chaos.CHAOS_ENV}
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "erasurehead_tpu_torch.cli", "serve", "--device", "cpu",
         "--socket", sock, "--journal-dir", jdir, "--events", events, "--window-ms", "10"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    seen = []
    for line in proc.stdout:  # the daemon prints this once it listens
        seen.append(line)
        if line.startswith("serve: listening on"):
            return proc, sock
    raise AssertionError(f"cli serve exited {proc.wait()} before listening: {seen}")


def test_cli_serve_kill_then_restart_replays_the_wal(tmp_path):
    """``cli serve --device cpu``: under kill:serve_dispatch:1 it accepts a
    submit and dies with exit 43; restarted on the same journal directory
    it replays the WAL (a restart record) and answers the resubmission from
    the journal."""
    jdir, events = str(tmp_path / "j"), str(tmp_path / "events.jsonl")
    proc, sock = _daemon(tmp_path, jdir, events, {chaos.CHAOS_ENV: "kill:serve_dispatch:1"})
    try:
        client = ServeClient(sock)
        client.submit("wire", "killed", WIRE)
        assert proc.wait(timeout=120) == chaos.KILL_EXIT
        client.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    proc, sock = _daemon(tmp_path, jdir, events)
    try:
        client = ServeClient(sock)
        rid = client.submit("wire", "killed", WIRE)
        res = client.result(timeout=120)
        assert res["request_id"] == rid and res["status"] == "ok"
        client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recs = _records(events)
    restart = [r for r in recs if r["type"] == "restart"]
    assert restart and restart[0]["wal_records"] == 1
    assert restart[0]["resubmitted"] + restart[0]["rehydrated"] == 1
    assert events_lib.validate_file(events) == []


def test_cli_serve_without_a_card_refuses(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    from erasurehead_tpu_torch import cli

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["serve", "--socket", str(tmp_path / "s.sock")])
    assert not os.path.exists(str(tmp_path / "s.sock"))
