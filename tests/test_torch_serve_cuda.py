"""Card-side pins of the serve daemon: the kernel library built once under
concurrent first calls from two threads, packed rows bitwise the rows of
the same requests dispatched alone on the card, a warm restart on the same
``cache_dir`` building nothing, and the measured footprint only ratcheting
up. Every test is marked ``cuda`` and skips without a card.

The module imports the port only: ``python -m pytest --noconftest -m cuda
tests/test_torch_serve_cuda.py``.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import kernels
from erasurehead_tpu_torch.serve import packer, queue, server
from erasurehead_tpu_torch.train import cache
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils.config import RunConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, R, N_ROWS, N_COLS = 8, 12, 8 * 64, 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cfg(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=6, rounds=R,
                n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
                add_delay=True, seed=0)
    base.update(kw)
    return RunConfig(**base)


def _science(summary) -> str:
    return json.dumps(journal_lib.science_row(journal_lib.summary_payload(summary)),
                      sort_keys=True)


def _python(code: str, timeout=600) -> dict:
    """Run ``code`` in a fresh interpreter at the repo root; it prints one
    JSON object last."""
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_two_threads_first_calls_build_the_library_once(tmp_path):
    """A fresh process, an empty build directory, two threads' first B1
    calls started together: one build (one .so), both results the plain
    version's within the kernel check's tolerance."""
    _card()
    got = _python(f"""
        import json, threading, torch
        from erasurehead_tpu_torch.ops import kernels
        kernels.set_build_dir({str(tmp_path)!r})
        g = torch.Generator().manual_seed(0)
        X = torch.randn(6, 300, 64, generator=g).cuda()
        y = torch.randn(6, 300, generator=g).sign().cuda()
        b = (torch.randn(64, generator=g) * 0.1).cuda()
        w = torch.rand(6, generator=g).cuda()
        gate, outs = threading.Barrier(2), []
        def first():
            gate.wait()
            outs.append(kernels.fused_glm_grad(b, X, y, w, "logistic"))
        ts = [threading.Thread(target=first) for _ in range(2)]
        [t.start() for t in ts]; [t.join() for t in ts]
        want = kernels.reference_glm_grad(b, X, y, w, "logistic")
        err = max(float((o - want).abs().max()) for o in outs)
        print(json.dumps(dict(builds=kernels.BUILDS, launches=kernels.LAUNCHES["fused_glm_grad"],
                              err=err, scale=float(want.abs().max()))))
    """)
    assert got["builds"] == 1 and got["launches"] == 2
    assert got["err"] <= 1e-5 * max(1.0, got["scale"])
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".so")]) == 1


@pytest.mark.cuda
def test_packed_rows_are_bitwise_alone_on_the_card():
    """Four same-signature requests packed into one padded cohort on the
    card: each row bitwise the row of the same request dispatched alone
    (column 0 of its own dispatch)."""
    _card()
    cache.clear()
    data = generate_gmm(N_ROWS, N_COLS, W, 0)
    cfgs = {f"r{k}": _cfg(seed=k, scheme=("approx" if k % 2 else "naive"),
                          num_collect=(6 if k % 2 else None), compute_mode="deduped")
            for k in range(4)}
    with server.serving(window_s=0.2, max_cohort=4) as srv:
        hs = [srv.submit(tenant=f"t{k}", label=label, config=c, dataset=data)
              for k, (label, c) in enumerate(cfgs.items())]
        packed = {h.result(timeout=300).label: h.result() for h in hs}
    assert {r.status for r in packed.values()} == {"ok"}
    with server.serving(window_s=0.001, max_cohort=4) as srv:
        for label, c in cfgs.items():
            alone = srv.submit(tenant="x", label=label, config=c, dataset=data).result(timeout=300)
            assert alone.status == "ok"
            assert _science(alone.summary) == _science(packed[label].summary), label


@pytest.mark.cuda
def test_warm_restart_builds_nothing(tmp_path):
    """A daemon process on cache_dir (set as ``cli serve --cache-dir``
    sets it) builds the library there and serves a forced-kernel request
    (B1 launches); a second process on the same cache_dir serves it again
    with no build and the directory's files unchanged."""
    _card()
    code = f"""
        import json, os
        from erasurehead_tpu_torch.data.synthetic import generate_gmm
        from erasurehead_tpu_torch.ops import kernels
        from erasurehead_tpu_torch.serve import server
        from erasurehead_tpu_torch.utils.config import RunConfig
        cfg = RunConfig(scheme="approx", n_workers={W}, n_stragglers=1, num_collect=6,
                        rounds={R}, n_rows={N_ROWS}, n_cols={N_COLS}, use_pallas="on",
                        compute_mode="faithful")
        kernels.set_build_dir({str(tmp_path)!r})
        with server.serving(cache_dir={str(tmp_path)!r}, window_s=0.01) as srv:
            res = srv.submit(tenant="t", label="fused", config=cfg).result(timeout=600)
        print(json.dumps(dict(status=res.status, builds=kernels.BUILDS,
                              launches=kernels.LAUNCHES["fused_glm_grad"],
                              files=sorted(os.listdir({str(tmp_path)!r})))))
    """
    cold = _python(code)
    warm = _python(code)
    assert cold["status"] == warm["status"] == "ok"
    assert cold["launches"] == warm["launches"] == R
    assert cold["builds"] == 1 and warm["builds"] == 0
    assert warm["files"] == cold["files"] and any(f.endswith(".so") for f in cold["files"])


@pytest.mark.cuda
def test_measured_footprint_only_ratchets_up():
    """A dispatch that ran alone records its peak device bytes above its
    start; the signature's charge is then at least that and never falls,
    whatever later dispatches measure."""
    _card()
    cache.clear()
    data = generate_gmm(N_ROWS, N_COLS, W, 0)
    cfg = _cfg(compute_mode="deduped")
    cohort = packer.plan_packs([queue.RunRequest(tenant="t", label="x", config=cfg,
                                                 dataset=data)])[0]
    with server.serving(window_s=0.01, max_cohort=2, dispatch_workers=1) as srv:
        assert srv.submit(tenant="t", label="a", config=cfg, dataset=data).result(
            timeout=300).status == "ok"
        first = srv.admission.measured_bytes(cohort.key_digest)
        assert first is not None and first > 0
        charges = [srv.admission.charge_for(cohort, width=2)]
        for k in range(3):
            assert srv.submit(tenant="t", label=f"b{k}", config=_cfg(seed=k + 1,
                              compute_mode="deduped"), dataset=data).result(
                timeout=300).status == "ok"
            charges.append(srv.admission.charge_for(cohort, width=2))
    assert charges == sorted(charges) and charges[0] >= first
    assert srv.admission.measured_bytes(cohort.key_digest) >= first
