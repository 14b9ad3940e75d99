"""The port's lint (erasurehead_tpu_torch/analysis/) against the JAX
package's, on the CPU.

What is held, and how:
  - trace-purity and signature-completeness, restated for the port's
    idioms (bodies under torch.func.vmap / grad / grad_and_value, the
    methods of a torch.autograd.Function, the closures parallel/step.py's
    factories return): fixtures written here from strings flag exactly
    their seeded violations and pass their clean counterparts;
  - registry-dispatch and event-schema on the JAX package's own fixtures
    (tests/fixtures/lint/, read as they are): the port's findings are the
    JAX linter's, message for message, where the message names no package;
  - the shipped port tree lints at zero unsuppressed findings, the report
    is deterministic, suppressions apply, count and need a reason, and the
    cross-file sources are parsed, not imported, and key on the port's real
    config and schema;
  - ``cli lint`` and ``python -m erasurehead_tpu_torch.analysis``: exit 0
    clean, 1 with findings, 2 on a usage error.

No wall-time assertion: the JAX package's 5 s budget test fails under a
loaded machine.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

from erasurehead_tpu.analysis import runner as j_runner
from erasurehead_tpu_torch import analysis
from erasurehead_tpu_torch.analysis import core, runner, signature

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
FIXTURES = os.path.join(TESTS_DIR, "fixtures", "lint")
PKG_ROOT = os.path.join(REPO, "erasurehead_tpu_torch")

PURITY_BAD = '''
import functools
import time

import numpy as np
import torch
from torch.func import grad, vmap
from erasurehead_tpu_torch.obs import events as obs_events
from erasurehead_tpu_torch.obs.metrics import REGISTRY


def _helper(x):
    # reachable from the vmapped body below -> still flagged
    obs_events.emit("warning", kind="k", message="inside vmap")
    return x + np.random.normal()


def per_slot(p, x):
    t = time.time()
    print("slot", x)
    REGISTRY.counter("bad.counter").inc()
    return _helper(p * x) + t


def run(p, xs):
    return torch.func.vmap(per_slot, in_dims=(None, 0))(p, xs)


def loss(p, x, scale):
    torch.manual_seed(0)
    g = torch.Generator()
    return (p * x).sum() * scale


def grads(p, x):
    return grad(functools.partial(loss, scale=2.0))(p, x)


def batched(p, xs):
    def body(x):
        with open("/tmp/leak.txt", "w") as f:
            f.write("host I/O")
        return x
    return vmap(body)(xs)


class Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        obs_events.emit("warning", kind="k", message="in forward")
        return x

    @staticmethod
    def backward(ctx, g):
        REGISTRY.histogram("h").observe(1.0)
        return g
'''

PURITY_OK = '''
import time

import numpy as np
import torch
from torch.func import grad, vmap
from erasurehead_tpu_torch.obs import events as obs_events
from erasurehead_tpu_torch.obs.metrics import REGISTRY


def per_slot(p, x, noise):
    return p * x + noise


def run(p, xs, gen):
    t0 = time.time()  # on the host loop, outside the body
    noise = torch.randn(xs.shape, generator=gen)
    out = torch.func.vmap(per_slot, in_dims=(None, 0, 0))(p, xs, noise)
    REGISTRY.counter("rounds").inc()
    obs_events.emit("warning", kind="k", message=f"{time.time() - t0}")
    print("done")
    return out


def grads(p, x):
    return grad(lambda q: (q * x).sum())(p)


class Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g


def host_only(cfg):
    np.random.seed(cfg.seed)  # not in a traced body
    return vmap(lambda x: x * 2)
'''

STEP_BAD = '''
import torch


def make_faithful_grad_fn(model, cfg):
    def grad_fn(params, X, y, w):
        k = cfg.num_collect
        return model.grad(params, X, y) * w * k

    return grad_fn


def cohort_matmul_grad_fn(model, cfg):
    def body(params, X):
        return params * cfg.delay_mean

    return _dq(body), "cohort_matmul"


def _dq(fn):
    return fn


def helper_not_shared(cfg):
    return cfg.deadline  # not returned by a factory: not flagged
'''

STEP_OK = '''
import torch


def make_faithful_grad_fn(model, cfg):
    layered = cfg.layer_coding  # read by the factory, once, on the host
    def grad_fn(params, X, y, w):
        if cfg.compute_mode == "faithful" and cfg.block_decode:
            return model.grad(params, X, y) * w / cfg.rounds
        return params

    return grad_fn


def run(cfg):
    return cfg.num_collect  # a host read outside any shared closure
'''

VMAP_SIG_BAD = '''
import torch


def run(cfg, xs):
    def body(x):
        return x * cfg.deadline

    return torch.vmap(body)(xs)
'''

SUPPRESSED = '''
# lint: allow-file(registry-dispatch): fixture exercises file-wide allows

import torch
from erasurehead_tpu_torch.obs import events as obs_events


def body(x):
    # lint: allow(trace-purity): fixture proves line suppression works
    obs_events.emit("warning", kind="k", message="suppressed emit")
    print("also suppressed")  # lint: allow(trace-purity)
    return x


def run(cfg, xs):
    if cfg.scheme == "naive":  # suppressed by the file-wide allow above
        return xs
    return torch.func.vmap(body)(xs)
'''


def _write(tmp_path, rel, text) -> str:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return str(p)


def _unsup(report, checker=None):
    return [f for f in report.findings if not f.suppressed
            and (checker is None or f.checker == checker)]


def _fx(name):
    return os.path.join(FIXTURES, name)


# ---- trace-purity on the port's idioms -------------------------------------


def test_purity_flags_every_seeded_effect(tmp_path):
    path = _write(tmp_path, "purity_bad.py", PURITY_BAD)
    findings = _unsup(runner.lint_paths([path]), "trace-purity")
    msgs = "\n".join(f.message for f in findings)
    for marker in ("time.time", "print", "np.random.normal", ".inc", "open",
                   "torch.manual_seed", "torch.Generator", ".observe"):
        assert marker in msgs, f"{marker} not flagged:\n{msgs}"
    assert msgs.count("emit") == 2  # via the reachable helper, and in forward
    whys = {re.search(r"traced via (\S+)", f.message).group(1) for f in findings}
    assert whys == {"torch.func.vmap", "grad", "vmap", "autograd.Function"}
    assert len(findings) == 10


def test_purity_clean_counterpart(tmp_path):
    path = _write(tmp_path, "purity_ok.py", PURITY_OK)
    assert _unsup(runner.lint_paths([path])) == []


# ---- signature-completeness on the port's shared closures ------------------


@pytest.mark.parametrize("name,text,want", [
    ("parallel/step.py", STEP_BAD, {"num_collect", "delay_mean"}),
    ("train/vmapped.py", VMAP_SIG_BAD, {"deadline"}),
    ("elsewhere/step_like.py", STEP_BAD, set()),  # only parallel/step.py's factories
])
def test_signature_flags_fields_outside_the_signature(tmp_path, name, text, want):
    path = _write(tmp_path, name, text)
    findings = _unsup(runner.lint_paths([path], checkers=["signature-completeness"]))
    assert {re.search(r"cfg\.(\w+)", f.message).group(1) for f in findings} == want


def test_signature_clean_counterpart_and_its_mutation(tmp_path):
    """Signature fields and shape-captured fields pass; the same closure
    fails once ``block_decode`` leaves the port's real signature."""
    path = _write(tmp_path, "parallel/step.py", STEP_OK)
    assert _unsup(runner.lint_paths([path])) == []
    with open(os.path.join(PKG_ROOT, "utils", "config.py")) as f:
        src = f.read()
    assert '"block_decode": self.block_decode,' in src
    ctx = runner.LintContext.load(
        config_source=src.replace('"block_decode": self.block_decode,', ""))
    findings = _unsup(runner.lint_paths([path], checkers=["signature-completeness"],
                                        context=ctx))
    assert [re.search(r"cfg\.(\w+)", f.message).group(1) for f in findings] == ["block_decode"]


def test_traced_graph_resolves_the_port_tree():
    """The roots resolve in the port's own modules: step.py's vmapped and
    grad bodies and its factories' closures, features.py's autograd
    Functions."""
    def names(mapping):
        return {getattr(fn, "name", "<lambda>") for fn, _ in mapping.values()}

    step = os.path.join(PKG_ROOT, "parallel", "step.py")
    with open(step) as f:
        mod = core.SourceModule(step, f.read())
    assert {"total", "per_slot_grads", "<lambda>"} <= names(mod.traced_functions())
    assert {"grad", "per_slot_grads"} <= names(signature.shared_closures(mod))
    feats = os.path.join(PKG_ROOT, "ops", "features.py")
    with open(feats) as f:
        mod = core.SourceModule(feats, f.read())
    whys = {why for _, why in mod.traced_functions().values()}
    assert any("_ScatterRows.forward" in w for w in whys)
    assert any("_GatherRows.backward" in w for w in whys)


# ---- registry-dispatch and event-schema on the JAX fixtures ----------------


def _rendered(report, checker):
    return [(os.path.basename(f.path), f.line, f.col, f.message)
            for f in report.findings if f.checker == checker and not f.suppressed]


@pytest.mark.parametrize("fixture", [
    "dispatch_bad.py", "dispatch_ok.py", "dispatch_grep_miss.py",
])
def test_dispatch_findings_equal_jax(fixture):
    ours = _rendered(runner.lint_paths([_fx(fixture)]), "registry-dispatch")
    theirs = _rendered(j_runner.lint_paths([_fx(fixture)]), "registry-dispatch")
    strip = [(b, ln, c, m.replace("erasurehead_tpu_torch/schemes/", "<schemes>"))
             for b, ln, c, m in ours]
    assert strip == [(b, ln, c, m.replace("erasurehead_tpu/schemes/", "<schemes>"))
                     for b, ln, c, m in theirs]
    assert bool(ours) == fixture.endswith(("_bad.py", "_grep_miss.py"))


SCHEMA_FIXTURES = sorted(f for f in os.listdir(FIXTURES) if f.startswith("schema_"))


@pytest.mark.parametrize("fixture", SCHEMA_FIXTURES + ["cli_wrapper_bad"])
def test_schema_findings_equal_jax(fixture):
    """The port's SCHEMA, tune vocabulary and validator rules find on the
    JAX package's schema fixtures exactly what the JAX linter finds."""
    ours = _rendered(runner.lint_paths([_fx(fixture)]), "event-schema")
    theirs = _rendered(j_runner.lint_paths([_fx(fixture)]), "event-schema")
    theirs = [(b, ln, c, m.replace("in the CLI wrapper",
                                   "in a module that fronts the validator"))
              for b, ln, c, m in theirs]
    assert ours == theirs
    assert bool(ours) == (fixture != "schema_ok.py")


def test_schema_mutation_detected():
    """Deleting ``compile`` from the port's SCHEMA makes its trainer's emit
    sites fail lint."""
    ctx = runner.LintContext.load()
    assert "compile" in ctx.schema
    ctx.schema = {k: v for k, v in ctx.schema.items() if k != "compile"}
    trainer = os.path.join(PKG_ROOT, "train", "trainer.py")
    report = runner.lint_paths([trainer], checkers=["event-schema"], context=ctx)
    assert any("'compile'" in f.message for f in _unsup(report))


def test_parsed_sources_match_the_runtime():
    """What lint checks against is what runs: the AST-parsed SCHEMA, tune
    vocabulary, RunConfig fields and signature keys equal the port's
    runtime ones."""
    import dataclasses

    from erasurehead_tpu_torch import tune
    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.utils.config import RunConfig

    ctx = runner.LintContext.load()
    assert ctx.schema == {k: tuple(v) for k, v in events_lib.SCHEMA.items()}
    assert ctx.tune_races == tuple(events_lib.TUNE_RACES)
    assert ctx.tune_sources == tuple(events_lib.TUNE_SOURCES)
    assert set(tune.TUNE_CHOICES) == set(events_lib.TUNE_RACES)
    assert ctx.config_fields == frozenset(f.name for f in dataclasses.fields(RunConfig))
    assert ctx.signature_keys == frozenset(RunConfig().static_signature_fields())


# ---- the shipped tree, determinism, suppressions ---------------------------


def test_shipped_port_tree_has_zero_unsuppressed_findings():
    report = runner.lint_paths([PKG_ROOT])
    assert _unsup(report) == [], report.render(strict=True)
    assert report.n_files > 90


def test_report_determinism(tmp_path):
    _write(tmp_path, "purity_bad.py", PURITY_BAD)
    _write(tmp_path, "parallel/step.py", STEP_BAD)
    paths = [PKG_ROOT, FIXTURES, str(tmp_path)]
    a = runner.lint_paths(paths).render(strict=True)
    b = runner.lint_paths(paths).render(strict=True)
    assert a.encode() == b.encode() and "finding(s)" in a


def test_suppressions_apply_count_and_need_a_reason(tmp_path):
    path = _write(tmp_path, "suppressed.py", SUPPRESSED)
    report = runner.lint_paths([path])
    assert _unsup(report, "trace-purity") == [] and _unsup(report, "registry-dispatch") == []
    assert report.suppression_counts() == {"registry-dispatch": 1, "trace-purity": 2}
    problems = _unsup(report, "suppression")
    assert len(problems) == 1 and "no reason" in problems[0].message
    text = report.render(strict=True)
    assert "suppressions by checker:" in text and "trace-purity: 2" in text


def test_checkers_and_unknown_checker():
    """The port registers the JAX package's five checkers, and the fifth,
    donation-safety, runs over the JAX fixtures' directory (their donating
    calls are jax.jit's, which the port's checker does not read, so they
    give the port nothing: the restated fixtures are in
    tests/test_torch_graphs.py)."""
    assert set(analysis.CHECKERS) == set(j_runner.CHECKERS) == {
        "trace-purity", "signature-completeness", "registry-dispatch", "event-schema",
        "donation-safety"}
    report = runner.lint_paths([FIXTURES], checkers=["donation-safety"])
    assert [f for f in report.unsuppressed if f.checker == "donation-safety"] == []
    with pytest.raises(ValueError, match="unknown checker"):
        runner.lint_paths([FIXTURES], checkers=["no-such-checker"])


# ---- the CLI ---------------------------------------------------------------


def test_module_entry_exit_codes(tmp_path):
    bad = _write(tmp_path, "purity_bad.py", PURITY_BAD)
    clean = subprocess.run([sys.executable, "-m", "erasurehead_tpu_torch.analysis", PKG_ROOT],
                           capture_output=True, text=True, cwd=REPO, timeout=120)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stdout
    dirty = subprocess.run([sys.executable, "-m", "erasurehead_tpu_torch.analysis", bad],
                           capture_output=True, text=True, cwd=REPO, timeout=120)
    assert dirty.returncode == 1 and "trace-purity" in dirty.stdout


@pytest.mark.parametrize("argv,rc", [
    (["--checker"], 2),
    (["--bogus"], 2),
    (["--checker", "donation-safety"], 0),
    (["--help"], 0),
])
def test_cli_lint_usage(argv, rc, capsys):
    from erasurehead_tpu_torch import cli

    assert cli.main(["lint", *argv]) == rc


def test_cli_lint_default_path_and_fixtures(tmp_path, capsys):
    """``cli lint`` with no path lints the installed port package (exit 0);
    each ported checker's seeded fixture fails it."""
    from erasurehead_tpu_torch import cli

    assert cli.main(["lint"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out
    bad = [_write(tmp_path, "a/purity_bad.py", PURITY_BAD),
           _write(tmp_path, "b/parallel/step.py", STEP_BAD),
           _fx("dispatch_bad.py"), _fx("schema_bad.py")]
    for path in bad:
        assert cli.main(["lint", path]) == 1, path
    assert cli.main(["lint", _write(tmp_path, "c/purity_ok.py", PURITY_OK)]) == 0
