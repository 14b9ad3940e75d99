"""The port's scheme registry and its eleven built-in schemes against the JAX
package.

Registry: the same names in the same order, the same capability flags,
config surfaces and artifact names per built-in, the same refusals. The
port's dispatch goes through the registry only (a grep pins it). The new
schemes' trajectories (partial MDS and FRC, sparsegraph, deadline, randreg
under the optimal decode) are held to the JAX trainer at its own trainer
tolerance (tests/test_torch_train.py), from the JAX init draw.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu import schemes as j_schemes
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.models.glm import LogisticModel as JLogistic
from erasurehead_tpu.train import artifacts as j_artifacts
from erasurehead_tpu.train import evaluate as j_evaluate
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch import schemes as t_schemes
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import collect as t_collect
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import artifacts as t_artifacts
from erasurehead_tpu_torch.train import evaluate as t_evaluate
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

PORT_DIR = os.path.dirname(os.path.abspath(t_schemes.__file__))
PKG_DIR = os.path.dirname(PORT_DIR)

#: the scheme-specific knobs each built-in needs to form a valid config
KNOBS = {
    "approx": dict(num_collect=3),
    "randreg": dict(num_collect=3),
    "sparsegraph": dict(num_collect=3),
    "expander": dict(num_collect=3),
    "deadline": dict(deadline=0.5),
    "partialcyccoded": dict(partitions_per_worker=4),
    "partialrepcoded": dict(partitions_per_worker=4),
}
BUILTINS = j_schemes.names()


def _cfg_kw(scheme, **kw):
    return dict(scheme=scheme, n_workers=6, n_stragglers=1, **KNOBS.get(scheme, {}), **kw)


# ---------------------------------------------------------------------------
# the registry against the JAX package's
# ---------------------------------------------------------------------------


def test_names_are_the_jax_names_in_order():
    assert t_schemes.names() == j_schemes.names()
    assert len(t_schemes.names()) == 11
    assert [s.value for s in t_config.Scheme] == [s.value for s in j_config.Scheme]


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_descriptor_matches_jax(name):
    t, j = t_schemes.get(name), j_schemes.get(name)
    assert t.capabilities() == j.capabilities()
    for field in (
        "name", "summary", "exact", "partial", "config_fields",
        "needs_num_collect", "needs_deadline", "artifact_stem",
        "artifact_straggler_suffix", "builtin",
    ):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.optimal_decode is None) == (j.optimal_decode is None)
    jcfg = j_config.RunConfig(**_cfg_kw(name))
    tcfg = t_config.RunConfig(**_cfg_kw(name))
    assert t_artifacts.run_prefix(tcfg) == j_artifacts.run_prefix(jcfg)
    assert tcfg.scheme.value == jcfg.scheme.value == name


@pytest.mark.parametrize("name", BUILTINS)
def test_registration_refuses_shadowing_a_builtin(name):
    """Registering a built-in's name raises, as in the JAX package (whose
    message also offers a ``replace=True`` override the port does not
    have), and leaves the built-in in place."""
    def shadow(lib, codes, collect):
        return lib.SchemeDescriptor(
            name=name,
            build_layout=lambda cfg: codes.uncoded_layout(cfg.n_workers),
            build_schedule=lambda t, lay, **kw: collect.collect_all(t),
        )

    from erasurehead_tpu.ops import codes as j_codes
    from erasurehead_tpu.parallel import collect as j_collect

    before = t_schemes.get(name)
    with pytest.raises(ValueError, match="already registered"):
        j_schemes.register(shadow(j_schemes, j_codes, j_collect))
    with pytest.raises(ValueError, match=f"scheme '{name}' is already registered \\(builtin\\)"):
        t_schemes.register(shadow(t_schemes, t_codes, t_collect))
    assert t_schemes.get(name) is before
    with pytest.raises(ValueError, match="builtin"):
        t_schemes.unregister(name)


def test_registration_refuses_bad_descriptors_and_shadowed_extensions(toy_scheme):
    with pytest.raises(ValueError, match="already registered \\(extension\\)"):
        t_schemes.register(_toy_descriptor(toy_scheme))
    with pytest.raises(TypeError):
        t_schemes.register("approx")
    with pytest.raises(ValueError, match="required"):
        t_schemes.SchemeDescriptor(name="x", build_layout=lambda cfg: None)


def _toy_descriptor(name):
    """A minimal third-party scheme: uncoded layout, collect everyone (naive
    in all but name)."""
    return t_schemes.SchemeDescriptor(
        name=name,
        summary="toy third-party scheme (tests)",
        build_layout=lambda cfg: t_codes.uncoded_layout(cfg.n_workers),
        build_schedule=lambda t, lay, **kw: t_collect.collect_all(t),
        optimal_decode=t_collect.optimal_decode_schedule,
        exact=True,
    )


@pytest.fixture
def toy_scheme():
    name = "toyuniform"
    t_schemes.register(_toy_descriptor(name))
    try:
        yield name
    finally:
        t_schemes.unregister(name)


def test_extension_scheme_registers_trains_and_unregisters(toy_scheme):
    cfg = t_config.RunConfig(**_cfg_kw(toy_scheme, rounds=3, n_rows=96, n_cols=8))
    assert isinstance(cfg.scheme, t_config.ExtensionScheme)
    assert cfg.scheme.value == toy_scheme
    assert toy_scheme in t_schemes.names()
    assert t_artifacts.run_prefix(cfg) == f"{toy_scheme}_acc_1"
    data = generate_gmm(96, 8, n_partitions=6, seed=0)
    toy = t_trainer.train(cfg, data, device="cpu")
    naive = t_trainer.train(
        t_config.RunConfig(**_cfg_kw("naive", rounds=3, n_rows=96, n_cols=8)),
        data, device="cpu",
    )
    assert torch.equal(toy.params_history, naive.params_history)
    parser = t_cli._flags_parser()
    assert toy_scheme in next(a.choices for a in parser._actions if a.dest == "scheme")


def test_unregistered_extension_is_refused():
    with pytest.raises(ValueError, match="registered schemes"):
        t_config.RunConfig(scheme="toyuniform")


def _fake_entry_points(monkeypatch, eps):
    import importlib.metadata as md

    class FakeEPS:
        def select(self, group=None):
            return eps if group == t_schemes.ENTRY_POINT_GROUP else []

    monkeypatch.setattr(md, "entry_points", lambda: FakeEPS())


def test_entry_point_scheme_shows_up(monkeypatch):
    class FactoryEP:
        name = "toyep"

        def load(self):
            return lambda: _toy_descriptor("toyep")

    _fake_entry_points(monkeypatch, [FactoryEP()])
    try:
        assert t_schemes.load_entry_points(force=True) == ["toyep"]
        assert t_schemes.names()[-1] == "toyep"
        assert t_config.RunConfig(scheme="toyep").scheme == "toyep"
    finally:
        t_schemes.unregister("toyep")


def test_broken_entry_point_warns_once_and_is_ignored(monkeypatch, capsys):
    class BadEP:
        name = "broken"

        def load(self):
            raise RuntimeError("boom")

    _fake_entry_points(monkeypatch, [BadEP()])
    assert t_schemes.load_entry_points(force=True) == []
    assert t_schemes.load_entry_points(force=True) == []
    err = capsys.readouterr().err
    assert err.count("'broken'") == 1 and "boom" in err
    assert "broken" not in t_schemes.names()


def test_no_scheme_dispatch_outside_the_schemes_package():
    """Every scheme dispatch of the port goes through the registry: no
    ``Scheme.`` member and no ``if ... scheme ==`` test outside
    erasurehead_tpu_torch/schemes/ and utils/config.py."""
    member = re.compile(r"\bScheme\.[A-Z_]+\b")
    branch = re.compile(r"^\s*(?:el)?if\b.*\bscheme\b\s*(?:==|!=|\bin\b)")
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for fname in files:
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, PKG_DIR)
            if not fname.endswith(".py") or rel.startswith("schemes") or rel == os.path.join("utils", "config.py"):
                continue
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    if member.search(line) or branch.search(line):
                        offenders.append(f"{rel}:{i}: {line.strip()}")
    assert not offenders, "scheme dispatch outside schemes/:\n" + "\n".join(offenders)
    for name in ("_LAYOUTS", "_RULES", "_STEMS"):
        for mod in (t_trainer, t_collect, t_artifacts):
            assert not hasattr(mod, name), (mod.__name__, name)


# ---------------------------------------------------------------------------
# the new schemes' trajectories against the JAX trainer
# ---------------------------------------------------------------------------

W, ROWS, COLS, ROUNDS = 8, 128, 32, 5

TRAJECTORIES = [
    ("partialcyccoded", dict(partitions_per_worker=3)),
    ("partialrepcoded", dict(partitions_per_worker=3)),
    ("sparsegraph", dict(num_collect=5)),
    ("deadline", dict(deadline=0.4)),
    ("randreg", dict(num_collect=5, decode="optimal")),
]


@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
@pytest.mark.parametrize("scheme,knobs", TRAJECTORIES, ids=[t[0] for t in TRAJECTORIES])
def test_trajectory_matches_jax_trainer(scheme, knobs, compute_mode):
    kw = dict(
        scheme=scheme, n_workers=W, n_stragglers=1, rounds=ROUNDS,
        n_rows=ROWS, n_cols=COLS, lr_schedule=1.0, update_rule="AGD",
        add_delay=True, seed=0, compute_mode=compute_mode, **knobs,
    )
    tcfg = t_config.RunConfig(**kw)
    P = t_cli.n_partitions(tcfg)
    data = generate_gmm(ROWS, COLS, n_partitions=P, seed=0)
    jdata = j_generate_gmm(ROWS, COLS, n_partitions=P, seed=0)
    init = np.asarray(JLogistic().init_params(jax.random.key(0), COLS), np.float32)
    want = j_trainer.train(j_config.RunConfig(**kw), jdata)
    got = t_trainer.train(tcfg, data, device="cpu", init_params=init)
    assert got.fused  # the round's gradient is kernel B1's (its plain version here)
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert got.n_train == want.n_train
    np.testing.assert_allclose(
        got.params_history.numpy(), np.asarray(want.params_history),
        rtol=2e-4, atol=1e-5,
    )
    n = got.n_train
    ev_t = t_evaluate.replay(
        t_trainer.build_model(tcfg), "logistic", got.params_history,
        data.X_train[:n], data.y_train[:n], data.X_test, data.y_test,
    )
    ev_j = j_evaluate.replay(
        j_trainer.build_model(want.config), "logistic", want.params_history,
        jdata.X_train[:n], jdata.y_train[:n], jdata.X_test, jdata.y_test,
    )
    for field in ("training_loss", "testing_loss", "auc"):
        np.testing.assert_allclose(
            getattr(ev_t, field), getattr(ev_j, field), rtol=2e-4, atol=1e-5,
            err_msg=field,
        )


def test_deadline_round_with_no_arrival_applies_a_zero_gradient():
    """A deadline no worker makes: every slot weight 0, the decoded gradient
    exactly 0, and no division by the collected count."""
    cfg = t_config.RunConfig(
        scheme="deadline", deadline=1e-9, n_workers=W, n_stragglers=1,
        rounds=3, n_rows=ROWS, n_cols=COLS, add_delay=True,
    )
    layout = t_trainer.build_layout(cfg)
    sched = t_trainer.build_schedule(cfg, t_trainer.default_arrivals(cfg), layout)
    assert not sched.collected.any() and not sched.message_weights.any()
    assert (sched.sim_time == cfg.deadline).all()
    data = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    from erasurehead_tpu_torch.data.sharding import partition_stack, worker_stack

    Xh, yh = worker_stack(layout, *partition_stack(data, W))
    g = t_step.make_fused_grad_fn("logistic")(
        torch.full((COLS,), 0.1), torch.from_numpy(Xh), torch.from_numpy(yh).float(),
        torch.zeros(W, 1),
    )
    assert torch.count_nonzero(g) == 0


# ---------------------------------------------------------------------------
# kernel B1 on the card at the new schemes' stacks
# ---------------------------------------------------------------------------


def _round_weights(scheme, **knobs):
    """Round 0's [W * S] slot weights of a flagship-width scheme (W = 30,
    s = 2), with its zero-weight pattern."""
    cfg = t_config.RunConfig(
        scheme=scheme, n_workers=30, n_stragglers=2, rounds=1, add_delay=True, **knobs
    )
    layout = t_trainer.build_layout(cfg)
    sched = t_trainer.build_schedule(cfg, t_trainer.default_arrivals(cfg), layout)
    w = t_step.expand_slot_weights(sched.message_weights, layout.coeffs, layout.slot_is_coded)
    return w.reshape(-1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "scheme,knobs,rows",
    [
        ("partialcyccoded", dict(partitions_per_worker=6), 1100),  # [180, 1100, 128]
        ("sparsegraph", dict(num_collect=15), 4400),  # [210, 4400, 128]
    ],
)
def test_cuda_kernel_matches_plain_version_at_scheme_stacks(scheme, knobs, rows, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.from_numpy(_round_weights(scheme, **knobs)).cuda()
    gen = torch.Generator().manual_seed(5)
    X = (torch.randn(w.numel(), rows, 128, generator=gen) * (10 / 128**0.5)).to(dtype).cuda()
    y = torch.randn(w.numel(), rows, generator=gen).sign().cuda()
    b = (torch.randn(128, generator=gen) * 0.1).cuda()
    for kind in t_kernels.GLM_KINDS:
        got = t_kernels.fused_glm_grad(b, X, y, w, kind)
        want = t_kernels.reference_glm_grad(b, X, y, w, kind)
        Xf = X.float()
        s = t_kernels._residual(kind, torch.einsum("mrf,f->mr", Xf, b), y)
        scale = torch.einsum("mrf,mr->f", Xf.abs(), (s * w[:, None]).abs())
        torch.cuda.synchronize()
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
