"""The port's comparison suite (experiments.baseline_suite and main, the
CLI's ``sweep`` subcommand, train/plots.py) against the JAX package's.

baseline_suite runs on both packages at scale 0.05 and 5 rounds, the port
started from JAX's init draws (``init_params``, label -> params): config
names, substitution labels, lr presets, notes, the suite tags, simulated
clocks and decode errors must be equal; losses within the port's GLM
trainer tolerance (rtol 2e-4, atol 1e-5; tests/test_torch_train.py), and
config 4's shared target within the same tolerance, its time_to_target
values equal. main and ``cli sweep`` parse JAX's flags, refuse as JAX
refuses (its ``p.error`` messages) and ``--events`` (no event emission
yet), write the summaries, and resume from their journal.
"""

import json
import os

import jax
import numpy as np
import pytest

from erasurehead_tpu.train import experiments as j_exp
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.obs.metrics import REGISTRY
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import journal as t_journal
from erasurehead_tpu_torch.train import plots as t_plots
from erasurehead_tpu_torch.utils.config import ModelKind, RunConfig

SCALE, ROUNDS = 0.05, 5


def _jax_inits(suite) -> dict:
    out = {}
    for rows in suite.values():
        for s in rows:
            model = j_trainer.build_model(s.config)
            out[s.label] = jax.tree.map(
                np.asarray, j_trainer._init_params_f32(s.config, model, s.config.n_cols)
            )
    return out


@pytest.fixture(scope="module")
def suites():
    want = j_exp.baseline_suite(scale=SCALE, rounds=ROUNDS, batch="off")
    got = t_exp.baseline_suite(scale=SCALE, rounds=ROUNDS, batch="off", device="cpu",
                               init_params=_jax_inits(want))
    return got, want


def _pairs(suites):
    got, want = suites
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name])
        yield from ((name, g, w) for g, w in zip(got[name], want[name]))


def test_suite_names_and_substitutions_are_jax(suites):
    got, want = suites
    assert list(got) == list(want) == [
        "1_naive_covtype[synthetic(covtype-shaped)]",
        "2_egc_amazon[synthetic(amazon-shaped)]",
        "3_agc_kc_house[synthetic(kc_house_data-shaped)]",
        "4_partialrep_vs_avoidstragg_sweep",
        "5_mlp_agc[synthetic(covtype-shaped)]",
    ]
    for name, g, w in _pairs(suites):
        assert (g.label, g.suite, g.note) == (w.label, w.suite, w.note), name
    assert got["5_mlp_agc[synthetic(covtype-shaped)]"][0].note == t_exp.STANDIN_NOTE


CONFIG_FIELDS = ("scheme", "model", "n_workers", "n_stragglers", "num_collect", "rounds",
                 "update_rule", "dataset", "n_rows", "n_cols", "partitions_per_worker",
                 "add_delay", "delay_mean", "seed", "compute_mode")


def test_suite_configs_and_lr_presets_are_jax(suites):
    for name, g, w in _pairs(suites):
        for f in CONFIG_FIELDS:
            a, b = getattr(g.config, f), getattr(w.config, f)
            assert getattr(a, "value", a) == getattr(b, "value", b), (name, f)
        assert g.config.lr_schedule == w.config.lr_schedule, name
        np.testing.assert_array_equal(g.config.resolve_lr_schedule(),
                                      w.config.resolve_lr_schedule())
        assert g.config.effective_alpha == w.config.effective_alpha


def test_suite_rows_match_jax(suites):
    for name, g, w in _pairs(suites):
        gr, wr = g.row(), w.row()
        for key in ("label", "scheme", "n_stragglers", "num_collect", "status",
                    "sim_total_time", "sim_steps_per_sec", "decode_error_mean", "suite"):
            assert gr.get(key) == wr.get(key), (name, key)
        assert g.timeset.tobytes() == w.timeset.tobytes(), name
        np.testing.assert_allclose(g.training_loss, w.training_loss, rtol=2e-4, atol=1e-5,
                                   err_msg=name)
        for key in ("final_train_loss", "final_test_loss", "final_auc"):
            if wr[key] is None:  # the linear model has no AUC
                assert gr[key] is None, (name, key)
            else:
                np.testing.assert_allclose(gr[key], wr[key], rtol=2e-4, atol=1e-5, err_msg=key)
        assert g.time_to_target == w.time_to_target, name


def test_config4_shared_target_is_jax(suites):
    got, want = suites
    name = "4_partialrep_vs_avoidstragg_sweep"

    def target(rows):
        return 1.05 * min(s.final_train_loss for s in rows if s.status == "ok")

    np.testing.assert_allclose(target(got[name]), target(want[name]), rtol=2e-4)
    for g in got[name]:
        want_ttt = t_exp.time_to_target_loss(g.training_loss, g.timeset, target(got[name]))
        assert g.time_to_target == want_ttt
    assert [s.config.model for s in got["3_agc_kc_house[synthetic(kc_house_data-shaped)]"]] \
        == [ModelKind.LINEAR]


def test_for_dataset_is_jax():
    from erasurehead_tpu.utils.config import RunConfig as JRunConfig

    for name in ("covtype", "amazon", "kc_house_data", "dna", "artificial"):
        g, w = RunConfig.for_dataset(name, rounds=3), JRunConfig.for_dataset(name, rounds=3)
        assert (g.n_rows, g.n_cols, g.model.value, g.dataset) == \
            (w.n_rows, w.n_cols, w.model.value, w.dataset)
        np.testing.assert_array_equal(g.resolve_lr_schedule(), w.resolve_lr_schedule())


# ---------------------------------------------------------------------------
# main and ``cli sweep``


def _error_tail(capsys):
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [["--resume-sweep"], ["--batch-trajectories", "maybe"],
                                  ["--rounds", "x"]])
def test_main_refuses_as_jax(argv, capsys):
    with pytest.raises(SystemExit) as got:
        t_exp.main(argv + ["--device", "cpu"])
    got_msg = _error_tail(capsys)
    with pytest.raises(SystemExit) as want:
        j_exp.main(argv)
    assert got.value.code == want.value.code == 2
    assert got_msg == _error_tail(capsys)


def test_main_refuses_events(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        t_cli.main(["sweep", "--events", str(tmp_path / "e.jsonl"), "--device", "cpu"])
    assert ei.value.code == 2
    assert "A13" in _error_tail(capsys)


def test_main_flags_are_jax(monkeypatch):
    """The same flags with the same defaults, plus the port's --device."""
    import argparse

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen[self.prog] = vars(real(self, args, namespace))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    for main in (t_exp.main, j_exp.main):
        with pytest.raises(SystemExit):
            main([])
    got = seen["erasurehead-tpu-torch-experiments"]
    want = seen["erasurehead-tpu-experiments"]
    assert got.pop("device") == "cuda"
    assert got == want


def test_cli_sweep_writes_rows_and_resumes(tmp_path, capsys):
    jdir, out, again = str(tmp_path / "j"), str(tmp_path / "a.json"), str(tmp_path / "b.json")
    base = ["sweep", "--scale", "0.02", "--rounds", "3", "--device", "cpu",
            "--sweep-journal", jdir]
    assert t_cli.main(base + ["--out", out]) == 0
    text = capsys.readouterr().out
    assert "== 1_naive_covtype[synthetic(covtype-shaped)] ==" in text
    assert f"sweep journal -> {os.path.join(jdir, 'sweep_journal.jsonl')}" in text
    rows = json.load(open(out))
    assert len(rows) == 10 and {r["status"] for r in rows} == {"ok"}
    journal = os.path.join(jdir, t_journal.JOURNAL_NAME)
    assert t_events.validate_file(journal) == []
    before = REGISTRY.counter("sweep_journal.resumed").value
    assert t_exp.main(base[1:] + ["--resume-sweep", "--out", again]) == 0
    assert REGISTRY.counter("sweep_journal.resumed").value == before + 10
    assert [t_journal.science_row(r) for r in json.load(open(again))] == \
        [t_journal.science_row(r) for r in rows]


def test_figures_written_when_matplotlib_is_present(suites, tmp_path):
    got, _ = suites
    path = str(tmp_path / "fig.png")
    name = "4_partialrep_vs_avoidstragg_sweep"
    fig = t_plots.save_comparison_figure(got[name], path, title=name)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert fig is None
        return
    assert fig == path and os.path.getsize(path) > 0
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# config 5's card path: autodiff through a PaddedRows gather


def _padded(seed=0, lead=(3,), n=5, nnz=4, F=10):
    import torch

    from erasurehead_tpu_torch.ops import features as t_features

    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, F, lead + (n, nnz), generator=g, dtype=torch.int32)
    vals = torch.rand(lead + (n, nnz), generator=g)
    return t_features.PaddedRows(idx, vals, F), idx, vals


@pytest.mark.parametrize("hidden", [None, 6])
def test_padded_gather_gradient_is_index_select(hidden):
    """The gather's gradient is a sorted segment sum (no atomics on the
    card): on the CPU it equals index_select's backward bitwise, per slot
    under vmap and per trajectory under a cohort's vmap."""
    import torch

    from erasurehead_tpu_torch.ops import features as t_features

    X, idx, vals = _padded()
    shape = (10,) if hidden is None else (10, hidden)
    v = torch.randn(shape, generator=torch.Generator().manual_seed(1))

    def plain(v, idx, vals):
        g = v.index_select(0, idx.reshape(-1)).reshape(tuple(idx.shape) + tuple(v.shape[1:]))
        m = (vals * g).sum(-1) if v.ndim == 1 else (vals.unsqueeze(-1) * g).sum(-2)
        return torch.tanh(m).sum()

    def ported(v, X):
        return torch.tanh(t_features.matvec(X, v)).sum()

    want = torch.func.grad(plain)(v, idx, vals)
    assert torch.equal(torch.func.grad(ported)(v, X), want)
    per_slot = torch.func.grad(
        lambda v: torch.func.vmap(ported, in_dims=(None, 0))(v, X).sum())(v)
    torch.testing.assert_close(per_slot, want, rtol=1e-6, atol=1e-6)
    vB = torch.stack([v, 2 * v])
    cohort = torch.func.vmap(torch.func.grad(
        lambda v: torch.func.vmap(ported, in_dims=(None, 0))(v, X).sum()))(vB)
    for b in range(2):
        torch.testing.assert_close(cohort[b], torch.func.grad(plain)(vB[b], idx, vals),
                                   rtol=1e-6, atol=1e-6)

