"""Checkpoint/resume of the port's trainer (train/checkpoint.py).

Against the JAX package (its orbax form, erasurehead_tpu/train/
checkpoint.py, trainer.train), on the same config and data from JAX's
parameter draw: a run saving every 2 rounds, then resumed, has JAX's
resumed start round and clocks (bytewise) and JAX's resumed history (the
layer-coding tests' tolerance, rtol 5e-4, atol 5e-5; attention's JAX side
is monolithic, as the JAX trainer refuses layer-coded autodiff families),
and both packages' artifacts agree on the resumed window. A resume with no
checkpoint prints JAX's own stderr line. The CLI flag refusals carry the
JAX CLI's messages and exit code 2.

Inside the port: a checkpointed run is bitwise the uninterrupted one, a
resumed run is bitwise its tail (the update reads the absolute round index,
and the restored state keeps its dtypes), its artifacts cover
[start_round, rounds), and a torn or unmarked checkpoint falls back to the
next-older one with a warning on stderr.
"""

import argparse
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.train import artifacts as j_artifacts
from erasurehead_tpu.train import evaluate as j_evaluate
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models.glm import params_from_numpy
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.train import artifacts, evaluate
from erasurehead_tpu_torch.train import checkpoint as ckpt
from erasurehead_tpu_torch.train import trainer
from erasurehead_tpu_torch.train.optimizer import OptState
from erasurehead_tpu_torch.utils.config import RunConfig

W, ROUNDS, N_ROWS, N_COLS = 4, 5, 64, 16
RULES = {"GD": 0.5, "AGD": 1.0, "ADAM": 0.05}
MODELS = ("logistic", "attention")
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)


def _kw(model="logistic", rule="AGD", **kw):
    base = dict(
        scheme="approx", model=model, n_workers=W, n_stragglers=1, num_collect=3,
        rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS, update_rule=rule,
        lr_schedule=RULES[rule], add_delay=True, seed=2,
        layer_coding="on" if model == "attention" else "auto",
    )
    base.update(kw)
    return base


def _cfg(model="logistic", rule="AGD", **kw):
    return RunConfig(**_kw(model, rule, **kw))


def _jcfg(model="logistic", rule="AGD"):
    # the JAX trainer runs attention monolithic only (see the docstring)
    return JRunConfig(**_kw(model, rule, layer_coding="off" if model == "attention" else "auto"))


@pytest.fixture(scope="module")
def data():
    return generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


def _bits(tree):
    return [leaf.cpu().numpy().tobytes() for leaf in blocks.tree_leaves(tree)]


def _state_bits(state):
    mom = state.momentum
    parts = [state.params] + (list(mom) if isinstance(mom, tuple) else [mom])
    return [b for p in parts for b in _bits(p)]


def _tail(tree, start):
    return blocks.tree_map(lambda h: h[start:], tree)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Per (model, rule): the uninterrupted run, and the same run saving
    every 2 rounds into a directory of its own."""
    out = {}
    for model in MODELS:
        for rule in RULES:
            cfg = _cfg(model, rule)
            d = str(tmp_path_factory.mktemp(f"{model}_{rule}"))
            full = trainer.train(cfg, data, device="cpu")
            saved = trainer.train(cfg, data, device="cpu", checkpoint_dir=d, checkpoint_every=2)
            out[model, rule] = (cfg, full, saved, d)
    return out


@pytest.fixture(scope="module")
def jax_runs(data, jdata, tmp_path_factory):
    """Per (model, rule): the JAX package's run saving every 2 rounds, then
    resumed, and the port's same two runs from JAX's parameter draw.
    Returns (JAX's resumed result, the port's, their configs)."""
    out = {}
    for model in MODELS:
        for rule in RULES:
            jcfg, cfg = _jcfg(model, rule), _cfg(model, rule)
            draw = j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), N_COLS)
            init = params_from_numpy(jax.tree.map(np.asarray, draw))
            root = tmp_path_factory.mktemp(f"vs_jax_{model}_{rule}")
            jd, td = str(root / "jax"), str(root / "port")
            j_trainer.train(jcfg, jdata, checkpoint_dir=jd, checkpoint_every=2)
            jres = j_trainer.train(jcfg, jdata, checkpoint_dir=jd, resume=True)
            trainer.train(cfg, data, device="cpu", init_params=init, checkpoint_dir=td,
                          checkpoint_every=2)
            tres = trainer.train(cfg, data, device="cpu", init_params=init, checkpoint_dir=td,
                                 resume=True)
            out[model, rule] = (jres, tres, jcfg, cfg)
    return out


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("model", MODELS)
def test_resumed_run_matches_jax(jax_runs, model, rule):
    jres, tres, _, _ = jax_runs[model, rule]
    assert tres.start_round == jres.start_round == 4
    got = [leaf.numpy() for leaf in blocks.tree_leaves(tres.params_history)]
    want = [np.asarray(leaf) for leaf in jax.tree.leaves(jres.params_history)]
    assert [a.shape for a in got] == [b.shape for b in want]
    assert got[0].shape[0] == ROUNDS - 4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TRAJ_TOL)
    # the clocks cover the whole run in both packages
    for field in ("timeset", "worker_times", "collected"):
        assert getattr(tres, field).tobytes() == np.asarray(getattr(jres, field)).tobytes(), field
    assert tres.sim_total_time == jres.sim_total_time


@pytest.mark.parametrize("model", MODELS)
def test_resumed_artifacts_match_jax(jax_runs, data, jdata, model, tmp_path):
    jres, tres, jcfg, cfg = jax_runs[model, "AGD"]
    n = tres.n_train
    assert n == jres.n_train
    jev = j_evaluate.replay(j_trainer.build_model(jcfg), jcfg.model, jres.params_history,
                            jdata.X_train[:n], jdata.y_train[:n], jdata.X_test, jdata.y_test)
    tev = evaluate.replay(trainer.build_model(cfg), cfg.model, tres.params_history,
                          data.X_train[:n], data.y_train[:n], data.X_test, data.y_test)
    jp = j_artifacts.write_run_artifacts(jres, jev, str(tmp_path / "jax"))
    tp = artifacts.write_run_artifacts(tres, tev, str(tmp_path / "port"))
    for name in ("timeset", "worker_timeset"):
        with open(jp[name], "rb") as a, open(tp[name], "rb") as b:
            assert a.read() == b.read(), name
    for name in ("training_loss", "testing_loss", "auc"):
        got, want = np.loadtxt(tp[name], ndmin=1), np.loadtxt(jp[name], ndmin=1)
        assert got.shape == want.shape == (ROUNDS - 4,), name
        np.testing.assert_allclose(got, want, **TRAJ_TOL, err_msg=name)
    with open(jp["manifest"]) as f, open(tp["manifest"]) as g:
        jm, tm = json.load(f), json.load(g)
    for key in ("start_round", "window_sim_total_time", "sim_total_time", "n_train", "arrival"):
        assert tm[key] == jm[key], key


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("model", MODELS)
def test_checkpointed_run_is_the_single_run(runs, model, rule):
    cfg, full, saved, d = runs[model, rule]
    assert _bits(saved.params_history) == _bits(full.params_history)
    assert _state_bits(saved.final_state) == _state_bits(full.final_state)
    # saves after rounds 2 and 4, never after the last
    assert sorted(os.listdir(d)) == ["round_2", "round_4"]
    assert all(ckpt.is_valid(os.path.join(d, n)) for n in os.listdir(d))
    assert saved.start_round == 0


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("model", MODELS)
def test_resumed_run_is_the_tail(runs, data, model, rule, tmp_path):
    cfg, full, _, d = runs[model, rule]
    resumed = trainer.train(cfg, data, device="cpu", checkpoint_dir=d, resume=True)
    assert resumed.start_round == 4
    assert _bits(resumed.params_history) == _bits(_tail(full.params_history, 4))
    assert _state_bits(resumed.final_state) == _state_bits(full.final_state)
    # the control plane still covers the whole run
    assert resumed.timeset.tobytes() == full.timeset.tobytes()
    # a resume that itself checkpoints, from round 2 of a copy
    state, nxt = ckpt.restore(os.path.join(d, "round_2"), full.final_state)
    ckpt.save(str(tmp_path / "round_2"), state, nxt)
    again = trainer.train(cfg, data, device="cpu", checkpoint_dir=str(tmp_path),
                          checkpoint_every=2, resume=True)
    assert again.start_round == 2
    assert _bits(again.params_history) == _bits(_tail(full.params_history, 2))
    assert sorted(os.listdir(tmp_path)) == ["round_2", "round_4"]


@pytest.mark.parametrize("model", MODELS)
def test_artifacts_cover_the_resumed_window(runs, data, model, tmp_path):
    cfg, full, _, d = runs[model, "AGD"]
    resumed = trainer.train(cfg, data, device="cpu", checkpoint_dir=d, resume=True)
    n = full.n_train

    def write(res, out):
        ev = evaluate.replay(trainer.build_model(cfg), cfg.model, res.params_history,
                             data.X_train[:n], data.y_train[:n], data.X_test, data.y_test)
        return artifacts.write_run_artifacts(res, ev, str(out))

    a, b = write(full, tmp_path / "full"), write(resumed, tmp_path / "resumed")
    for name in ("training_loss", "testing_loss", "auc", "timeset"):
        x, y = np.loadtxt(a[name], ndmin=1), np.loadtxt(b[name], ndmin=1)
        assert y.shape == (ROUNDS - 4,) and y.tobytes() == x[4:].tobytes(), name
    wt_full, wt = np.loadtxt(a["worker_timeset"], ndmin=2), np.loadtxt(b["worker_timeset"], ndmin=2)
    assert wt.tobytes() == wt_full[4:].tobytes()
    with open(b["manifest"]) as f:
        manifest = json.load(f)
    assert manifest["start_round"] == 4
    assert manifest["window_sim_total_time"] == float(np.sum(full.timeset[4:]))
    assert manifest["sim_total_time"] == full.sim_total_time


def test_a_start_round_covering_the_run_gives_an_empty_history(runs, data, tmp_path):
    cfg, full, _, _ = runs["logistic", "AGD"]
    ckpt.save(str(tmp_path / "round_9"), full.final_state, 9)
    res = trainer.train(cfg, data, device="cpu", checkpoint_dir=str(tmp_path), resume=True)
    assert res.start_round == 9 and res.params_history.shape == (0, N_COLS)
    assert res.steps_per_sec == 0.0 and res.wall_time == 0.0
    assert _state_bits(res.final_state) == _state_bits(full.final_state)


def test_steps_per_sec_leaves_the_checkpoint_io_out(data, tmp_path, monkeypatch):
    real_save = ckpt.save

    def slow_save(*args):
        time.sleep(1.0)
        real_save(*args)

    monkeypatch.setattr(trainer.ckpt_lib, "save", slow_save)
    res = trainer.train(_cfg(), data, device="cpu", checkpoint_dir=str(tmp_path),
                        checkpoint_every=2)
    assert len(os.listdir(tmp_path)) == 2
    assert res.wall_time < 1.0
    assert res.steps_per_sec == pytest.approx(ROUNDS / res.wall_time)


# ---------------------------------------------------------------------------
# the checkpoint files


def _tensor(*shape, dtype=torch.float32, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


STATES = {
    "gd_none": lambda: OptState(params=_tensor(5), momentum=None),
    "agd_tensor": lambda: OptState(params=_tensor(5), momentum=_tensor(5, seed=1)),
    "agd_dict": lambda: OptState(
        params={"a": _tensor(2, 3), "b": _tensor(())},
        momentum={"a": _tensor(2, 3, seed=1), "b": _tensor((), seed=2)},
    ),
    "adam_pair": lambda: OptState(
        params={"w": _tensor(4, dtype=torch.float64)},
        momentum=({"w": _tensor(4, seed=1, dtype=torch.float64)},
                  {"w": _tensor(4, seed=2, dtype=torch.float64)}),
    ),
    "adam_bf16": lambda: OptState(
        params=_tensor(3, dtype=torch.bfloat16),
        momentum=(_tensor(3, seed=1, dtype=torch.bfloat16), _tensor(3, seed=2)),
    ),
}


@pytest.mark.parametrize("name", list(STATES))
def test_every_state_shape_round_trips(tmp_path, name):
    state = STATES[name]()
    path = str(tmp_path / "round_7")
    ckpt.save(path, state, 7)
    assert ckpt.is_valid(path) and sorted(os.listdir(tmp_path)) == ["round_7"]
    back, nxt = ckpt.restore(path, state)
    assert nxt == 7
    assert type(back.momentum) is type(state.momentum)
    flat = lambda s: [s.params] + (list(s.momentum) if isinstance(s.momentum, tuple)  # noqa: E731
                                   else [s.momentum])
    for a, b in zip(flat(back), flat(state)):
        if b is None:
            assert a is None
            continue
        for x, y in zip(blocks.tree_leaves(a), blocks.tree_leaves(b)):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
    # overwriting keeps one committed directory
    ckpt.save(path, state, 8)
    assert ckpt.restore(path, state)[1] == 8 and sorted(os.listdir(tmp_path)) == ["round_7"]


def test_restore_refuses_another_runs_state(tmp_path):
    ckpt.save(str(tmp_path / "round_1"), STATES["agd_tensor"](), 1)
    with pytest.raises(ValueError, match="does not hold this run's optimizer state"):
        ckpt.restore(str(tmp_path / "round_1"), STATES["agd_dict"]())


def _three(tmp_path):
    state = STATES["agd_dict"]()
    for r in (1, 2, 3):
        ckpt.save(str(tmp_path / f"round_{r}"), state, r)
    return state


def test_missing_marker_falls_back(tmp_path, capsys):
    state = _three(tmp_path)
    os.remove(tmp_path / "round_3" / ckpt.COMMIT_MARKER)
    assert ckpt.latest(str(tmp_path)) == str(tmp_path / "round_2")
    _, nxt, path = ckpt.restore_latest(str(tmp_path), state)
    assert (nxt, path) == (2, str(tmp_path / "round_2"))
    err = capsys.readouterr().err
    assert "partially written: commit marker missing" in err and "round_3" in err


def test_truncated_file_falls_back(tmp_path, capsys):
    state = _three(tmp_path)
    os.remove(tmp_path / "round_3" / ckpt.COMMIT_MARKER)
    f = tmp_path / "round_2" / ckpt.STATE_NAME
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 2])
    assert ckpt.latest(str(tmp_path)) == str(tmp_path / "round_2")  # the marker is there
    _, nxt, path = ckpt.restore_latest(str(tmp_path), state)
    assert (nxt, path) == (1, str(tmp_path / "round_1"))
    err = capsys.readouterr().err
    assert "round_3" in err and "round_2" in err and "restore failed" in err
    os.remove(tmp_path / "round_1" / ckpt.COMMIT_MARKER)
    assert ckpt.restore_latest(str(tmp_path), state) is None


def test_candidates_ignore_temporaries_and_order_by_round(tmp_path):
    for name in ("round_10", "round_9", "round_x", ".round_11.tmp", "other"):
        (tmp_path / name).mkdir()
    assert ckpt._candidates(str(tmp_path)) == [str(tmp_path / "round_10"),
                                               str(tmp_path / "round_9")]
    assert ckpt._candidates(str(tmp_path / "absent")) == []


def test_aux_sidecar(tmp_path, capsys):
    state = STATES["gd_none"]()
    ckpt.save_with_aux(str(tmp_path / "round_4"), state, 4, {"members": [0, 2]})
    ckpt.save(str(tmp_path / "round_6"), state, 6)  # no aux: skipped
    assert ckpt.load_aux(str(tmp_path / "round_4")) == {"members": [0, 2]}
    _, nxt, path, aux = ckpt.restore_latest_with_aux(str(tmp_path), state)
    assert (nxt, aux) == (4, {"members": [0, 2]})
    assert "aux sidecar missing" in capsys.readouterr().err
    (tmp_path / "round_4" / ckpt.AUX_NAME).write_text("{torn")
    assert ckpt.load_aux(str(tmp_path / "round_4")) is None
    assert ckpt.restore_latest_with_aux(str(tmp_path), state) is None


def test_resume_without_a_checkpoint_starts_at_zero(data, jdata, tmp_path, capsys):
    cfg, none = _cfg(), str(tmp_path / "none")
    jres = j_trainer.train(_jcfg(), jdata, checkpoint_dir=none, resume=True)
    want = capsys.readouterr().err.strip().splitlines()
    res = trainer.train(cfg, data, device="cpu", checkpoint_dir=none, resume=True)
    got = capsys.readouterr().err.strip().splitlines()
    assert res.start_round == jres.start_round == 0 and res.params_history.shape[0] == ROUNDS
    assert "no usable checkpoint" in want[-1] and got[-1] == want[-1]
    with pytest.raises(ValueError, match="checkpoint_every must be >= 1, got 0"):
        trainer.train(cfg, data, device="cpu", checkpoint_dir=str(tmp_path), checkpoint_every=0)


# ---------------------------------------------------------------------------
# the CLI


BAD_FLAGS = [
    ["--resume"],
    ["--checkpoint-dir", "d", "--checkpoint-every", "0"],
    ["--checkpoint-dir", "d"],
    ["--checkpoint-every", "3"],
]


def _refusal(cli, argv, capsys):
    parser = cli._flags_parser()
    ns = parser.parse_args(argv)
    with pytest.raises(SystemExit) as exc:
        cli._validate_checkpoint_flags(parser, ns)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", BAD_FLAGS, ids=lambda a: "_".join(a).strip("-"))
def test_cli_refusals_carry_jax_messages(argv, capsys):
    got = _refusal(t_cli, argv, capsys)
    want = _refusal(j_cli, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[1].split("error: ", 1)[1] == want[1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    [], ["--checkpoint-dir", "d", "--resume"], ["--checkpoint-dir", "d", "--checkpoint-every", "2"],
    ["--checkpoint-dir", "d", "--checkpoint-every", "2", "--resume"],
])
def test_cli_accepts_what_jax_accepts(argv):
    for cli in (t_cli, j_cli):
        parser = cli._flags_parser()
        cli._validate_checkpoint_flags(parser, parser.parse_args(argv))
    ns = t_cli._flags_parser().parse_args(argv)
    assert isinstance(ns, argparse.Namespace)


@pytest.mark.parametrize("model", MODELS)
def test_cli_checkpoint_and_resume(tmp_path, model):
    base = ["--scheme", "approx", "--workers", str(W), "--stragglers", "1", "--num-collect", "3",
            "--rounds", str(ROUNDS), "--rows", str(N_ROWS), "--cols", str(N_COLS),
            "--update-rule", "AGD", "--lr", "1.0", "--add-delay", "--model", model,
            "--device", "cpu", "--quiet"]
    if model == "attention":
        base += ["--layer-coding", "on"]
    d = str(tmp_path / "ckpt")
    outs = {k: str(tmp_path / k) for k in ("full", "saved", "resumed")}
    assert t_cli.main(base + ["--output-dir", outs["full"]]) == 0
    assert t_cli.main(base + ["--output-dir", outs["saved"], "--checkpoint-dir", d,
                              "--checkpoint-every", "2"]) == 0
    assert t_cli.main(base + ["--output-dir", outs["resumed"], "--checkpoint-dir", d,
                              "--resume"]) == 0
    prefix = "approx_acc_1"
    for name in ("training_loss", "testing_loss", "auc", "timeset", "worker_timeset"):
        read = lambda k: np.loadtxt(os.path.join(outs[k], f"{prefix}_{name}.dat"), ndmin=2)  # noqa: E731
        full, saved, resumed = read("full"), read("saved"), read("resumed")
        if name != "worker_timeset":
            full, saved, resumed = (a.reshape(-1) for a in (full, saved, resumed))
        assert saved.tobytes() == full.tobytes(), name
        assert resumed.tobytes() == full[4:].tobytes(), name
