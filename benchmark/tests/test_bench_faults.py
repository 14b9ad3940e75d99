"""The comparison that decides ``correct`` fails what it must.

- The control: the plain reference computed in the precision the
  configuration's ``control`` names (TF32 for gmm132k, bfloat16 for
  covtype) in the program's place fails the committed limits; the program
  at the same size passes them (calibrate.py reads both on the card at the
  cells' full size).
- Faults planted in the port underneath a whole run of the harness (the
  card's look skipped, the CPU path of the port; faults.py): a step that
  returns its state unchanged, half of each gradient's rows left out with
  the rest counted double, an answer altered where it is produced (a
  round's replayed loss, a round's simulated clock). A one-chip cell has no
  exchange between chips to leave out.
"""

from __future__ import annotations

import pytest

from bench_util import SMALL, cut

import check  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402

CELLS = ("gmm132k.approx.seq", "covtype.approx.seq", "covtype.sweep7.cohort")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_program_passes(name):
    cell = cut(name, SMALL, rounds=100)
    for seed in (11, 12, 13):
        got = check.readings(cell, seed, "cpu", control=True)
        assert check.passes(got["program"], cell.limits), got["program"]
        assert not check.passes(got["control"], cell.limits), got["control"]


def _run(name, fault):
    with faults.FAULTS[fault]():
        return harness.run_cell(cut(name), 2**31 + 99, 0.1, False, device="cpu",
                                log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_fails(name):
    assert _run(name, "unchanged")["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_fails(name):
    assert _run(name, "half_rows")["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_altered_loss_fails(name):
    out = _run(name, "loss")
    assert out["correct"] is False and out["checks"]["loss_gap"]["value"] > 5e-4


@pytest.mark.parametrize("name", CELLS)
def test_altered_clock_fails(name):
    out = _run(name, "clock")
    assert out["correct"] is False and out["checks"]["clock_gap"]["value"] > 0


def test_faults_put_the_port_back():
    from erasurehead_tpu_torch.train import evaluate, optimizer, trainer

    before = (optimizer.make_table_update_fn, trainer._grad_lowering, evaluate.replay,
              trainer.build_schedule)
    for make in faults.FAULTS.values():
        with make():
            pass
    assert before == (optimizer.make_table_update_fn, trainer._grad_lowering,
                      evaluate.replay, trainer.build_schedule)
