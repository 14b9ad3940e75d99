"""Determinism and replay audit: a run must replay bit for bit.

The port of erasurehead_tpu/utils/audit.py. The reference's concurrency
correctness rests on MPI tag discipline; here there are no tags and no
mailboxes: the control plane is precomputed host float64, and the device
work of a round is one kernel launch whose reduction order is fixed (B1
reduces its per-block partial sums in a fixed order, no atomics). What can
still silently break reproducibility is an unseeded source entering the
control plane, or a reduction whose order varies between launches. This
module makes both checkable: build the control plane twice and run the same
config twice, and demand bitwise equality.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AuditResult:
    bitwise_equal: bool
    max_abs_diff: float
    what: str

    def __bool__(self) -> bool:
        return self.bitwise_equal


def _compare(a, b, what: str) -> AuditResult:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return AuditResult(False, np.inf, f"{what}: shape {a.shape} vs {b.shape}")
    equal = bool(np.array_equal(a, b))
    diff = 0.0 if equal else float(np.max(np.abs(a - b)))
    return AuditResult(equal, diff, what)


def audit_schedule_determinism(cfg) -> AuditResult:
    """The control plane (arrivals -> collection weights) must replay bit
    for bit: the same arrival construction and collection rule ``train()``
    uses, so a heterogeneous-cluster config audits the schedule it runs."""
    from erasurehead_tpu_torch.train import trainer

    outs = []
    for _ in range(2):
        layout = trainer.build_layout(cfg)
        s = trainer.build_schedule(cfg, trainer.default_arrivals(cfg), layout)
        outs.append(np.concatenate(
            [s.message_weights.ravel(), s.sim_time.ravel(), s.worker_times.ravel()]
        ))
    return _compare(outs[0], outs[1], "collection schedule")


def audit_training_determinism(cfg, dataset, device=None) -> AuditResult:
    """Two full ``train()`` runs on ``device`` (cuda unless "cpu" is asked
    for) must give bitwise equal iterate histories: catches a reduction
    whose order varies and state leaking between runs."""
    from erasurehead_tpu_torch.ops import blocks
    from erasurehead_tpu_torch.train import trainer

    hists = []
    for _ in range(2):
        res = trainer.train(cfg, dataset, device=device)
        hists.append(np.concatenate([
            np.asarray(leaf.detach().cpu()).ravel()
            for leaf in blocks.tree_leaves(res.params_history)
        ]))
    return _compare(hists[0], hists[1], "iterate history")


def audit(cfg, dataset, device=None) -> dict:
    """The full audit; every value must be truthy for a reproducible set-up."""
    return {
        "schedule": audit_schedule_determinism(cfg),
        "training": audit_training_determinism(cfg, dataset, device=device),
    }
