"""The built-in scheme descriptors: the reference's seven plus randreg,
sparsegraph, expander and deadline, declared as registry entries.

The port's copy of erasurehead_tpu/schemes/builtin.py. Each descriptor wires
the scheme's layout factory (ops/codes.py) and host collection rule
(parallel/collect.py) together, with the same capability flags, config
fields, validation hooks and artifact stems as the JAX package declares.

The ``dynamic_rule`` factories close over the layout's tables on the run's
device (parallel/dynamic.py); the MDS family's also over the float64
decode table (ops/codes.build_decode_table), with the JAX package's warning
where C(W, s) exceeds the table's cap and the float32 solve takes over. The
``feasibility`` cores are parallel/failures.analyze's per-scheme table,
with the JAX package's reasons word for word.

The ``optimal_decode`` hook is the ``decode="optimal"`` option
(arXiv:2006.09638): least-squares collection weights fit to the actual
per-round arrival set over the layout's effective coding matrix. Partial
schemes keep ``optimal_decode=None``: their separate slots are weighted 1.0
outside the message-weight system, so the fixed decode is the only one
defined.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from erasurehead_tpu_torch.ops import codes
from erasurehead_tpu_torch.parallel import collect, dynamic
from erasurehead_tpu_torch.schemes.base import SchemeDescriptor
from erasurehead_tpu_torch.schemes.registry import register

# ---------------------------------------------------------------------------
# shared feasibility helpers (parallel/failures.analyze's precomputations)
# ---------------------------------------------------------------------------


def _alive_cnt(dead: np.ndarray) -> np.ndarray:
    return (~dead).sum(axis=1)


def _all_groups_alive(layout, dead: np.ndarray) -> np.ndarray:
    groups = np.asarray(layout.groups)
    return np.stack(
        [(~dead[:, groups == g]).any(axis=1) for g in range(layout.n_groups)],
        axis=1,
    ).all(axis=1)


def _feas_agc(layout, dead, num_collect):
    if num_collect is None:
        raise ValueError("AGC needs num_collect")
    return (_alive_cnt(dead) >= num_collect) | _all_groups_alive(layout, dead)


def _feas_randreg(dead, num_collect):
    if num_collect is None:
        raise ValueError("randreg needs num_collect")
    return _alive_cnt(dead) >= num_collect


def _feas_all(reason):
    return lambda layout, dead, *, num_collect=None: (
        _alive_cnt(dead) == dead.shape[1], reason
    )


def _feas_first_w_minus_s(layout, dead, *, num_collect=None):
    return (
        _alive_cnt(dead) >= dead.shape[1] - layout.n_stragglers,
        f"needs first {layout.n_workers - layout.n_stragglers} arrivals",
    )


def _feas_first_k(layout, dead, *, num_collect=None):
    return _feas_randreg(dead, num_collect), f"needs first {num_collect} arrivals"


# ---------------------------------------------------------------------------
# dynamic-rule factories (parallel/dynamic.py's rules over each layout's
# tables, placed on the run's device once)
# ---------------------------------------------------------------------------


def _mds_table_or_warn(scheme_name, layout, max_stragglers, exact_only):
    """The float64 decode table of an MDS-family dynamic rule, or None with
    the JAX package's warning when C(W, s) exceeds the table's cap and the
    rule falls back to the float32 on-device solve."""
    table = codes.build_decode_table(
        np.asarray(layout.B), max_stragglers, exact_only=exact_only
    )
    if table is None and layout.n_workers > 16:
        warnings.warn(
            f"{scheme_name}: C(W, s) too large for a decode table at "
            f"W={layout.n_workers}; falling back to the on-device fp32 "
            "solve, which is UNRELIABLE for ill-conditioned straggler "
            "patterns at this scale (see ops/codes.mds_decode_weights_host)."
            " Prefer trainer.train() (host f64 control plane) for science"
            " runs.",
            stacklevel=3,
        )
    return table


#: why a rule without a decode table keeps train_dynamic's eager loop
FLOAT32_SOLVE_SYNC = ("the float32 decode solve: the SVD inside torch.linalg.pinv "
                      "synchronises with the host, which a CUDA graph cannot capture")


def _solving(rule, table):
    """``rule``, marked ``host_sync`` when it has no decode table and takes
    the float32 on-device solve (parallel/dynamic.make_round_schedule_fn
    passes the mark on)."""
    if table is None:
        rule.host_sync = FLOAT32_SOLVE_SYNC
    return rule


def _on(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _table_on(table, device):
    if table is not None:
        table.on(device)  # the gather's tensors, moved before the loop
    return table


def _dyn_naive(layout, *, num_collect=None, deadline=None, device=None):
    return dynamic.collect_all


def _dyn_cyclic_mds(layout, *, num_collect=None, deadline=None, device=None):
    B = _on(layout.B, device)
    table = _table_on(_mds_table_or_warn(
        "cyccoded", layout, layout.n_stragglers, exact_only=True), device)
    return _solving(
        lambda t: dynamic.collect_first_k_mds(t, B, layout.n_stragglers, decode_table=table),
        table)


def _onehot(layout, device):
    return _on(dynamic._group_onehot(np.asarray(layout.groups)), device)


def _dyn_frc(layout, *, num_collect=None, deadline=None, device=None):
    onehot = _onehot(layout, device)
    return lambda t: dynamic.collect_frc(t, onehot)


def _dyn_agc(layout, *, num_collect=None, deadline=None, device=None):
    if num_collect is None:
        raise ValueError("AGC needs num_collect")
    onehot = _onehot(layout, device)
    return lambda t: dynamic.collect_agc(t, onehot, num_collect)


def _dyn_avoidstragg(layout, *, num_collect=None, deadline=None, device=None):
    return lambda t: dynamic.collect_avoidstragg(t, layout.n_stragglers)


def _dyn_deadline(layout, *, num_collect=None, deadline=None, device=None):
    if deadline is None:
        raise ValueError("deadline scheme needs a deadline")
    return lambda t: dynamic.collect_deadline(t, deadline)


def _dyn_partial_cyclic(layout, *, num_collect=None, deadline=None, device=None):
    B = _on(layout.B, device)
    # completed sets can exceed W - s here: the full 0..s pattern range
    table = _table_on(_mds_table_or_warn(
        "partialcyccoded", layout, layout.n_stragglers, exact_only=False), device)
    frac = layout.uncoded_frac
    return _solving(lambda t: dynamic.collect_partial(
        t, variant="mds", frac=frac, n_stragglers=layout.n_stragglers,
        B=B, decode_table=table,
    ), table)


def _dyn_partial_frc(layout, *, num_collect=None, deadline=None, device=None):
    onehot = _onehot(layout, device)
    gids = _on(layout.groups, device, torch.int64)
    frac = layout.uncoded_frac
    return lambda t: dynamic.collect_partial(
        t, variant="frc", frac=frac, onehot=onehot, group_ids=gids,
    )

# ---------------------------------------------------------------------------
# config validation hooks
# ---------------------------------------------------------------------------


def _validate_partial(cfg) -> None:
    if cfg.partitions_per_worker < cfg.n_stragglers + 2:
        raise ValueError(
            "partial schemes need partitions_per_worker >= n_stragglers+2"
        )


def _validate_frc(cfg) -> None:
    # the reference guard (src/replication.py:24-26), surfaced at config
    # time rather than deep inside layout construction
    if cfg.n_workers % (cfg.n_stragglers + 1):
        raise ValueError(
            f"scheme={cfg.scheme.value!r} needs (n_stragglers+1) | "
            f"n_workers for its fractional-repetition layout (reference "
            f"guard src/replication.py:24-26); got n_workers="
            f"{cfg.n_workers}, n_stragglers={cfg.n_stragglers}"
        )


# ---------------------------------------------------------------------------
# host collection rules
# ---------------------------------------------------------------------------


def _sched_all(t, layout, *, num_collect=None, deadline=None):
    return collect.collect_all(t)


def _sched_first_k_mds(t, layout, *, num_collect=None, deadline=None):
    return collect.collect_first_k_mds(t, layout.B, layout.n_stragglers)


def _sched_frc(t, layout, *, num_collect=None, deadline=None):
    return collect.collect_frc(t, layout.groups)


def _sched_avoidstragg(t, layout, *, num_collect=None, deadline=None):
    return collect.collect_avoidstragg(t, layout.n_stragglers)


def _sched_agc(t, layout, *, num_collect=None, deadline=None):
    if num_collect is None:
        raise ValueError("AGC needs num_collect")
    return collect.collect_agc(t, layout.groups, num_collect)


def _sched_deadline(t, layout, *, num_collect=None, deadline=None):
    if deadline is None:
        raise ValueError("deadline scheme needs a deadline")
    return collect.collect_deadline(t, deadline)


def _sched_partial(variant):
    def rule(t, layout, *, num_collect=None, deadline=None):
        return collect.collect_partial(t, layout, variant)

    return rule


# ---------------------------------------------------------------------------
# the eleven builtins
# ---------------------------------------------------------------------------

NAIVE = register(SchemeDescriptor(
    name="naive",
    summary="uncoded synchronous GD: wait for all W workers (src/naive.py)",
    build_layout=lambda cfg: codes.uncoded_layout(cfg.n_workers),
    build_schedule=_sched_all,
    dynamic_rule=_dyn_naive,
    feasibility=_feas_all("needs all W workers"),
    optimal_decode=collect.optimal_decode_schedule,
    exact=True,
    artifact_straggler_suffix=False,  # "naive_acc", no _<s> (src/naive.py:203)
    builtin=True,
))

CYCLIC_MDS = register(SchemeDescriptor(
    name="cyccoded",
    summary="exact gradient coding, cyclic MDS code (src/coded.py)",
    build_layout=lambda cfg: codes.cyclic_mds_layout(
        cfg.n_workers, cfg.n_stragglers, seed=cfg.seed
    ),
    build_schedule=_sched_first_k_mds,
    dynamic_rule=_dyn_cyclic_mds,
    feasibility=_feas_first_w_minus_s,
    optimal_decode=collect.optimal_decode_schedule,
    exact=True,
    seed_dependent_layout=True,
    artifact_stem="coded_acc",  # src/coded.py:250-254
    builtin=True,
))

FRC = register(SchemeDescriptor(
    name="repcoded",
    summary="exact coding, fractional repetition groups (src/replication.py)",
    build_layout=lambda cfg: codes.frc_layout(cfg.n_workers, cfg.n_stragglers),
    build_schedule=_sched_frc,
    dynamic_rule=_dyn_frc,
    feasibility=lambda layout, dead, *, num_collect=None: (
        _all_groups_alive(layout, dead), "needs one arrival per group"
    ),
    optimal_decode=collect.optimal_decode_schedule,
    exact=True,
    validate_config=_validate_frc,
    artifact_stem="replication_acc",  # src/replication.py
    builtin=True,
))

APPROX = register(SchemeDescriptor(
    name="approx",
    summary=(
        "approximate gradient coding: first num_collect arrivals, group "
        "erasures (src/approximate_coding.py)"
    ),
    build_layout=lambda cfg: codes.frc_layout(cfg.n_workers, cfg.n_stragglers),
    build_schedule=_sched_agc,
    dynamic_rule=_dyn_agc,
    feasibility=lambda layout, dead, *, num_collect=None: (
        _feas_agc(layout, dead, num_collect),
        f"needs {num_collect} arrivals or full group coverage",
    ),
    optimal_decode=collect.optimal_decode_schedule,
    needs_num_collect=True,
    staleness_tolerant=True,  # the decode is already approximate
    config_fields=("num_collect",),
    validate_config=_validate_frc,  # AGC shares FRC's grouped layout
    sweep_num_collect=lambda n_workers: n_workers // 2,
    builtin=True,
))

AVOID_STRAGGLERS = register(SchemeDescriptor(
    name="avoidstragg",
    summary=(
        "ignore-stragglers baseline: first W-s uncoded gradients, W/(W-s) "
        "rescale (src/avoidstragg.py)"
    ),
    build_layout=lambda cfg: codes.uncoded_layout(
        cfg.n_workers, n_stragglers=cfg.n_stragglers
    ),
    build_schedule=_sched_avoidstragg,
    dynamic_rule=_dyn_avoidstragg,
    feasibility=_feas_first_w_minus_s,
    optimal_decode=collect.optimal_decode_schedule,
    staleness_tolerant=True,  # rescaled-subset gradient: already approximate
    builtin=True,
))


def _first_k_optimal_family(name, summary, build_layout, *, seed_dependent, sweep=True):
    """The shared descriptor of the sparse-code families (randreg,
    sparsegraph, expander): 0/1-incidence layouts collected by
    first-``num_collect`` arrivals with the lstsq-optimal combination over
    the received rows of B (arXiv 2006.09638). ``sweep``: straggler sweeps
    collect half the workers where the base config collects all (the JAX
    package declares that for sparsegraph and expander, not randreg)."""

    def _sched(t, layout, *, num_collect=None, deadline=None):
        if num_collect is None:
            raise ValueError(f"{name} needs num_collect")
        return collect.collect_first_k_optimal(t, layout.B, num_collect)

    def _dyn(layout, *, num_collect=None, deadline=None, device=None):
        if num_collect is None:
            raise ValueError(f"{name} needs num_collect")
        B = _on(layout.B, device)
        table = _table_on(_mds_table_or_warn(
            name, layout, layout.n_workers - num_collect, exact_only=True), device)
        return _solving(
            lambda t: dynamic._first_k_lstsq(t, B, num_collect, decode_table=table), table)

    return register(SchemeDescriptor(
        name=name,
        summary=summary,
        build_layout=build_layout,
        build_schedule=_sched,
        dynamic_rule=_dyn,
        feasibility=_feas_first_k,
        optimal_decode=collect.optimal_decode_schedule,
        needs_num_collect=True,
        staleness_tolerant=True,  # lstsq decode over a partial set: approximate
        config_fields=("num_collect",),
        seed_dependent_layout=seed_dependent,
        sweep_num_collect=(lambda n_workers: n_workers // 2) if sweep else None,
        builtin=True,
    ))


RANDOM_REGULAR = _first_k_optimal_family(
    "randreg",
    (
        "sparse random d-regular code with lstsq-optimal decoding "
        "(arXiv:1711.06771 + 2006.09638)"
    ),
    lambda cfg: codes.random_regular_layout(
        cfg.n_workers, cfg.n_stragglers, seed=cfg.seed
    ),
    seed_dependent=True,
    sweep=False,
)

SPARSE_GRAPH = _first_k_optimal_family(
    "sparsegraph",
    (
        "sparse random bipartite-graph code with lstsq-optimal decoding "
        "(arXiv:1711.06771 + 2006.09638): partition-regular, ragged "
        "worker loads"
    ),
    lambda cfg: codes.sparse_graph_layout(
        cfg.n_workers, cfg.n_stragglers, seed=cfg.seed
    ),
    seed_dependent=True,
)

EXPANDER = _first_k_optimal_family(
    "expander",
    (
        "deterministic circulant expander-style code with lstsq decoding "
        "(arXiv:1707.03858): evenly spread cyclic chords, seed-free "
        "layout"
    ),
    lambda cfg: codes.expander_layout(cfg.n_workers, cfg.n_stragglers),
    seed_dependent=False,
)

DEADLINE = register(SchemeDescriptor(
    name="deadline",
    summary=(
        "deadline collection: whatever arrived by the cutoff, W/collected "
        "rescale (beyond the reference)"
    ),
    build_layout=lambda cfg: codes.uncoded_layout(cfg.n_workers),
    build_schedule=_sched_deadline,
    dynamic_rule=_dyn_deadline,
    feasibility=lambda layout, dead, *, num_collect=None: (
        np.ones(dead.shape[0], dtype=bool),
        "deadline collection always completes",
    ),
    optimal_decode=collect.optimal_decode_schedule,
    needs_deadline=True,
    staleness_tolerant=True,  # deadline-subset rescale: already approximate
    config_fields=("deadline",),
    builtin=True,
))

PARTIAL_CYCLIC = register(SchemeDescriptor(
    name="partialcyccoded",
    summary=(
        "two-part partial MDS: unique uncoded slots + cyclic coded band "
        "(src/partial_coded.py)"
    ),
    build_layout=lambda cfg: codes.partial_cyclic_layout(
        cfg.n_workers, cfg.partitions_per_worker, cfg.n_stragglers,
        seed=cfg.seed,
    ),
    build_schedule=_sched_partial("mds"),
    dynamic_rule=_dyn_partial_cyclic,
    feasibility=_feas_all("needs every worker's uncoded first-part"),
    optimal_decode=None,  # separate slots sit outside the message weights
    exact=True,
    partial=True,
    seed_dependent_layout=True,
    supports_measured=False,  # two-part send has no single-message timing
    config_fields=("partitions_per_worker",),
    validate_config=_validate_partial,
    artifact_stem="partialcoded",  # src/partial_coded.py (stem bug fixed)
    builtin=True,
))

PARTIAL_FRC = register(SchemeDescriptor(
    name="partialrepcoded",
    summary=(
        "two-part partial FRC: unique uncoded slots + replicated coded "
        "band (src/partial_replication.py)"
    ),
    build_layout=lambda cfg: codes.partial_frc_layout(
        cfg.n_workers, cfg.partitions_per_worker, cfg.n_stragglers
    ),
    build_schedule=_sched_partial("frc"),
    dynamic_rule=_dyn_partial_frc,
    feasibility=_feas_all("needs every worker's uncoded first-part"),
    optimal_decode=None,
    exact=True,
    partial=True,
    supports_measured=False,
    config_fields=("partitions_per_worker",),
    validate_config=_validate_partial,
    artifact_stem="partialreplication",  # src/partial_replication.py
    builtin=True,
))
