"""The built-in scheme descriptors: the reference's seven plus randreg,
sparsegraph, expander and deadline, declared as registry entries.

The port's copy of erasurehead_tpu/schemes/builtin.py. Each descriptor wires
the scheme's layout factory (ops/codes.py) and host collection rule
(parallel/collect.py) together, with the same capability flags, config
fields, validation hooks and artifact stems as the JAX package declares.

The ``optimal_decode`` hook is the ``decode="optimal"`` option
(arXiv:2006.09638): least-squares collection weights fit to the actual
per-round arrival set over the layout's effective coding matrix. Partial
schemes keep ``optimal_decode=None``: their separate slots are weighted 1.0
outside the message-weight system, so the fixed decode is the only one
defined.
"""

from __future__ import annotations

from erasurehead_tpu_torch.ops import codes
from erasurehead_tpu_torch.parallel import collect
from erasurehead_tpu_torch.schemes.base import SchemeDescriptor
from erasurehead_tpu_torch.schemes.registry import register

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

    return register(SchemeDescriptor(
        name=name,
        summary=summary,
        build_layout=build_layout,
        build_schedule=_sched,
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
    optimal_decode=None,
    exact=True,
    partial=True,
    supports_measured=False,
    config_fields=("partitions_per_worker",),
    validate_config=_validate_partial,
    artifact_stem="partialreplication",  # src/partial_replication.py
    builtin=True,
))
