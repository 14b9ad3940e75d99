"""SchemeDescriptor: the declarative unit of the scheme registry.

The port's copy of erasurehead_tpu/schemes/base.py, field for field. A
:class:`SchemeDescriptor` bundles, per scheme:

  - **layout builder** (``build_layout``): RunConfig -> ops/codes
    CodingLayout (which partitions each worker holds, with which coding
    coefficients);
  - **host collection rule** (``build_schedule``): the stop condition and
    decode weights as a pure function of the arrival matrix
    (parallel/collect.py's rule functions);
  - **dynamic rule factory** (``dynamic_rule``): the same rule as a
    fixed-shape tensor computation on the run's device
    (parallel/dynamic.py, trainer.train_dynamic), or None where the scheme
    has none;
  - **failure feasibility** (``feasibility``): would the master's wait
    loop ever exit under these deaths (parallel/failures.analyze)?
  - **optimal-decode hook** (``optimal_decode``): the ``decode="optimal"``
    option (arXiv:2006.09638), per-round least-squares collection weights
    fit to the actual arrival pattern; None keeps the scheme's fixed
    weights (partial schemes);
  - **capability flags** and the **config/CLI surface** (``config_fields``,
    ``validate_config``, ``sweep_num_collect``).

The capability flags keep the JAX values, so ``capabilities()`` compares
equal; on every built-in ``supports_dynamic`` holds exactly where
``dynamic_rule`` is set, as in the JAX package. The one difference of
signature: ``dynamic_rule`` also takes the ``device`` its constants are
placed on.

Descriptors are frozen: registration is declaration. Third-party codes ship
one descriptor and register it, directly through
:func:`erasurehead_tpu_torch.schemes.register` or through the
``erasurehead_tpu_torch.schemes`` entry-point group (registry.py), and the
CLI ``--scheme`` choices and ``utils.config`` validation pick it up.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SchemeDescriptor:
    """One collection/coding scheme, declaratively (module docstring)."""

    #: the CLI / config name ("approx", "cyccoded", ...)
    name: str
    #: one-line human summary
    summary: str = ""

    # ---- behavior --------------------------------------------------------
    #: (cfg: RunConfig) -> ops.codes.CodingLayout
    build_layout: Optional[Callable] = None
    #: (t [R, W], layout, *, num_collect, deadline) ->
    #: parallel.collect.CollectionSchedule, the host (float64) rule
    build_schedule: Optional[Callable] = None
    #: (layout, *, num_collect, deadline, device) -> (t [W] tensor ->
    #: parallel.dynamic.RoundSchedule), the on-device rule factory; None =
    #: no dynamic implementation
    dynamic_rule: Optional[Callable] = None
    #: (layout, dead [R, W] bool, *, num_collect) -> (feasible [R] bool,
    #: reason str), parallel.failures.analyze's per-scheme core
    feasibility: Optional[Callable] = None
    #: (schedule, layout) -> schedule with decode="optimal" weights; None =
    #: the fixed weights are the scheme's only decode (partial schemes)
    optimal_decode: Optional[Callable] = None

    # ---- capabilities ----------------------------------------------------
    #: decodes to the exact full gradient whenever its stop rule is
    #: satisfiable
    exact: bool = False
    #: two-part partial layout (uncoded slots + coded band)
    partial: bool = False
    #: the layout depends on cfg.seed
    seed_dependent_layout: bool = False
    #: has a per-worker-timed measured-arrival implementation
    supports_measured: bool = True
    #: has an on-device rule (trainer.train_dynamic)
    supports_dynamic: bool = True
    #: may ride a trajectory-batched cohort dispatch
    cohort_batchable: bool = True
    #: sound under bounded-staleness pipelined training (pipeline_depth=1):
    #: True only where the decode is already approximate
    staleness_tolerant: bool = False

    # ---- config / CLI surface -------------------------------------------
    #: scheme-specific RunConfig knobs (beyond scheme, n_workers,
    #: n_stragglers and seed)
    config_fields: Tuple[str, ...] = ()
    #: cfg.num_collect is required (AGC-family stop counts)
    needs_num_collect: bool = False
    #: cfg.deadline is required
    needs_deadline: bool = False
    #: (cfg) -> None, raising ValueError on scheme-specific config violations
    validate_config: Optional[Callable] = None
    #: (n_workers) -> num_collect for straggler sweeps whose base config
    #: collects every worker (train/experiments.straggler_sweep: the
    #: interesting regime of a first-k scheme collects fewer than all)
    sweep_num_collect: Optional[Callable] = None

    # ---- artifact naming -------------------------------------------------
    #: reference artifact filename stem (train/artifacts.run_prefix, e.g.
    #: "coded_acc" for cyccoded); None = "<name>_acc"
    artifact_stem: Optional[str] = None
    #: artifacts carry the reference's "_<n_stragglers>" suffix (partial
    #: schemes append "_<partitions_per_worker>" too); naive has none
    artifact_straggler_suffix: bool = True

    #: ships with the package (entry-point/third-party schemes: False)
    builtin: bool = False

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"scheme descriptor needs a name, got {self.name!r}")
        for field in ("build_layout", "build_schedule"):
            if getattr(self, field) is None:
                raise ValueError(
                    f"scheme {self.name!r}: descriptor field {field!r} is "
                    "required (a scheme must at least build a layout and a "
                    "collection schedule)"
                )

    def capabilities(self) -> dict:
        """Flag dict (report rendering, third-party introspection)."""
        return {
            "exact": self.exact,
            "partial": self.partial,
            "seed_dependent_layout": self.seed_dependent_layout,
            "supports_measured": self.supports_measured,
            "supports_dynamic": self.supports_dynamic,
            "cohort_batchable": self.cohort_batchable,
            "staleness_tolerant": self.staleness_tolerant,
            "supports_optimal_decode": self.optimal_decode is not None,
            "needs_num_collect": self.needs_num_collect,
            "needs_deadline": self.needs_deadline,
        }

    def validate(self, cfg) -> None:
        """Scheme-specific config validation (utils.config delegates here
        from RunConfig.__post_init__)."""
        if getattr(cfg, "pipeline_depth", 0) and not self.staleness_tolerant:
            from erasurehead_tpu_torch.utils.config import PipelineRefusal

            kind = "exact-decode" if self.exact else "not staleness-tolerant"
            raise PipelineRefusal(
                "exact_decode" if self.exact else "untested_scheme",
                f"pipeline_depth=1 refuses scheme={self.name!r} ({kind}): "
                "a tau=1-stale gradient breaks the exactness contract, and "
                "only schemes whose descriptor declares staleness_tolerant "
                "(the approximate first-k/deadline families) run pipelined",
            )
        if self.needs_deadline and (cfg.deadline is None or cfg.deadline <= 0):
            raise ValueError(
                f"scheme={self.name!r} needs a positive deadline "
                f"(got {cfg.deadline!r})"
            )
        if self.validate_config is not None:
            self.validate_config(cfg)
