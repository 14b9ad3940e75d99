"""Grid specification for the what-if engine.

The port of erasurehead_tpu/whatif/spec.py: equal specs hash equal in both
packages, and enumeration builds the port's own RunConfig, so a point's
feasibility and reason come from the port's validators (the registry's
descriptors, RunConfig.__post_init__).

A :class:`GridSpec` is the declarative question: which (scheme, W, s,
num_collect, deadline, decode, arrival-regime, pipeline-staleness) points
to simulate, over how many Monte-Carlo seeds, at what problem shape. Enumeration
(:func:`enumerate_points`) builds each point's RunConfig and filters
feasibility through the SAME validation the real entry points use — the
registry descriptor's ``validate_config`` hook via RunConfig's own
``__post_init__`` — so a point the CLI would refuse (FRC divisibility,
missing num_collect/deadline, partial partition counts) is excluded with
its reason recorded on the surface row, never dispatched.

The spec is a pure data object: ``payload()`` is its canonical JSON form
and :func:`spec_hash` its identity — the key that makes a saved surface
rehydratable (engine.run_whatif loads instead of re-simulating when the
artifact's hash matches) and what-if events attributable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Optional

from erasurehead_tpu_torch.whatif.sampler import RegimeSpec


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """One collection policy column of the grid: a scheme plus its
    scheme-specific knobs. ``num_collect=None`` on a first-k scheme
    defaults per grid point to the descriptor's ``sweep_num_collect``
    hook (the "interesting regime collects fewer than all" rule the
    straggler sweep uses); ``collect_frac`` instead derives it as
    ``round(frac * W)`` per point."""

    scheme: str
    num_collect: Optional[int] = None
    collect_frac: Optional[float] = None
    deadline: Optional[float] = None
    partitions_per_worker: int = 0

    def __post_init__(self):
        if self.num_collect is not None and self.collect_frac is not None:
            raise ValueError(
                f"policy {self.scheme!r}: num_collect and collect_frac "
                "both given; pick one"
            )
        if self.collect_frac is not None and not (
            0.0 < self.collect_frac <= 1.0
        ):
            raise ValueError(
                f"collect_frac must be in (0, 1], got {self.collect_frac}"
            )

    @property
    def label(self) -> str:
        parts = [self.scheme]
        if self.num_collect is not None:
            parts.append(f"c{self.num_collect}")
        if self.collect_frac is not None:
            parts.append(f"f{self.collect_frac:g}")
        if self.deadline is not None:
            parts.append(f"d{self.deadline:g}")
        if self.partitions_per_worker:
            parts.append(f"p{self.partitions_per_worker}")
        return ":".join(parts)

    def resolve_num_collect(self, n_workers: int) -> Optional[int]:
        """The point-level num_collect for a W-column of the grid."""
        if self.num_collect is not None:
            return self.num_collect
        if self.collect_frac is not None:
            return max(1, round(self.collect_frac * n_workers))
        from erasurehead_tpu_torch import schemes

        desc = schemes.get(self.scheme)
        if desc.needs_num_collect and desc.sweep_num_collect is not None:
            return desc.sweep_num_collect(n_workers)
        return None

    def payload(self) -> dict:
        out: dict = {"scheme": self.scheme}
        for k in ("num_collect", "collect_frac", "deadline"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.partitions_per_worker:
            out["partitions_per_worker"] = self.partitions_per_worker
        return out


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The full what-if question (module docstring)."""

    policies: tuple
    n_workers: tuple = (8,)
    n_stragglers: tuple = (1,)
    regimes: tuple = (RegimeSpec(),)
    #: Monte-Carlo seeds per grid point (one simulated trajectory each)
    n_seeds: int = 8
    rounds: int = 30
    n_rows: int = 256
    n_cols: int = 16
    model: str = "logistic"
    update_rule: str = "GD"
    lr: Optional[float] = 1.0
    decode: str = "fixed"
    #: loss the time-to-target reduction anchors on; None = 1.05x the
    #: worst converged final loss across the grid (compare()'s rule)
    target_loss: Optional[float] = None
    #: model-init / layout-generator seed — FIXED across the grid's
    #: Monte-Carlo axis (only the arrival draw varies per seed)
    model_seed: int = 0
    data_seed: int = 0
    #: staleness axis: pipeline depths to enumerate per coordinate
    #: (cfg.pipeline_depth; parallel/pipeline.py). Default (0,) — the
    #: synchronous grid, and the axis is then OMITTED from the payload so
    #: every pre-existing spec hash (and its saved surface) is unchanged.
    #: Adding 1 grows the grid with tau=1 points; pipelining-refused
    #: combinations (exact schemes, non-GD update rules) surface as
    #: infeasible rows with the typed reason, exactly like any other
    #: validator refusal — how policy search locates the regime where the
    #: staleness win is largest without tripping over unsound corners.
    pipeline_depths: tuple = (0,)

    def __post_init__(self):
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(
            self, "n_workers", tuple(int(w) for w in self.n_workers)
        )
        object.__setattr__(
            self, "n_stragglers", tuple(int(s) for s in self.n_stragglers)
        )
        object.__setattr__(self, "regimes", tuple(self.regimes))
        object.__setattr__(
            self,
            "pipeline_depths",
            tuple(int(d) for d in self.pipeline_depths),
        )
        if not self.policies:
            raise ValueError("grid spec needs at least one policy")
        if not self.n_workers or not self.n_stragglers or not self.regimes:
            raise ValueError(
                "grid spec needs at least one n_workers, n_stragglers and "
                "regime value"
            )
        if not self.pipeline_depths or any(
            d not in (0, 1) for d in self.pipeline_depths
        ):
            raise ValueError(
                "pipeline_depths must be a non-empty subset of {0, 1} "
                f"(bounded staleness tau=1 is the only pipelined mode), "
                f"got {self.pipeline_depths!r}"
            )
        if self.n_seeds < 1:
            raise ValueError(f"n_seeds must be >= 1, got {self.n_seeds}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")

    @property
    def n_points(self) -> int:
        return (
            len(self.policies)
            * len(self.n_workers)
            * len(self.n_stragglers)
            * len(self.regimes)
            * len(self.pipeline_depths)
        )

    def payload(self) -> dict:
        """Canonical JSON form (stable field order — the hash input)."""
        out = {
            "policies": [p.payload() for p in self.policies],
            "n_workers": list(self.n_workers),
            "n_stragglers": list(self.n_stragglers),
            "regimes": [r.payload() for r in self.regimes],
            "n_seeds": self.n_seeds,
            "rounds": self.rounds,
            "n_rows": self.n_rows,
            "n_cols": self.n_cols,
            "model": self.model,
            "update_rule": self.update_rule,
            "lr": self.lr,
            "decode": self.decode,
            "target_loss": self.target_loss,
            "model_seed": self.model_seed,
            "data_seed": self.data_seed,
        }
        # omitted at the default, like RegimeSpec's optional fields: every
        # synchronous spec keeps its pre-staleness-axis hash, so saved
        # surfaces stay rehydratable (the tau=0 no-drift contract)
        if self.pipeline_depths != (0,):
            out["pipeline_depths"] = list(self.pipeline_depths)
        return out

    def spec_hash(self) -> str:
        blob = json.dumps(self.payload(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass
class GridPoint:
    """One enumerated grid coordinate: a policy under a regime at (W, s).
    ``config`` is the fully-validated RunConfig for feasible points;
    infeasible points carry ``feasible=False`` and the validator's own
    ``reason`` instead — the surface records them, the engine never
    dispatches them."""

    label: str
    policy: PolicySpec
    n_workers: int
    n_stragglers: int
    regime: RegimeSpec
    config: Optional[object] = None
    feasible: bool = True
    reason: Optional[str] = None
    #: the point's staleness coordinate (0 = synchronous)
    pipeline_depth: int = 0


def point_config(
    spec: GridSpec, policy: PolicySpec, W: int, s: int,
    pipeline_depth: int = 0,
):
    """The RunConfig for one grid coordinate — raising ValueError exactly
    where any real entry point would (RunConfig.__post_init__ delegates to
    the registry descriptor's validate hook, which is also where a
    pipelined coordinate on an exact-decode scheme refuses)."""
    from erasurehead_tpu_torch.utils.config import RunConfig

    num_collect = policy.resolve_num_collect(W)
    if num_collect is not None and num_collect > W:
        raise ValueError(
            f"num_collect {num_collect} exceeds n_workers {W}; a stop "
            "count past the worker set never fires"
        )
    return RunConfig(
        scheme=policy.scheme,
        model=spec.model,
        n_workers=W,
        n_stragglers=s,
        num_collect=num_collect,
        deadline=policy.deadline,
        decode=spec.decode,
        rounds=spec.rounds,
        n_rows=spec.n_rows,
        n_cols=spec.n_cols,
        update_rule=spec.update_rule,
        lr_schedule=spec.lr,
        add_delay=True,
        partitions_per_worker=policy.partitions_per_worker,
        compute_mode="deduped",
        seed=spec.model_seed,
        pipeline_depth=pipeline_depth,
    )


def enumerate_points(spec: GridSpec) -> list:
    """Every grid coordinate in deterministic order, feasibility-filtered
    (module docstring). Infeasible points come back with the validator's
    reason, never a config — including PipelineRefusal'd staleness
    coordinates (exact-decode schemes, non-GD update rules), which is how
    the surface records WHERE tau=1 is unsound rather than crashing the
    sweep."""
    points: list = []
    for policy, W, s, regime, depth in itertools.product(
        spec.policies, spec.n_workers, spec.n_stragglers, spec.regimes,
        spec.pipeline_depths,
    ):
        label = f"{policy.label}@W{W}s{s}/{regime.tag}"
        if depth:
            label += f"/tau{depth}"
        try:
            cfg = point_config(spec, policy, W, s, pipeline_depth=depth)
        except ValueError as e:
            points.append(
                GridPoint(
                    label=label, policy=policy, n_workers=W,
                    n_stragglers=s, regime=regime, config=None,
                    feasible=False, reason=str(e), pipeline_depth=depth,
                )
            )
            continue
        points.append(
            GridPoint(
                label=label, policy=policy, n_workers=W, n_stragglers=s,
                regime=regime, config=cfg, pipeline_depth=depth,
            )
        )
    return points


# ---------------------------------------------------------------------------
# CLI parsing: the comma-separated forms `cli whatif` accepts

def parse_policies(text: str) -> tuple:
    """'naive,approx:c4,deadline:d1.5,approx:f0.5' -> PolicySpecs
    (cN = num_collect, fFRAC = collect fraction of W, dSECS = deadline,
    pN = partitions_per_worker — the adapt --adapt-arms syntax plus the
    grid-only fraction/partition forms)."""
    out = []
    for part in text.split(","):
        fields = part.strip().split(":")
        if not fields or not fields[0]:
            raise ValueError(f"bad policy entry {part!r}")
        kw: dict = {}
        for f in fields[1:]:
            try:
                if f.startswith("c"):
                    kw["num_collect"] = int(f[1:])
                elif f.startswith("f"):
                    kw["collect_frac"] = float(f[1:])
                elif f.startswith("d"):
                    kw["deadline"] = float(f[1:])
                elif f.startswith("p"):
                    kw["partitions_per_worker"] = int(f[1:])
                else:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"bad policy field {f!r} in {part!r}; want cN / fFRAC "
                    "/ dSECS / pN"
                ) from None
        out.append(PolicySpec(fields[0], **kw))
    return tuple(out)


def parse_regimes(text: str) -> tuple:
    """'exp:0.5,heavytail:1.2,adversary:5,targeted:5:2,trace:PATH' ->
    RegimeSpecs. Forms: exp[:MEAN], heavytail[:ALPHA[:MEAN]],
    adversary[:SLOWDOWN[:WORKER]], targeted[:SLOWDOWN[:GROUP]],
    trace:PATH. A '+cSECS' suffix on any form adds per-round compute
    time; '+cSECSxslots' scales it by each worker's slot count (the
    faithful redundant-compute price)."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        compute_time, compute_slots = 0.0, False
        if "+c" in part:
            part, _, suffix = part.partition("+c")
            if suffix.endswith("xslots"):
                compute_slots = True
                suffix = suffix[: -len("xslots")]
            try:
                compute_time = float(suffix)
            except ValueError:
                raise ValueError(
                    f"bad compute suffix '+c{suffix}' (want +cSECS or "
                    "+cSECSxslots)"
                ) from None
        fields = part.split(":")
        kind = fields[0]
        kw: dict = {
            "compute_time": compute_time, "compute_slots": compute_slots,
        }
        try:
            if kind == "exp":
                if len(fields) > 1:
                    kw["mean"] = float(fields[1])
            elif kind == "heavytail":
                if len(fields) > 1:
                    kw["alpha"] = float(fields[1])
                if len(fields) > 2:
                    kw["mean"] = float(fields[2])
            elif kind == "adversary":
                if len(fields) > 1:
                    kw["slowdown"] = float(fields[1])
                if len(fields) > 2:
                    kw["worker"] = int(fields[2])
            elif kind == "targeted":
                if len(fields) > 1:
                    kw["slowdown"] = float(fields[1])
                if len(fields) > 2:
                    kw["group"] = int(fields[2])
            elif kind == "trace":
                if len(fields) < 2 or not fields[1]:
                    raise ValueError
                kw["trace"] = ":".join(fields[1:])  # paths may hold ':'
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad regime entry {part!r}; forms: exp[:MEAN], "
                "heavytail[:ALPHA[:MEAN]], adversary[:SLOWDOWN[:WORKER]], "
                "targeted[:SLOWDOWN[:GROUP]], trace:PATH"
            ) from None
        out.append(RegimeSpec(kind=kind, **kw))
    if not out:
        raise ValueError(f"no regimes in {text!r}")
    return tuple(out)


def parse_ints(text: str) -> tuple:
    try:
        return tuple(int(v) for v in text.split(",") if v.strip())
    except ValueError:
        raise ValueError(
            f"want a comma-separated int list, got {text!r}"
        ) from None
