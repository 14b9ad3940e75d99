"""Expected-time-to-target surfaces: the what-if engine's artifact.

The port's copy of erasurehead_tpu/whatif/surface.py: a surface saved by
either package loads in the other, byte for byte. The engine that builds
surfaces (spec, sampler, engine) is not ported yet; the port reads saved
surfaces, e.g. for ``--adapt-priors``.

A :class:`Surface` is the reduced form of a Monte-Carlo grid run — one
row per grid point carrying the point's coordinates, its feasibility
verdict (infeasible points keep the validator's reason), and the
reductions over the point's seed axis: expected time-to-target, reach
fraction, simulated seconds per round, decode-error mean, final-loss
mean. It is the ErasureHead Fig. 4-6 family as a data object, and the
substrate both downstream consumers read:

  - :meth:`adapt_priors` turns rows into cold-start arm values for the
    adapt/ bandit (the controller's ``time_error`` reward computed from
    simulated quantities instead of zeros);
  - :meth:`eta` quotes an admission-time expected-time-to-target for a
    RunConfig (the JAX package's serve/admission.EtaQuoter reads it).

Persistence is DETERMINISTIC byte-for-byte: ``surface_rows.jsonl`` is
the canonical artifact (a header record then one row per line, stable
key order, repr-round-trip floats) and ``surface.npz`` the columnar
mirror (written through a fixed-timestamp zip so identical surfaces are
identical files). Rerunning an identical spec therefore rehydrates the
surface bitwise.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zipfile
from typing import Optional

import numpy as np

#: stable row field order (the JSONL key order and the npz column set)
ROW_FIELDS = (
    "label", "scheme", "n_workers", "n_stragglers", "num_collect",
    "deadline", "decode", "regime", "pipeline_depth", "feasible",
    "reason", "n_seeds",
    "n_diverged", "reach_fraction", "expected_time_to_target",
    "time_to_target_std", "sim_time_per_round", "decode_error_mean",
    "final_loss_mean",
)

#: numeric columns mirrored into surface.npz (None -> NaN)
_NPZ_COLUMNS = (
    "n_workers", "n_stragglers", "num_collect", "deadline",
    "pipeline_depth", "n_seeds",
    "n_diverged", "reach_fraction", "expected_time_to_target",
    "time_to_target_std", "sim_time_per_round", "decode_error_mean",
    "final_loss_mean",
)

ROWS_FILENAME = "surface_rows.jsonl"
NPZ_FILENAME = "surface.npz"


def _write_deterministic_npz(path: str, arrays: dict) -> None:
    """np.load-compatible .npz with pinned zip metadata (fixed timestamp,
    stored not deflated, sorted member order) — identical arrays produce
    identical bytes, which is what lets a rerun be compared bitwise at
    the file level."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(
                buf, np.asarray(arrays[name]), allow_pickle=False
            )
            info = zipfile.ZipInfo(
                name + ".npy", date_time=(1980, 1, 1, 0, 0, 0)
            )
            zf.writestr(info, buf.getvalue())


@dataclasses.dataclass
class Surface:
    """One reduced what-if grid (module docstring)."""

    spec_payload: dict
    spec_hash: str
    target_loss: Optional[float]
    rows: list
    #: engine-run statistics (trajectory counts, wall seconds) — runtime
    #: telemetry only, deliberately EXCLUDED from the saved artifact so
    #: the bitwise-rehydration contract covers science, not clocks
    stats: Optional[dict] = None

    # ---- persistence -----------------------------------------------------

    def save(self, out_dir: str) -> dict:
        """Write ``surface_rows.jsonl`` + ``surface.npz`` under
        ``out_dir``; returns the paths. Deterministic bytes (module
        docstring)."""
        os.makedirs(out_dir, exist_ok=True)
        rows_path = os.path.join(out_dir, ROWS_FILENAME)
        npz_path = os.path.join(out_dir, NPZ_FILENAME)
        header = {
            "type": "whatif_surface",
            "spec_hash": self.spec_hash,
            "target_loss": self.target_loss,
            "spec": self.spec_payload,
        }
        lines = [json.dumps(header, sort_keys=True)]
        for row in self.rows:
            lines.append(
                json.dumps(
                    {k: row.get(k) for k in ROW_FIELDS}, sort_keys=False
                )
            )
        with open(rows_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        arrays: dict = {
            "labels": np.asarray([r["label"] for r in self.rows]),
            "schemes": np.asarray([r["scheme"] for r in self.rows]),
            "regimes": np.asarray([r["regime"] for r in self.rows]),
            "feasible": np.asarray(
                [bool(r["feasible"]) for r in self.rows]
            ),
        }
        for col in _NPZ_COLUMNS:
            arrays[col] = np.asarray(
                [
                    float(r[col]) if r.get(col) is not None else np.nan
                    for r in self.rows
                ],
                dtype=np.float64,
            )
        _write_deterministic_npz(npz_path, arrays)
        return {"rows": rows_path, "npz": npz_path}

    @classmethod
    def load(cls, out_dir: str) -> "Surface":
        """Rehydrate a saved surface from its JSONL rows (the canonical
        artifact; the npz is the columnar mirror)."""
        rows_path = os.path.join(out_dir, ROWS_FILENAME)
        with open(rows_path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            raise ValueError(f"empty surface artifact {rows_path!r}")
        header = json.loads(lines[0])
        if header.get("type") != "whatif_surface":
            raise ValueError(
                f"{rows_path!r} is not a what-if surface artifact "
                f"(header type {header.get('type')!r})"
            )
        rows = [json.loads(ln) for ln in lines[1:]]
        return cls(
            spec_payload=header.get("spec") or {},
            spec_hash=header.get("spec_hash") or "",
            target_loss=header.get("target_loss"),
            rows=rows,
        )

    @staticmethod
    def saved_hash(out_dir: str) -> Optional[str]:
        """The spec hash of the surface saved under ``out_dir`` (None if
        no readable artifact) — the engine's cheap rehydration probe."""
        rows_path = os.path.join(out_dir, ROWS_FILENAME)
        try:
            with open(rows_path) as f:
                header = json.loads(f.readline())
        except (OSError, json.JSONDecodeError):
            return None
        if header.get("type") != "whatif_surface":
            return None
        return header.get("spec_hash")

    # ---- queries ---------------------------------------------------------

    def feasible_rows(self) -> list:
        return [r for r in self.rows if r.get("feasible")]

    def lookup(
        self,
        scheme: str,
        n_workers: Optional[int] = None,
        n_stragglers: Optional[int] = None,
        num_collect: Optional[int] = None,
        deadline: Optional[float] = None,
        regime: Optional[str] = None,
    ) -> Optional[dict]:
        """Best-matching feasible row for a policy coordinate: exact
        scheme match required, then each optional coordinate narrows the
        candidate set only when it actually discriminates (a surface
        swept over one regime answers for any regime). None = the
        surface cannot speak for this policy."""
        cands = [
            r for r in self.feasible_rows() if r["scheme"] == scheme
        ]
        for key, want in (
            ("n_workers", n_workers),
            ("n_stragglers", n_stragglers),
            ("num_collect", num_collect),
            ("deadline", deadline),
            ("regime", regime),
        ):
            if want is None:
                continue
            narrowed = [r for r in cands if r.get(key) == want]
            if narrowed:
                cands = narrowed
        if not cands:
            return None
        # deterministic tie-break: the best (smallest) expected time wins,
        # unreached rows last, then label order
        def rank(r):
            t = r.get("expected_time_to_target")
            return (t is None, t if t is not None else 0.0, r["label"])

        return min(cands, key=rank)

    def eta(self, cfg, regime: Optional[str] = None) -> Optional[float]:
        """Expected time-to-target (simulated seconds) the surface
        predicts for a RunConfig's policy coordinate — the serve
        daemon's admission-time quote. None when the surface has no
        matching feasible row or the matched row never reached target."""
        row = self.lookup(
            scheme=cfg.scheme.value,
            n_workers=cfg.n_workers,
            n_stragglers=cfg.n_stragglers,
            num_collect=cfg.num_collect,
            deadline=cfg.deadline,
            regime=regime,
        )
        if row is None:
            return None
        return row.get("expected_time_to_target")

    def adapt_priors(
        self,
        arms,
        n_workers: Optional[int] = None,
        n_stragglers: Optional[int] = None,
        regime: Optional[str] = None,
        error_penalty: float = 25.0,
    ) -> dict:
        """Cold-start arm values for the adapt/ bandit, computed from the
        surface's simulated quantities in the controller's own
        ``time_error`` reward units: ``-(sim seconds per round) * (1 +
        error_penalty * decode_error_mean^2)``. Arms without a matching
        feasible row are omitted (the controller warm-up still visits
        them once). Returns {arm label: prior value}."""
        priors: dict = {}
        for arm in arms:
            row = self.lookup(
                scheme=arm.scheme,
                n_workers=n_workers,
                n_stragglers=n_stragglers,
                num_collect=arm.num_collect,
                deadline=arm.deadline,
                regime=regime,
            )
            if row is None or row.get("sim_time_per_round") is None:
                continue
            err = float(row.get("decode_error_mean") or 0.0)
            priors[arm.label] = -float(row["sim_time_per_round"]) * (
                1.0 + error_penalty * err * err
            )
        return priors

    # ---- rendering -------------------------------------------------------

    def crossover(
        self, scheme_a: str, scheme_b: str, axis: str = "regime"
    ) -> dict:
        """Where does the winner flip between two schemes along a grid
        axis? Returns {"axis", "points": [(axis value, tta_a, tta_b,
        winner), ...], "crossover": first axis value where the winner
        changed (None = no flip)} — the AGC-vs-exact crossover check.
        Axis values keep enumeration (spec) order; expected times average
        over the rows sharing the axis value (None = never reached, which
        loses to any finite time)."""
        if axis not in ("regime", "n_stragglers", "n_workers"):
            raise ValueError(
                f"crossover axis must be regime/n_stragglers/n_workers, "
                f"got {axis!r}"
            )

        def times_by_axis(scheme):
            out: dict = {}
            for r in self.feasible_rows():
                if r["scheme"] != scheme:
                    continue
                out.setdefault(r[axis], []).append(
                    r.get("expected_time_to_target")
                )
            return {
                k: (
                    float(np.mean([t for t in v if t is not None]))
                    if any(t is not None for t in v)
                    else None
                )
                for k, v in out.items()
            }

        ta, tb = times_by_axis(scheme_a), times_by_axis(scheme_b)
        axis_values = [
            r[axis]
            for r in self.rows
            if r[axis] in ta and r[axis] in tb
        ]
        seen: list = []
        for v in axis_values:
            if v not in seen:
                seen.append(v)
        points = []
        crossover = None
        prev_winner = None
        for v in seen:
            a, b = ta[v], tb[v]
            if a is None and b is None:
                winner = None
            elif b is None or (a is not None and a <= b):
                winner = scheme_a
            else:
                winner = scheme_b
            points.append((v, a, b, winner))
            if (
                winner is not None
                and prev_winner is not None
                and winner != prev_winner
                and crossover is None
            ):
                crossover = v
            if winner is not None:
                prev_winner = winner
        return {
            "axis": axis,
            "scheme_a": scheme_a,
            "scheme_b": scheme_b,
            "points": points,
            "crossover": crossover,
        }

    def format_crossover_table(
        self, scheme_a: str, scheme_b: str, axis: str = "regime"
    ) -> str:
        x = self.crossover(scheme_a, scheme_b, axis=axis)

        def fmt(t):
            return f"{t:10.3f}" if t is not None else "         -"

        header = (
            f"{x['axis']:>14s} {scheme_a:>12s} {scheme_b:>12s}  winner"
        )
        lines = [header, "-" * len(header)]
        for v, a, b, winner in x["points"]:
            mark = " <- crossover" if v == x["crossover"] else ""
            lines.append(
                f"{str(v):>14s} {fmt(a)} {fmt(b)}  "
                f"{winner or '-'}{mark}"
            )
        return "\n".join(lines)

    def format_table(self) -> str:
        header = (
            f"{'point':40s} {'t->target':>10s} {'reach':>6s} "
            f"{'s/round':>8s} {'dec err':>9s} {'final loss':>11s}"
        )
        lines = [header, "-" * len(header)]
        for r in self.rows:
            if not r.get("feasible"):
                lines.append(
                    f"{r['label']:40s} infeasible: {r.get('reason')}"
                )
                continue
            t = r.get("expected_time_to_target")
            lines.append(
                f"{r['label']:40s} "
                + (f"{t:10.3f}" if t is not None else "         -")
                + f" {r.get('reach_fraction', 0.0):6.2f}"
                + f" {r.get('sim_time_per_round', 0.0):8.4f}"
                + (
                    f" {r['decode_error_mean']:9.5f}"
                    if r.get("decode_error_mean") is not None
                    else "         -"
                )
                + (
                    f" {r['final_loss_mean']:11.6f}"
                    if r.get("final_loss_mean") is not None
                    else "           -"
                )
            )
        return "\n".join(lines)
