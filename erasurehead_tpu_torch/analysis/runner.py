"""``python -m erasurehead_tpu_torch.cli lint``: load files, run
checkers, render.

The port of erasurehead_tpu/analysis/runner.py, with its five checkers.
Deterministic by construction (the tests pin it
byte-for-byte): files are walked in sorted order, findings sort on (path,
line, col, checker, message), and the report carries no timestamps —
wall time goes to stderr only. Pure stdlib + AST: no torch import
anywhere on this path.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
import time
from typing import Iterable, Optional

from erasurehead_tpu_torch.analysis import (
    dispatch,
    donation,
    purity,
    schema,
    signature,
)
from erasurehead_tpu_torch.analysis.core import (
    Finding,
    SourceModule,
    apply_suppressions,
)

#: checker name -> check(module, context) -> [Finding]; registration order
#: is stable but reports sort findings, so order never shows
CHECKERS = {
    purity.CHECKER: purity.check,
    signature.CHECKER: signature.check,
    dispatch.CHECKER: dispatch.check,
    schema.CHECKER: schema.check,
    donation.CHECKER: donation.check,
}

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class LintContext:
    """Cross-file knowledge the checkers share: the RunConfig field and
    static-signature sets (signature-completeness) and the canonical
    event SCHEMA (event-schema). Parsed once per lint run from the
    package's own sources; tests inject doctored sources to exercise
    drift without touching the shipped tree."""

    config_fields: frozenset
    signature_keys: frozenset
    schema: dict
    strict: bool = False
    # autotune vocab: TUNE_RACES/TUNE_SOURCES from the same schema
    # source, for the tune-emit membership + TUNE_CHOICES drift checks
    # (empty tuples disable them — doctored test sources)
    tune_races: tuple = ()
    tune_sources: tuple = ()
    # donation-safety: function name -> (positions, keyword names) of the
    # package's functions marked ``@donates`` (train/graphs.donates)
    donating: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load(
        cls,
        config_source: Optional[str] = None,
        schema_source: Optional[str] = None,
        strict: bool = False,
    ) -> "LintContext":
        if config_source is None:
            with open(os.path.join(_PKG_ROOT, "utils", "config.py")) as f:
                config_source = f.read()
        if schema_source is None:
            with open(os.path.join(_PKG_ROOT, "obs", "events.py")) as f:
                schema_source = f.read()
        fields, keys = signature.parse_config_info(config_source)
        races, sources = schema.parse_tune_vocab(schema_source)
        donating = {}
        for path in iter_python_files([_PKG_ROOT]):
            with open(path, encoding="utf-8") as f:
                source = f.read()
            if "donates(" in source:
                donating.update(donation.collect_donating(ast.parse(source)))
        return cls(
            config_fields=frozenset(fields),
            signature_keys=frozenset(keys),
            schema=schema.parse_schema(schema_source),
            strict=strict,
            tune_races=races,
            tune_sources=sources,
            donating=donating,
        )


def iter_python_files(paths: Iterable[str]):
    """Expand files/directories into a sorted, de-duplicated .py list."""
    out = set()
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(
                    d for d in dirnames if d != "__pycache__"
                )
                for fn in filenames:
                    if fn.endswith(".py"):
                        out.add(os.path.join(dirpath, fn))
        elif path.endswith(".py"):
            out.add(path)
    return sorted(out)


@dataclasses.dataclass
class LintReport:
    findings: list  # sorted, suppressions applied
    n_files: int

    @property
    def unsuppressed(self) -> list:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list:
        return [f for f in self.findings if f.suppressed]

    def suppression_counts(self) -> dict:
        counts: dict = {}
        for f in self.suppressed:
            counts[f.checker] = counts.get(f.checker, 0) + 1
        return dict(sorted(counts.items()))

    def render(self, strict: bool = False) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"{len(self.unsuppressed)} finding(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{self.n_files} file(s) checked"
        )
        if strict:
            counts = self.suppression_counts()
            if counts:
                lines.append("suppressions by checker:")
                lines.extend(f"  {k}: {v}" for k, v in counts.items())
            else:
                lines.append("suppressions by checker: none")
        return "\n".join(lines) + "\n"


def lint_paths(
    paths: Iterable[str],
    checkers: Optional[Iterable[str]] = None,
    context: Optional[LintContext] = None,
) -> LintReport:
    """Run the (selected) checkers over ``paths``; the library entry the
    CLI and the tests share."""
    ctx = context if context is not None else LintContext.load()
    selected = list(CHECKERS) if checkers is None else list(checkers)
    unknown = [c for c in selected if c not in CHECKERS]
    if unknown:
        raise ValueError(
            f"unknown checker(s) {unknown}; known: {sorted(CHECKERS)}"
        )
    findings: list = []
    modules: dict = {}
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            mod = SourceModule(path, source)
        except (OSError, SyntaxError, ValueError) as e:
            findings.append(
                Finding(
                    "parse", path, getattr(e, "lineno", 1) or 1, 0,
                    f"cannot analyze: {e}",
                )
            )
            continue
        modules[path] = mod
        for name in selected:
            findings.extend(CHECKERS[name](mod, ctx))
    return LintReport(
        findings=apply_suppressions(findings, modules),
        n_files=len(modules),
    )


def main(argv: Optional[list] = None) -> int:
    """``python -m erasurehead_tpu_torch.cli lint [--strict] [--checker
    NAME ...] [paths]``.

    Exit 0: no unsuppressed findings; 1: findings; 2: usage error."""
    argv = list(sys.argv[1:] if argv is None else argv)
    strict = False
    checkers: Optional[list] = None
    paths: list = []
    it = iter(argv)
    for arg in it:
        if arg == "--strict":
            strict = True
        elif arg == "--checker":
            name = next(it, None)
            if name is None:
                print("lint: --checker needs a name", file=sys.stderr)
                return 2
            checkers = (checkers or []) + [name]
        elif arg in ("-h", "--help"):
            print(
                "usage: python -m erasurehead_tpu_torch.cli lint [--strict] "
                "[--checker NAME ...] [paths]\n"
                f"checkers: {', '.join(sorted(CHECKERS))}\n"
                "default path: the installed erasurehead_tpu_torch package",
            )
            return 0
        elif arg.startswith("-"):
            print(f"lint: unknown flag {arg!r}", file=sys.stderr)
            return 2
        else:
            paths.append(arg)
    if not paths:
        paths = [_PKG_ROOT]
    t0 = time.perf_counter()
    try:
        report = lint_paths(paths, checkers=checkers)
    except ValueError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    sys.stdout.write(report.render(strict=strict))
    print(
        f"lint: {report.n_files} file(s) in "
        f"{time.perf_counter() - t0:.2f}s",
        file=sys.stderr,
    )
    return 1 if report.unsuppressed else 0
