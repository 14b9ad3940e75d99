"""registry-dispatch: scheme behavior lives in the registry, nowhere else.

The port of erasurehead_tpu/analysis/dispatch.py. A scheme is one
SchemeDescriptor in the declarative registry
(erasurehead_tpu_torch/schemes/), and every consumer — trainer,
collection, failures, CLI, serve packing — looks behavior up via
``schemes.get()``. A grep for ``if ... scheme ==`` lines misses every
other dispatch form; this checker walks the AST.

Outside ``schemes/``, flags:

  - **comparison dispatch** — ``scheme``-valued expressions (``scheme``,
    ``cfg.scheme``, ``arm.scheme``, ``...scheme.value``) compared with
    ``==``/``!=``/``in``/``not in`` against hard-coded values (string
    constants or ``Scheme.<MEMBER>`` attributes), in ANY expression
    position: if/elif, ternaries, comprehension filters, boolean
    operands, assert conditions — the forms the old grep missed.
    Comparing two scheme VALUES (``a.scheme == b.scheme``) is not
    dispatch and stays legal (cohort-compatibility checks).
  - **dict-keyed dispatch** — subscripting with a scheme-valued key
    (``TABLE[cfg.scheme.value]``): a lookup table is an if/elif spine in
    data clothing, and one that silently KeyErrors for every scheme
    registered after it was written.
  - **match dispatch** — ``match scheme:`` with constant-valued cases.

Capability queries through the registry (``schemes.get(s).partial``) are
the sanctioned replacement and are untouched.
"""

from __future__ import annotations

import ast

from erasurehead_tpu_torch.analysis.core import Finding, SourceModule, dotted

CHECKER = "registry-dispatch"

_OPS = (ast.Eq, ast.NotEq, ast.In, ast.NotIn)


def _scheme_valued(expr) -> bool:
    """Does this expression carry a scheme value? ``scheme``,
    ``*.scheme``, and either with a trailing ``.value``."""
    name = dotted(expr)
    if name is None:
        return False
    parts = name.split(".")
    if parts[-1] == "value" and len(parts) > 1:
        parts = parts[:-1]
    return parts[-1] == "scheme"


def _hardcoded(expr) -> bool:
    """A hard-coded scheme label: a string constant, a tuple/list/set of
    them, or a ``Scheme.<MEMBER>`` enum attribute."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return True
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return any(_hardcoded(e) for e in expr.elts)
    name = dotted(expr)
    return name is not None and "Scheme." in f".{name}."


def check(mod: SourceModule, context) -> list:
    if "/schemes/" in mod.path.replace("\\", "/"):
        return []
    findings = []

    def flag(node, what):
        findings.append(
            Finding(
                CHECKER,
                mod.path,
                node.lineno,
                node.col_offset,
                f"{what} outside erasurehead_tpu_torch/schemes/; scheme behavior "
                "belongs on its SchemeDescriptor (schemes.get(...))",
            )
        )

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if any(_scheme_valued(s) for s in sides) and any(
                _hardcoded(s) for s in sides
            ) and any(isinstance(op, _OPS) for op in node.ops):
                flag(node, "hard-coded scheme comparison")
        elif isinstance(node, ast.Subscript) and _scheme_valued(node.slice):
            flag(node, "dict-keyed scheme dispatch")
        elif isinstance(node, ast.Match) and _scheme_valued(node.subject):
            if any(
                isinstance(p, ast.MatchValue) and _hardcoded(p.value)
                for case in node.cases
                for p in ast.walk(case.pattern)
            ):
                flag(node, "match-statement scheme dispatch")
    return findings
