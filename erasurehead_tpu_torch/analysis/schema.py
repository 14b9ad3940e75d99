"""event-schema: every emit() call site matches obs/events.SCHEMA.

The port of erasurehead_tpu/analysis/schema.py, checked against the
port's own obs/events.SCHEMA, TUNE_RACES / TUNE_SOURCES and
tune/__init__.TUNE_CHOICES. The event log's value is that its records can
be trusted without running the producer: the validator, the report
renderer, the journal resume map and the serve per-tenant accounting all
key on SCHEMA's required fields. A drifted emit site (a new record type, a
renamed field) is otherwise caught only at runtime by ``validate_lines``
— on whichever run first exercises the site. This checker moves that to
lint time, and cross-checks the schema surfaces against each other.

Rules:

  - **emit sites** (any module): for ``<events alias>.emit("type", ...)``
    and bare ``emit(...)`` imported from obs.events, the type string must
    be a SCHEMA key and every required field for that type must be among
    the keyword arguments (a ``**splat`` waives the field check — the
    payload is dynamic — but never the known-type check). For other
    ``*.emit(...)`` callees (logger objects), the same field check
    applies whenever the first argument is a SCHEMA type string.
  - **validator drift** (modules defining both ``SCHEMA`` and
    ``validate_lines``, i.e. obs/events.py and fixtures shaped like it):
    every record-type string literal the validator compares ``rtype``
    against must exist in that module's own SCHEMA.
  - **CLI wrapper drift**: a ``validate_events.py`` must delegate to
    ``obs.events.validate_file``/``validate_lines``, and it — or any
    other module that delegates to them (the port's obs/report.py behind
    ``cli report --validate``) — must not carry an independent
    record-type table (in validate_events.py any dict literal with 2+
    SCHEMA-type string keys; elsewhere such a dict whose values are all
    field-name tuples, SCHEMA's own shape, so a renderer's per-type
    accumulators are not mistaken for one): the whole point of the shared
    validator is that the two can never drift.
  - **tune vocabulary**: an ``emit("tune", ...)`` site whose
    ``race``/``source`` keyword is a string constant must name a member
    of ``obs/events.TUNE_RACES``/``TUNE_SOURCES``, and any module
    declaring a top-level ``TUNE_CHOICES`` dict (tune/__init__.py) must
    keep its keys equal to ``TUNE_RACES``.
"""

from __future__ import annotations

import ast
import os

from erasurehead_tpu_torch.analysis.core import Finding, SourceModule, dotted

CHECKER = "event-schema"


def parse_schema(source: str) -> dict:
    """type -> required-field tuple from an obs/events.py-shaped module
    (the top-level ``SCHEMA`` dict literal), parsed without importing."""
    tree = ast.parse(source)
    for node in tree.body:
        target = None
        if isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            target, value = node.target.id, node.value
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
        ):
            target, value = node.targets[0].id, node.value
        if target != "SCHEMA" or not isinstance(value, ast.Dict):
            continue
        schema = {}
        for key, val in zip(value.keys, value.values):
            if not (
                isinstance(key, ast.Constant) and isinstance(key.value, str)
            ):
                continue
            fields = tuple(
                e.value
                for e in getattr(val, "elts", [])
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            )
            schema[key.value] = fields
        return schema
    return {}


def parse_tune_vocab(source: str) -> tuple:
    """(TUNE_RACES, TUNE_SOURCES) string tuples from an obs/events.py-
    shaped module, parsed without importing; empty tuples when absent."""
    tree = ast.parse(source)
    vocab = {"TUNE_RACES": (), "TUNE_SOURCES": ()}
    for node in tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in vocab
        ):
            continue
        vocab[node.targets[0].id] = tuple(
            e.value
            for e in getattr(node.value, "elts", [])
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        )
    return vocab["TUNE_RACES"], vocab["TUNE_SOURCES"]


def _parse_tune_choices_keys(mod: SourceModule):
    """Keys of a top-level ``TUNE_CHOICES`` dict literal (the autotune
    plane's own race vocabulary), or None when the module has none."""
    for node in mod.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "TUNE_CHOICES"
            and isinstance(node.value, ast.Dict)
        ):
            keys = tuple(
                k.value
                for k in node.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            )
            return node, keys
    return None


def _module_defines_validator(mod: SourceModule) -> bool:
    return "validate_lines" in mod.module_scope.functions


def _emit_type(call: ast.Call):
    """The event-type argument when it is a string constant, else None."""
    if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
        call.args[0].value, str
    ):
        return call.args[0].value
    for kw in call.keywords:
        if kw.arg == "type" and isinstance(kw.value, ast.Constant) and (
            isinstance(kw.value.value, str)
        ):
            return kw.value.value
    return None


def _check_emit_sites(
    mod: SourceModule, schema: dict, findings: list, tune_vocab=((), ())
):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        is_events_call = False
        if name == "emit":
            # a lexically-resolvable local helper named emit is not the
            # event sink (train/artifacts.py's artifact writer)
            if mod.module_scope.resolve_function("emit") is not None:
                continue
            is_events_call = mod.emit_is_events
            if not is_events_call:
                continue
        elif name.endswith(".emit"):
            base = name[: -len(".emit")]
            is_events_call = base in mod.events_aliases
        else:
            continue
        etype = _emit_type(node)
        if etype is None:
            continue  # dynamic type expression; runtime validation owns it
        if etype not in schema:
            if is_events_call:
                findings.append(
                    Finding(
                        CHECKER, mod.path, node.lineno, node.col_offset,
                        f"emit of unknown event type {etype!r}; "
                        "obs/events.SCHEMA declares "
                        f"{sorted(schema) if schema else 'no types'} — "
                        "add the type to SCHEMA first",
                    )
                )
            continue
        kwargs = {kw.arg for kw in node.keywords if kw.arg is not None}
        has_splat = any(kw.arg is None for kw in node.keywords)
        missing = [f for f in schema[etype] if f not in kwargs]
        if missing and not has_splat:
            findings.append(
                Finding(
                    CHECKER, mod.path, node.lineno, node.col_offset,
                    f"emit({etype!r}) missing required field(s) "
                    f"{missing}; SCHEMA declares {list(schema[etype])}",
                )
            )
        if etype == "tune":
            _check_tune_emit(mod, node, tune_vocab, findings)


def _check_tune_emit(
    mod: SourceModule, node: ast.Call, tune_vocab, findings: list
):
    """Constant ``race``/``source`` kwargs on a tune emit must be members
    of TUNE_RACES/TUNE_SOURCES — the validator's membership check at
    lint time (dynamic values stay runtime-validated)."""
    races, sources = tune_vocab
    for kw in node.keywords:
        if kw.arg not in ("race", "source") or not (
            isinstance(kw.value, ast.Constant)
            and isinstance(kw.value.value, str)
        ):
            continue
        vocab, table = (
            (races, "TUNE_RACES") if kw.arg == "race"
            else (sources, "TUNE_SOURCES")
        )
        if vocab and kw.value.value not in vocab:
            findings.append(
                Finding(
                    CHECKER, mod.path, kw.value.lineno,
                    kw.value.col_offset,
                    f"emit('tune') {kw.arg}={kw.value.value!r} is not in "
                    f"obs/events.{table} {list(vocab)} — extend the "
                    "vocabulary before emitting it",
                )
            )


def _check_tune_choices_drift(
    mod: SourceModule, tune_vocab, findings: list
):
    """A module declaring the autotune plane's TUNE_CHOICES must keep its
    keys equal to obs/events.TUNE_RACES — the two vocabulary surfaces
    (decision plane and event schema) may never drift."""
    races, _ = tune_vocab
    if not races:
        return
    parsed = _parse_tune_choices_keys(mod)
    if parsed is None:
        return
    node, keys = parsed
    if set(keys) != set(races):
        findings.append(
            Finding(
                CHECKER, mod.path, node.lineno, node.col_offset,
                f"TUNE_CHOICES races {sorted(keys)} != obs/events."
                f"TUNE_RACES {sorted(races)} — the decision plane and "
                "the event schema declare different race vocabularies",
            )
        )


def _check_validator_drift(mod: SourceModule, findings: list):
    own_schema = parse_schema(mod.source)
    if not own_schema:
        return
    validator = mod.module_scope.functions.get("validate_lines")
    if validator is None:
        return
    for node in ast.walk(validator):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        if not any(
            isinstance(s, ast.Name) and s.id == "rtype" for s in sides
        ):
            continue
        for side in sides:
            literals = (
                [side]
                if isinstance(side, ast.Constant)
                else list(getattr(side, "elts", []))
            )
            for lit in literals:
                if isinstance(lit, ast.Constant) and isinstance(
                    lit.value, str
                ) and lit.value not in own_schema:
                    findings.append(
                        Finding(
                            CHECKER, mod.path, lit.lineno, lit.col_offset,
                            f"validate_lines checks record type "
                            f"{lit.value!r} which SCHEMA does not declare "
                            "— schema/validator drift",
                        )
                    )


def _field_table(node: ast.Dict) -> bool:
    """Is every value of this dict literal a tuple/list of strings?"""
    return all(
        isinstance(v, (ast.Tuple, ast.List))
        and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in v.elts
        )
        for v in node.values
    )


def _check_cli_wrapper(mod: SourceModule, schema: dict, findings: list):
    delegates = any(
        isinstance(node, (ast.Name, ast.Attribute))
        and (
            getattr(node, "id", None) in ("validate_file", "validate_lines")
            or getattr(node, "attr", None)
            in ("validate_file", "validate_lines")
        )
        for node in ast.walk(mod.tree)
    )
    wrapper = os.path.basename(mod.path) == "validate_events.py"
    if not wrapper and (
        not delegates
        or _module_defines_validator(mod)
        or "/analysis/" in mod.path.replace("\\", "/")
    ):
        return
    if not delegates:
        findings.append(
            Finding(
                CHECKER, mod.path, 1, 0,
                "validate_events.py does not delegate to obs.events."
                "validate_file/validate_lines; an independent validator "
                "drifts from SCHEMA",
            )
        )
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Dict):
            type_keys = [
                k.value
                for k in node.keys
                if isinstance(k, ast.Constant)
                and isinstance(k.value, str)
                and k.value in schema
            ]
            # beyond validate_events.py, only a SCHEMA-shaped table counts
            # (type -> a tuple/list of field names): a renderer's
            # per-type accumulators are not a second validator
            if len(type_keys) >= 2 and (wrapper or _field_table(node)):
                findings.append(
                    Finding(
                        CHECKER, mod.path, node.lineno, node.col_offset,
                        f"independent record-type table {sorted(type_keys)} "
                        "in a module that fronts the validator; the schema "
                        "lives in obs/events.SCHEMA only",
                    )
                )


def check(mod: SourceModule, context) -> list:
    findings: list = []
    own_schema = parse_schema(mod.source)
    schema = own_schema or context.schema
    tune_vocab = (
        parse_tune_vocab(mod.source)
        if own_schema
        else (context.tune_races, context.tune_sources)
    )
    if schema:
        _check_emit_sites(mod, schema, findings, tune_vocab)
    _check_validator_drift(mod, findings)
    _check_tune_choices_drift(mod, tune_vocab, findings)
    if context.schema:
        _check_cli_wrapper(mod, context.schema, findings)
    return findings
