"""Shared AST infrastructure for the port's lint checkers.

The port of erasurehead_tpu/analysis/core.py, with its roots restated for
the port's idioms. The port's correctness rests on a handful of contracts
that no type system sees: a body run under ``torch.func.vmap`` /
``torch.func.grad`` (or inside a ``torch.autograd.Function``) runs once for
the whole batch, so a host effect there (an event, a metrics counter, a
clock read, a host RNG draw) is counted or drawn once where the reader
expects one per trajectory; the closures a trajectory cohort shares must
not read config fields outside the cohort signature; scheme dispatch must
go through the registry; event payloads must match obs/events.SCHEMA. Each
checker in this package enforces one of those contracts by walking module
ASTs — no imports of the checked code, no torch — so the whole tree lints
in about a second.

This module provides what every checker needs:

  - :class:`SourceModule` — one parsed file: AST, lexical scopes
    (module / class / function) with statement-level def indexing, import
    aliases, and suppression comments;
  - traced-call-graph resolution (:func:`SourceModule.traced_functions`) —
    find the function bodies passed to ``torch.func.vmap`` /
    ``torch.vmap`` / ``torch.func.grad`` / ``torch.func.grad_and_value``
    (as arguments, or through ``partial``), the ``forward`` and
    ``backward`` of ``torch.autograd.Function`` subclasses, and the local
    functions reachable from them by direct call;
  - :func:`dotted` — render a callee/attribute chain as a dotted string
    ("obs_events.emit", "REGISTRY.counter().inc") for pattern matching;
  - suppression handling — ``# lint: allow(<checker>): <reason>`` on (or
    directly above) a line, ``# lint: allow-file(<checker>): <reason>``
    anywhere for the whole file. A suppression without a reason string is
    itself a finding: every whitelisted exception must say why.

Static resolution is deliberately conservative: a callee that is a local
``def`` (or a ``self.`` method of the enclosing class) is followed;
callables passed in as VALUES (``grad_fn`` arguments, closures bound by
assignment) are not — the factories that build them are covered where
they are defined.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Iterable, Iterator, Optional

#: callables whose first argument becomes a body run once for a whole
#: batch (vmap) or under autodiff (grad) — the roots of the traced call
#: graph. Bare names count where the module imports them from torch.func
#: (or ``vmap`` from torch).
VMAP_NAMES = frozenset({"torch.func.vmap", "torch.vmap", "func.vmap"})
GRAD_NAMES = frozenset(
    {
        "torch.func.grad",
        "func.grad",
        "torch.func.grad_and_value",
        "func.grad_and_value",
    }
)
TRACING_NAMES = VMAP_NAMES | GRAD_NAMES
#: the torch.func functions whose bare imported name is a root
BARE_TRACING = frozenset({"vmap", "grad", "grad_and_value"})
#: base classes whose ``forward``/``backward`` are roots (a bare
#: ``Function`` counts where it is imported from torch.autograd)
AUTOGRAD_FUNCTION_BASES = frozenset(
    {"torch.autograd.Function", "autograd.Function"}
)
AUTOGRAD_FUNCTION_METHODS = ("forward", "backward")
PARTIAL_NAMES = frozenset({"partial", "functools.partial"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit. Sort order = report order (deterministic)."""

    checker: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: Optional[str] = None

    def sort_key(self):
        return (self.path, self.line, self.col, self.checker, self.message)

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"[{self.checker}]{tag} {self.message}"
        )


#: suppression comment grammar (module docstring). The reason after ":" is
#: REQUIRED — an unexplained whitelist entry is a finding of its own.
_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow(?P<scope>-file)?\(\s*(?P<checker>[A-Za-z0-9_-]+)\s*\)"
    r"(?:\s*:\s*(?P<reason>\S.*?))?\s*$"
)


@dataclasses.dataclass
class Suppressions:
    """Parsed ``# lint: allow(...)`` comments of one file."""

    #: checker -> (line, reason) of a file-wide allow
    file_allows: dict
    #: (line, checker) -> reason; a comment-only line also covers line + 1
    line_allows: dict
    #: malformed / reason-less suppression comments -> Finding list
    problems: list

    def lookup(self, checker: str, line: int):
        """(suppressed?, reason) for a finding of ``checker`` at ``line``."""
        if checker in self.file_allows:
            return True, self.file_allows[checker][1]
        for ln in (line, line - 1):
            reason = self.line_allows.get((ln, checker))
            if reason is not None:
                return True, reason
        return False, None


class Scope:
    """One lexical scope: module, class body, or function body.

    ``functions``/``classes`` index statement-level defs (including defs
    nested inside if/for/while/with/try blocks, which are still
    statement-level bindings at runtime)."""

    def __init__(self, node, parent: Optional["Scope"]):
        self.node = node
        self.parent = parent
        self.functions: dict = {}
        self.classes: dict = {}
        #: name -> value expr of statement-level ``name = <expr>`` binds
        #: (callable-tracking only: lambdas, factory calls, aliases)
        self.assigns: dict = {}

    def is_class(self) -> bool:
        return isinstance(self.node, ast.ClassDef)

    def resolve_function(self, name: str):
        """Resolve a bare callee name lexically. Class scopes are skipped
        (Python name resolution skips them; methods need ``self.``)."""
        scope = self
        while scope is not None:
            if not scope.is_class() and name in scope.functions:
                return scope.functions[name]
            scope = scope.parent
        return None

    def resolve_method(self, name: str):
        """Resolve ``self.<name>`` against the nearest enclosing class."""
        scope = self
        while scope is not None:
            if scope.is_class():
                return scope.functions.get(name)
            scope = scope.parent
        return None

    def nearest_function_scope(self) -> Optional["Scope"]:
        scope = self
        while scope is not None and not isinstance(
            scope.node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            scope = scope.parent
        return scope


def _index_statements(body, scope: Scope) -> None:
    """Register statement-level function/class defs of ``body`` into
    ``scope``, descending into compound statements but not into nested
    function/class bodies (those open their own scopes)."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.functions[stmt.name] = stmt
        elif isinstance(stmt, ast.ClassDef):
            scope.classes[stmt.name] = stmt
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
            isinstance(stmt.targets[0], ast.Name)
        ):
            scope.assigns[stmt.targets[0].id] = stmt.value
        elif isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While)):
            _index_statements(stmt.body, scope)
            _index_statements(stmt.orelse, scope)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            _index_statements(stmt.body, scope)
        elif isinstance(stmt, ast.Try):
            _index_statements(stmt.body, scope)
            for handler in stmt.handlers:
                _index_statements(handler.body, scope)
            _index_statements(stmt.orelse, scope)
            _index_statements(stmt.finalbody, scope)


def dotted(node) -> Optional[str]:
    """Render a Name/Attribute/Call chain as a dotted string, or None.

    Calls in the middle of a chain render as ``()``:
    ``REGISTRY.counter("x").inc`` -> ``"REGISTRY.counter().inc"`` — so
    suffix patterns like ``.inc`` still match through chained calls."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    if isinstance(node, ast.Call):
        base = dotted(node.func)
        return None if base is None else f"{base}()"
    return None


def walk_own(node) -> Iterator[ast.AST]:
    """Yield ``node`` and descendants, NOT descending into nested
    function/class definitions (they are separate traced-or-not units);
    lambdas ARE descended into (an inline lambda in a traced body runs
    traced)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            stack.append(child)


class SourceModule:
    """One parsed source file plus the derived indexes checkers share."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.module_scope = Scope(self.tree, None)
        #: ast function/class node -> its own Scope
        self.scopes: dict = {id(self.tree): self.module_scope}
        #: function node -> the Scope it was DEFINED in (for resolution)
        self.def_scope: dict = {}
        self._build_scopes(self.tree, self.module_scope)
        self.events_aliases, self.imported_modules, self.emit_is_events = (
            self._scan_imports()
        )
        self.suppressions = parse_suppressions(path, source)
        self._traced = None

    # ---- scopes ----------------------------------------------------------

    def _build_scopes(self, node, scope: Scope) -> None:
        body = getattr(node, "body", None)
        if isinstance(body, list):
            _index_statements(body, scope)
        for fn in list(scope.functions.values()) + list(
            scope.classes.values()
        ):
            child = Scope(fn, scope)
            self.scopes[id(fn)] = child
            self.def_scope[id(fn)] = scope
            self._build_scopes(fn, child)

    def scope_of(self, fn_node) -> Scope:
        return self.scopes.get(id(fn_node), self.module_scope)

    # ---- imports ---------------------------------------------------------

    def _scan_imports(self):
        """(events-module aliases, top-level imported module names,
        bare-``emit``-is-events?, bare names imported from torch.func) —
        the schema checker's resolution inputs, the purity checker's
        stdlib-``random`` disambiguator and the bare vmap/grad roots."""
        events_aliases = set()
        modules = set()
        emit_is_events = False
        self.torch_func_names = set()
        self.autograd_function_names = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    modules.add(alias.asname or alias.name.split(".")[0])
                    if alias.name in (
                        "erasurehead_tpu.obs.events",
                        "erasurehead_tpu_torch.obs.events",
                    ):
                        events_aliases.add(alias.asname or alias.name)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if mod.endswith("obs") and alias.name == "events":
                        events_aliases.add(bound)
                    if mod.endswith("obs.events") and alias.name == "emit":
                        emit_is_events = True
                    if alias.name in BARE_TRACING and (
                        mod == "torch.func"
                        or (mod == "torch" and alias.name == "vmap")
                    ):
                        self.torch_func_names.add(bound)
                    if mod == "torch.autograd" and alias.name == "Function":
                        self.autograd_function_names.add(bound)
        return events_aliases, modules, emit_is_events

    def is_tracing_call(self, name: Optional[str]) -> bool:
        """Does a call of ``name`` run its first argument as a traced
        body (vmap / grad / grad_and_value)?"""
        return name in TRACING_NAMES or name in self.torch_func_names

    def _is_autograd_function(self, cls: ast.ClassDef) -> bool:
        for base in cls.bases:
            name = dotted(base)
            if name in AUTOGRAD_FUNCTION_BASES or (
                name is not None and name in self.autograd_function_names
            ):
                return True
        return False

    # ---- traced call graph ----------------------------------------------

    def traced_functions(self) -> dict:
        """Map of traced function/lambda nodes -> entry description.

        Roots: callables passed to vmap/grad/grad_and_value (directly or
        through ``partial``) and the ``forward``/``backward`` methods of
        ``torch.autograd.Function`` subclasses. From each root, local
        functions reachable by direct call (bare name or ``self.``
        method) are traced too."""
        if self._traced is not None:
            return self._traced
        roots: dict = {}

        def note(target, scope, why):
            for fn in self.callable_defs(target, scope):
                roots.setdefault(id(fn), (fn, why))

        def visit(node, scope):
            if isinstance(node, ast.ClassDef):
                if self._is_autograd_function(node):
                    for meth in AUTOGRAD_FUNCTION_METHODS:
                        fn = self.scope_of(node).functions.get(meth)
                        if fn is not None:
                            roots.setdefault(
                                id(fn),
                                (fn, f"autograd.Function {node.name}."
                                     f"{meth} line {fn.lineno}"),
                            )
                scope = self.scope_of(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = self.scope_of(node)
            elif isinstance(node, ast.Lambda):
                fn_scope = Scope(node, scope)
                self.scopes[id(node)] = fn_scope
                scope = fn_scope
            elif isinstance(node, ast.Call):
                name = dotted(node.func)
                if self.is_tracing_call(name) and node.args:
                    note(node.args[0], scope, f"{name} line {node.lineno}")
            for child in ast.iter_child_nodes(node):
                visit(child, scope)

        visit(self.tree, self.module_scope)
        self._traced = self.reachable(roots.values())
        return self._traced

    def reachable(self, roots) -> dict:
        """The transitive closure of ``roots`` ((fn, why) pairs) over
        locally-resolvable calls: fn id -> (fn, why of its root)."""
        traced: dict = {}
        queue = list(roots)
        while queue:
            fn, why = queue.pop()
            if id(fn) in traced:
                continue
            traced[id(fn)] = (fn, why)
            scope = self.scope_of(fn)
            for node in walk_own(fn):
                if not isinstance(node, ast.Call):
                    continue
                for callee in self.call_targets(node, scope):
                    if id(callee) not in traced:
                        queue.append((callee, why))
        return traced

    # ---- callable resolution ---------------------------------------------

    def callable_defs(self, expr, scope: Scope, _seen=None) -> list:
        """Resolve a callable EXPRESSION to the local function/lambda
        definitions it may denote. Follows: bare names (defs, and simple
        ``name = <expr>`` rebinds), ``self.`` methods, ``partial(f, ...)``,
        ``a or b`` / ternary alternatives, tuple elements, and — the
        factory idiom the step/trainer modules are built on — CALLS of
        local factories, resolving to whatever the factory ``return``s
        plus any callable arguments threaded through it
        (``vmap(_dq(_body(model)))`` traces the wrapper AND the wrapped
        body)."""
        if _seen is None:
            _seen = set()
        key = id(expr)
        if key in _seen or expr is None:
            return []
        _seen.add(key)
        if isinstance(expr, ast.Lambda):
            return [expr]
        if isinstance(expr, ast.Name):
            fn = scope.resolve_function(expr.id)
            if fn is not None:
                return [fn]
            # simple value bind: follow the bound expression lexically
            s = scope
            while s is not None:
                if not s.is_class() and expr.id in s.assigns:
                    return self.callable_defs(
                        s.assigns[expr.id], s, _seen
                    )
                s = s.parent
            return []
        if isinstance(expr, ast.Attribute):
            if dotted(expr.value) == "self":
                fn = scope.resolve_method(expr.attr)
                return [fn] if fn is not None else []
            return []
        if isinstance(expr, (ast.BoolOp, ast.Tuple)):
            # ``a or b`` may be either; a returned ``(fn, label)`` pair
            # (parallel/step.make_cohort_grad_fn) carries its callable
            out = []
            for v in expr.values if isinstance(expr, ast.BoolOp) else expr.elts:
                out += self.callable_defs(v, scope, _seen)
            return out
        if isinstance(expr, ast.IfExp):
            return self.callable_defs(
                expr.body, scope, _seen
            ) + self.callable_defs(expr.orelse, scope, _seen)
        if isinstance(expr, ast.Call):
            fname = dotted(expr.func)
            if fname in PARTIAL_NAMES and expr.args:
                return self.callable_defs(expr.args[0], scope, _seen)
            out = []
            factories = self.callable_defs(expr.func, scope, set(_seen))
            for factory in factories:
                fscope = self.scope_of(factory)
                for node in walk_own(factory):
                    if isinstance(node, ast.Return) and node.value is not None:
                        out += self.callable_defs(node.value, fscope, _seen)
            # callables threaded through the factory's arguments are part
            # of the traced graph too (wrapper factories like _dq)
            if factories or fname in PARTIAL_NAMES:
                for arg in expr.args:
                    out += self.callable_defs(arg, scope, _seen)
            return out
        return []

    def call_targets(self, call: ast.Call, scope: Scope) -> list:
        """Locally-resolvable defs this Call may invoke (reachability
        step): the callee itself plus partial-forwarded callables. The
        callee being a factory CALL is handled by callable_defs."""
        targets = []
        if isinstance(call.func, (ast.Name, ast.Attribute)):
            targets += self.callable_defs(call.func, scope)
        fname = dotted(call.func)
        if fname in PARTIAL_NAMES and call.args:
            targets += self.callable_defs(call.args[0], scope)
        return targets


def parse_suppressions(path: str, source: str) -> Suppressions:
    """Extract ``# lint: allow(...)`` comments via the tokenizer (so
    string literals containing the pattern are never misread)."""
    file_allows: dict = {}
    line_allows: dict = {}
    problems: list = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        text = tok.string
        if "lint:" not in text:
            continue
        m = _ALLOW_RE.search(text)
        line = tok.start[0]
        if m is None:
            problems.append(
                Finding(
                    "suppression", path, line, tok.start[1],
                    "malformed lint suppression comment; want "
                    "'# lint: allow(<checker>): <reason>' or "
                    "'# lint: allow-file(<checker>): <reason>'",
                )
            )
            continue
        checker, reason = m.group("checker"), m.group("reason")
        if not reason:
            problems.append(
                Finding(
                    "suppression", path, line, tok.start[1],
                    f"suppression allow({checker}) has no reason string; "
                    "every whitelisted exception must say why",
                )
            )
            reason = "<no reason given>"
        if m.group("scope"):
            file_allows.setdefault(checker, (line, reason))
        else:
            line_allows[(line, checker)] = reason
            # a comment-only line suppresses the line below it
            if text.strip() == tok.line.strip():
                line_allows.setdefault((line + 1, checker), reason)
    return Suppressions(file_allows, line_allows, problems)


def apply_suppressions(
    findings: Iterable[Finding], modules: dict
) -> list:
    """Mark findings suppressed per their file's allow comments and append
    the suppression-hygiene problems; returns a sorted list."""
    out = []
    for f in findings:
        mod = modules.get(f.path)
        if mod is not None:
            ok, reason = mod.suppressions.lookup(f.checker, f.line)
            if ok:
                f = dataclasses.replace(
                    f, suppressed=True, suppress_reason=reason
                )
        out.append(f)
    for mod in modules.values():
        out.extend(mod.suppressions.problems)
    return sorted(out, key=Finding.sort_key)
