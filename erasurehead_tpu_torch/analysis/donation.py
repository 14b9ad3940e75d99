"""donation-safety: donated tensors are never read after the donating call.

The port of erasurehead_tpu/analysis/donation.py. A donating run
(``RunConfig.donate``, train/graphs.py) releases the storage of the carry it
was handed once the carry is in its CUDA graph's buffers, and any later
operation on a released tensor raises (graphs.Donated). The JAX package's
read after donation fails on a TPU and passes silently on its CPU backend;
here it fails on both, but only when a test reaches it, so this checker
finds the pattern in the source.

A donating call is a call of a function the port marks as donating: the
``donates(*positions, names=...)`` decorator (train/graphs.donates, the
counterpart of ``jax.jit(..., donate_argnums=...)``) on its definition, or a
name bound to ``donates(...)(fn)``. The donating functions are collected
over the whole checked tree (:func:`collect_donating`) and matched by the
called name (``train(...)``, ``trainer.train(...)``). Per function scope the
checker flags any donating call whose argument at a donated position, or
donated keyword, is a plain name that is read again later in the same body
without a rebind between. Arguments that are expressions (a clone, a slice,
an attribute such as ``res.final_state``) are skipped; assignment targets of
the donating call itself count as rebinds (``state, hist = run(state,
...)`` is the sanctioned consume-and-replace idiom).

Static limits, as in the JAX package: donating callables that travel
through variables other than their own names are not tracked, and
loop-carried reads that textually precede the call are not seen.
"""

from __future__ import annotations

import ast

from erasurehead_tpu_torch.analysis.core import Finding, SourceModule, dotted, walk_own

CHECKER = "donation-safety"

#: the decorator's names as a call's function renders (core.dotted)
DONATES_NAMES = frozenset({"donates", "graphs.donates"})


def _spec(call: ast.Call):
    """``(positions, names)`` of a ``donates(...)`` call, or None when it is
    not one or donates nothing."""
    if not isinstance(call, ast.Call) or dotted(call.func) not in DONATES_NAMES:
        return None
    positions = tuple(sorted({
        a.value for a in call.args
        if isinstance(a, ast.Constant) and isinstance(a.value, int)
        and not isinstance(a.value, bool)
    }))
    names: tuple = ()
    for kw in call.keywords:
        if kw.arg == "names":
            names = tuple(sorted({
                n.value for n in ast.walk(kw.value)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            }))
    return (positions, names) if positions or names else None


def collect_donating(tree: ast.AST) -> dict:
    """Function name -> ``(positions, names)`` for every definition in
    ``tree`` decorated ``@donates(...)``."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                spec = _spec(dec)
                if spec is not None:
                    out[node.name] = spec
    return out


def _called_name(call: ast.Call):
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _stmt_store_names(stmt) -> set:
    """Every name the statement (re)binds."""
    return {
        n.id for n in ast.walk(stmt)
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del))
    }


def _check_scope(mod: SourceModule, fn, donating: dict, findings: list) -> None:
    """One function (or module) body: its own ``name = donates(...)(fn)``
    bindings join the tree's donating functions, then every donating call's
    plain-name arguments are checked for later reads."""
    local = dict(donating)
    for node in walk_own(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            spec = _spec(node.value.func) if isinstance(node.value.func, ast.Call) else None
            if spec is not None:
                local[node.targets[0].id] = spec
    for node in walk_own(fn):
        if not isinstance(node, ast.Call):
            continue
        spec = local.get(_called_name(node))
        if spec is None:
            continue
        positions, names = spec
        donated = [(f"position {p}", node.args[p]) for p in positions if p < len(node.args)]
        donated += [(f"keyword {kw.arg!r}", kw.value) for kw in node.keywords
                    if kw.arg in names]
        for where, arg in donated:
            if isinstance(arg, ast.Name):  # an expression is fresh per call
                _flag_late_reads(mod, fn, node, arg.id, where, findings)


def _flag_late_reads(mod, fn, call, name, where, findings) -> None:
    """Is ``name`` loaded after ``call`` without a rebind between?"""
    rebind_lines = [
        node.lineno for node in walk_own(fn)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For))
        and name in _stmt_store_names(node)
    ]
    inside = {id(n) for n in ast.walk(call)}  # the call's own arguments
    for node in walk_own(fn):
        if (isinstance(node, ast.Name) and node.id == name and id(node) not in inside
                and isinstance(node.ctx, ast.Load) and node.lineno > call.lineno):
            if not any(call.lineno <= rl <= node.lineno for rl in rebind_lines):
                findings.append(Finding(
                    CHECKER, mod.path, node.lineno, node.col_offset,
                    f"{name!r} is read after being donated at {where} of the "
                    f"donating call on line {call.lineno}; a donated tensor's "
                    "storage is released by the call — pass a copy or rebind "
                    "from the result",
                ))
                return  # one finding per donated argument is enough


def check(mod: SourceModule, context) -> list:
    donating = {**getattr(context, "donating", {}), **collect_donating(mod.tree)}
    findings: list = []
    scopes = [mod.tree] + [
        node for node in ast.walk(mod.tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for fn in scopes:
        _check_scope(mod, fn, donating, findings)
    return findings
