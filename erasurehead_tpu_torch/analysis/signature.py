"""signature-completeness: shared closures read only signature-keyed cfg.

The port of erasurehead_tpu/analysis/signature.py, restated for the
port's bug class. ``trainer.cohort_signature`` (built on
``RunConfig.static_signature()``) decides which trajectories the serve
packer and ``experiments.plan_cohorts`` run as ONE cohort, under one
gradient lowering built from the first member's config. A closure that
such a cohort shares and that reads a config field NOT in the signature
takes the first member's value for every member: two requests that
differ in that field pack together and one of them silently trains under
the other's setting.

The checker resolves the ``RunConfig`` dataclass field set and the
``static_signature_fields()`` key set from utils/config.py BY AST (no
import, no torch), then flags every ``cfg.<field>`` / ``self.cfg.<field>``
attribute read, where ``<field>`` is a config field missing from the
signature, inside:

  - the closures returned by ``parallel/step.py``'s ``make_*`` /
    ``*_grad_fn`` factories (the gradient functions a cohort shares), and
    the local functions they call;
  - the traced call graph of core.SourceModule.traced_functions (bodies
    under vmap / grad, ``torch.autograd.Function`` methods).

Fields whose value is fully determined by the shapes of the tensors the
closure is given are exempt (:data:`SHAPE_CAPTURED`): ``rounds`` shows up
as the schedule length, ``n_rows``/``n_cols`` as the data stack shape,
``n_workers`` as the stack's leading axis — and ``cohort_signature``
carries ``rounds`` and ``n_workers`` and the stack signature besides.
Value-like fields (``num_collect``, ``deadline``, ``delay_mean``, ...) get
no such free ride.
"""

from __future__ import annotations

import ast

from erasurehead_tpu_torch.analysis.core import Finding, SourceModule, dotted, walk_own

CHECKER = "signature-completeness"

#: attribute-chain bases treated as a RunConfig value inside closures
CONFIG_BASES = frozenset(
    {"cfg", "config", "run_config", "arm_cfg", "self.cfg", "self.config"}
)

#: config fields captured by the given tensors' SHAPES (see module
#: docstring); everything else must be in static_signature_fields() to be
#: read in a shared closure
SHAPE_CAPTURED = frozenset(
    {"rounds", "n_rows", "n_cols", "n_workers", "partitions_per_worker"}
)

#: the module whose factories build the closures a cohort shares
STEP_MODULE_SUFFIX = "parallel/step.py"


def _is_step_factory(name: str) -> bool:
    return name.startswith("make_") or name.endswith("_grad_fn")


def shared_closures(mod: SourceModule) -> dict:
    """fn id -> (fn, why) for the closures ``parallel/step.py``'s
    factories return, and the local functions they reach; empty for any
    other module."""
    if not mod.path.replace("\\", "/").endswith(STEP_MODULE_SUFFIX):
        return {}
    roots = []
    for name, factory in sorted(mod.module_scope.functions.items()):
        if not _is_step_factory(name):
            continue
        fscope = mod.scope_of(factory)
        for node in walk_own(factory):
            if isinstance(node, ast.Return) and node.value is not None:
                for fn in mod.callable_defs(node.value, fscope):
                    roots.append(
                        (fn, f"the closure {name}() returns, line {fn.lineno}")
                    )
    return mod.reachable(roots)


def parse_config_info(source: str):
    """(dataclass field names, static-signature keys) from utils/config.py
    source. Fields = annotated assignments in ``class RunConfig``; keys =
    string keys of the dict literal returned by
    ``static_signature_fields``. Parsed, not imported — the linter never
    executes the code it checks."""
    tree = ast.parse(source)
    fields: set = set()
    keys: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "RunConfig":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    fields.add(stmt.target.id)
                if (
                    isinstance(stmt, ast.FunctionDef)
                    and stmt.name == "static_signature_fields"
                ):
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Dict):
                            for key in sub.keys:
                                if isinstance(
                                    key, ast.Constant
                                ) and isinstance(key.value, str):
                                    keys.add(key.value)
    return fields, keys


def check(mod: SourceModule, context) -> list:
    fields = context.config_fields
    keys = context.signature_keys
    if not fields or not keys:
        return []
    units = dict(shared_closures(mod))
    units.update(mod.traced_functions())
    findings = []
    for fn, why in units.values():
        for node in walk_own(fn):
            if not isinstance(node, ast.Attribute) or not isinstance(
                node.ctx, ast.Load
            ):
                continue
            base = dotted(node.value)
            if base not in CONFIG_BASES:
                continue
            attr = node.attr
            if attr in fields and attr not in keys and attr not in SHAPE_CAPTURED:
                findings.append(
                    Finding(
                        CHECKER,
                        mod.path,
                        node.lineno,
                        node.col_offset,
                        f"shared closure (via {why}) reads {base}.{attr}, "
                        "which is not in RunConfig."
                        "static_signature_fields(); a cohort packs "
                        "requests that differ in it under one lowering — "
                        "add it to the signature or pass it in as a value",
                    )
                )
    return findings
