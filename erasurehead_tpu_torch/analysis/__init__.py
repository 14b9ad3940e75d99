"""Static analysis for the port's batching/cohort/telemetry contracts.

The port of erasurehead_tpu/analysis/. ``python -m erasurehead_tpu_torch.cli
lint [paths]`` (or ``python -m erasurehead_tpu_torch.analysis``) runs five
AST checkers over the tree — no imports of the checked code, no torch:

  =======================  ==============================================
  checker                  contract enforced
  =======================  ==============================================
  trace-purity             no host effects (emit, metrics, clocks, host
                           RNG incl. torch.manual_seed / a Generator made
                           in the body, print/file I/O) reachable from
                           bodies run under torch.func.vmap / grad or as
                           a torch.autograd.Function's forward/backward
  signature-completeness   every RunConfig field a cohort-shared closure
                           (parallel/step.py's factories, the bodies
                           above) reads is in static_signature_fields()
  registry-dispatch        no hard-coded scheme comparisons, lookup
                           tables, or match-dispatch outside
                           erasurehead_tpu_torch/schemes/
  event-schema             every emit() call site carries the fields
                           obs/events.SCHEMA requires; SCHEMA, the
                           validator, the tune vocabulary and the
                           modules that delegate to the validator cannot
                           drift apart
  donation-safety          a plain name passed to a donating call (a
                           function marked ``@donates``, train/graphs.py:
                           the trainers' ``initial_state``) is not read
                           after it without a rebind
  =======================  ==============================================

tests/test_torch_analysis.py and tests/test_torch_graphs.py pin the shipped
port tree at zero unsuppressed findings. Intentional
exceptions are whitelisted in place with ``# lint: allow(<checker>):
<reason>`` (line) or ``# lint: allow-file(<checker>): <reason>`` (file); a
suppression without a reason is itself a finding, and ``lint --strict``
reports suppression counts per checker.
"""

from erasurehead_tpu_torch.analysis.core import Finding, SourceModule  # noqa: F401
from erasurehead_tpu_torch.analysis.runner import (  # noqa: F401
    CHECKERS,
    LintContext,
    LintReport,
    lint_paths,
    main,
)
