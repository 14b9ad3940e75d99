"""The cohort grouping key of a run's device data stack.

The port of erasurehead_tpu/train/cache.py::layout_stack_signature, with the
storage part of the JAX package's upload key (erasurehead_tpu/train/
trainer.py:326-340). The JAX module also holds the sweep engine's data and
executable caches; the port has neither yet, only the key the
trajectory-cohort engine groups by (train/trainer.cohort_signature).
"""

from __future__ import annotations

import numpy as np


def layout_stack_signature(
    layout, *, worker_major: bool, stack_dtype: str = "float32",
    dtype: str = "float32", sparse_format: str = "padded",
) -> tuple:
    """Content signature of the device stack a (layout, stacking mode,
    storage) builds.

    The partition-major stack (deduped mode) depends only on
    ``n_partitions``: it is scheme-independent, so a whole multi-scheme
    compare() shares one upload and one cohort. The worker-major stack
    (faithful mode) gathers through ``layout.assignment``, so its content
    is the key: schemes sharing an assignment (FRC and AGC) share a stack;
    cyclic MDS has its own. The storage follows, as in the JAX package's
    upload key: the resolved stack dtype with the data dtype (an int8 and
    a float32 stack of the same content never share), and the sparse
    format."""
    if worker_major:
        assignment = np.asarray(layout.assignment)
        content = ("workers", assignment.shape, assignment.tobytes())
    else:
        content = ("parts", int(layout.n_partitions))
    return content + ((stack_dtype, dtype), sparse_format)
