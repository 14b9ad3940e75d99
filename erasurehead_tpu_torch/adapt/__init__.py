"""Online straggler-adaptive collection: the port of erasurehead_tpu/adapt/.

``train_adaptive`` runs the trainer in chunks and lets a seeded
discounted-reward bandit (:class:`AdaptiveController`) re-choose the
collection policy, a registry-compatible :class:`Arm` of (scheme, collect
count, deadline), at every chunk boundary, reading the run's own
decode-error and arrival telemetry. Decisions are typed ``adapt`` events.
"""

from erasurehead_tpu_torch.adapt.controller import (
    AdaptiveController,
    Arm,
    ChunkStats,
    ControllerConfig,
)
from erasurehead_tpu_torch.adapt.driver import (
    AdaptiveResult,
    default_arms,
    train_adaptive,
)

__all__ = [
    "AdaptiveController",
    "AdaptiveResult",
    "Arm",
    "ChunkStats",
    "ControllerConfig",
    "default_arms",
    "train_adaptive",
]
