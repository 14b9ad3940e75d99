"""Elastic membership: the port of erasurehead_tpu/elastic/.

Online death detection, mid-run re-layout and worker join, WITHOUT the
deaths scripted in advance:

- :mod:`erasurehead_tpu_torch.elastic.controller`: the telemetry-driven
  membership detector (K-round ``-1``-sentinel streaks, detect_dead timeout
  trips, collapsed-arrival probes, join offers) and its deterministic
  ledger;
- :mod:`erasurehead_tpu_torch.elastic.driver`: ``train_elastic_online``,
  the chunked restart loop that re-lays the code onto W' through the scheme
  registry, journals typed ``membership`` events, checkpoints the ledger and
  composes with the adapt/ bandit, the chaos harness and the deep models.
"""

from erasurehead_tpu_torch.elastic.controller import (  # noqa: F401
    ChunkObservation,
    ElasticConfig,
    MembershipChange,
    MembershipController,
    auto_survivor_config,
)
from erasurehead_tpu_torch.elastic.driver import (  # noqa: F401
    ElasticResult,
    science_fields,
    train_elastic_online,
)
