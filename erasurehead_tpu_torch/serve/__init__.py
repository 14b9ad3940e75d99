"""Sweep-as-a-service: multi-tenant cohort packing with admission control.

The port of erasurehead_tpu/serve/ (the single daemon; the fleet's router
and supervisor come with ROADMAP queue A, A13). The serve daemon generalizes
the cohort engine's batch dimension from "one user's sweep"
(train/trainer.train_cohort) to "many concurrent clients": compatible
requests from different tenants bin-pack into shared dispatches on the
card, weighted-fair across tenants; an admission controller bounds
in-flight device memory; backpressure rejects (429 / "rejected") instead of
starving once the intake queue crosses its high-water mark; and results
stream back per tenant with journal-backed resume. Acceptances are WAL'd
and the kernel library persists in the daemon's ``cache_dir``, so a
crashed daemon restarts warm: no new build, every accepted request
rehydrated bitwise.

    serve/queue.py       request/result model + in-process handles
    serve/packer.py      signature bin-packing, weighted-fair + quotas
    serve/admission.py   device-memory budget: estimates, measured peaks, evict
    serve/wal.py         intake write-ahead log (crash-safe acceptances)
    serve/server.py      the SweepServer loop + the unix-socket front
    serve/http_front.py  HTTP/1.1 JSONL front: auth, streaming, 429s
    serve/client.py      socket + HTTP clients for ``cli serve``
    serve/loadgen.py     closed-loop load generator
"""

from erasurehead_tpu_torch.serve.client import (  # noqa: F401
    HttpServeClient,
    ServeClient,
    ServeRejectedError,
    ServeUnavailableError,
)
from erasurehead_tpu_torch.serve.queue import (  # noqa: F401
    RequestHandle,
    RunRequest,
    ServeOverloadedError,
    ServeResult,
    config_from_payload,
    config_payload,
    request_digest,
)
from erasurehead_tpu_torch.serve.server import (  # noqa: F401
    SocketFront,
    SweepServer,
    serving,
)
from erasurehead_tpu_torch.serve.wal import IntakeWAL  # noqa: F401
