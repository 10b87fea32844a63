"""`repro_torch.serve` — the query-serving layer above `core`.

Port of ``repro/serve/``, with the same exports as ``repro.serve``.
Turns the paper's one-shot §6 planning workflow into a runtime that can
sustain a request stream on one device: plan caching over normalized
query classes, signature-batched execution, and online cost-feedback
recalibration — plus the async multi-tenant front end
(`repro_torch.serve.aio`: SLO-aware admission, adaptive batching
windows, explicit backpressure) and Stage-A plan-cache persistence for
warm restarts (`repro_torch.serve.persist`).  The repository README's
port section has the backend selection matrix.
"""

from repro_torch.serve.aio import (
    AdmissionRejected,
    AioConfig,
    AsyncQueryService,
    TokenBucket,
)
from repro_torch.serve.feedback import Calibrator, CalibrationFactors, label_class_key
from repro_torch.serve.metrics import (
    SLO_CLASSES,
    LatencyHistogram,
    QueryRecord,
    ServiceMetrics,
)
from repro_torch.serve.persist import load_stage_a, placement_fingerprint, save_stage_a
from repro_torch.serve.plancache import (
    ExecutorCache,
    PlanCache,
    automaton_signature,
    canonical_key,
)
from repro_torch.serve.service import (
    Answers,
    QueryService,
    ServeConfig,
    ServiceOverloaded,
    Ticket,
)

__all__ = [
    "AdmissionRejected",
    "AioConfig",
    "Answers",
    "AsyncQueryService",
    "Calibrator",
    "CalibrationFactors",
    "ExecutorCache",
    "LatencyHistogram",
    "PlanCache",
    "QueryRecord",
    "QueryService",
    "SLO_CLASSES",
    "ServeConfig",
    "ServiceMetrics",
    "ServiceOverloaded",
    "Ticket",
    "TokenBucket",
    "automaton_signature",
    "canonical_key",
    "label_class_key",
    "load_stage_a",
    "placement_fingerprint",
    "save_stage_a",
]
