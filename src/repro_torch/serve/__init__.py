"""Streaming serving layer over the AlignmentEngine (DESIGN.md §8).

`AlignmentService` turns the one-shot engine into a long-running
co-processor front end: bounded-queue admission, continuous
length-class micro-batching, a depth-k device pipeline (autotunable),
per-request futures with SLA priorities, and a metrics surface
(`ServiceMetrics`). `serve.policy` holds the flush controllers: the
deterministic `StaticFlushPolicy` and the arrival-rate-aware
`AdaptiveFlushPolicy`, plus the `DepthAutotuner`. The replicated tier
(`AlignmentRouter`, `ReplicaPool`) is not ported yet (ROADMAP A6).
"""

from repro_torch.serve.metrics import ServiceMetrics, aggregate_metrics
from repro_torch.serve.policy import (AdaptiveFlushPolicy, DepthAutotuner,
                                      FlushPolicy, StaticFlushPolicy,
                                      resolve_policy)
from repro_torch.serve.service import AlignmentService

__all__ = ["AlignmentService", "ServiceMetrics", "aggregate_metrics",
           "FlushPolicy", "StaticFlushPolicy", "AdaptiveFlushPolicy",
           "DepthAutotuner", "resolve_policy"]
