"""repro_torch.serve.admission — always-on async service loop.

Counterpart of `repro.serve.admission`, with the same names.

Turns the wave-mode `ServeEngine` into a long-lived service:
`AdmissionLoop` accepts `submit()` at any time (jobs join at the next
chunk boundary through the backfill path), packs near-miss signatures
that differ only in K into shared buckets, schedules priority/deadline
classes with bit-exact chunk-boundary preemption, and meters per-tenant
wire-byte quotas on the engine's exact ledger attribution.

See `loop` for the service loop, `packing` for the K-packing exactness
argument, `classes` for the scheduling contract, `quotas` for the
budget policy.
"""
from .classes import (DEFAULT_CLASSES, PriorityClass, admission_key,
                      resolve_class)
from .loop import AdmissionLoop, AdmissionQueue, QueueEntry
from .packing import (compatible, pack_chunk_rounds, pack_signature,
                      plan_bucket)
from .quotas import (DEPRIORITIZED_PRIORITY, QUOTA_MODES, QuotaExceeded,
                     TenantLedger)

__all__ = [
    "AdmissionLoop",
    "AdmissionQueue",
    "DEFAULT_CLASSES",
    "DEPRIORITIZED_PRIORITY",
    "PriorityClass",
    "QUOTA_MODES",
    "QueueEntry",
    "QuotaExceeded",
    "TenantLedger",
    "admission_key",
    "compatible",
    "pack_chunk_rounds",
    "pack_signature",
    "plan_bucket",
    "resolve_class",
]
