"""Tendency-as-a-service: the serving layer over FastVAT, on the card.

Public surface:

  * :class:`TendencyServer` / :class:`ServeConfig` — the coalescing,
    program-cached server (``submit`` -> Future, ``fit`` sync, ``warm``,
    ``stats``), on ``ServeConfig.device`` (default "cuda").
  * :class:`ProgramCache` / :class:`ProgramKey` — the LRU program cache
    and its key contract.
  * bucketing helpers — ordering-exact pad-to-bucket shape collapse.
  * :class:`CoalescerCore` + the error taxonomy — the clock-free
    scheduling state machine the deterministic test rig drives.
  * the degradation ladder — retry, circuit breaker, fallback chain.
"""
from repro_torch.api.validation import InvalidInput
from repro_torch.serve.bucketing import (MIN_BUCKET, bucket_batch, bucket_n,
                                         ensure_bucketable, pack_batch,
                                         pad_rows, real_positions, restrict)
from repro_torch.serve.cache import (CacheStats, ProgramCache, ProgramKey,
                                     mesh_fingerprint)
from repro_torch.serve.coalesce import (Backpressure, Batch, CoalescerCore,
                                        DeadlineExceeded, ExecutionError,
                                        ServeError, ServeRequest)
from repro_torch.serve.resilience import (BreakerConfig, CircuitBreaker,
                                          ResilienceStats, RetryPolicy,
                                          breaker_family, fallback_chain)
from repro_torch.serve.server import (PADDED_RUNGS, SERVABLE, ServeConfig,
                                      ServeStats, TendencyServer,
                                      reset_trace_census, resolve_key,
                                      trace_census)

__all__ = [
    "MIN_BUCKET", "bucket_batch", "bucket_n", "ensure_bucketable",
    "pack_batch", "pad_rows", "real_positions", "restrict",
    "CacheStats", "ProgramCache", "ProgramKey", "mesh_fingerprint",
    "Backpressure", "Batch", "CoalescerCore", "DeadlineExceeded",
    "ExecutionError", "InvalidInput", "ServeError", "ServeRequest",
    "BreakerConfig", "CircuitBreaker", "ResilienceStats", "RetryPolicy",
    "breaker_family", "fallback_chain",
    "PADDED_RUNGS", "SERVABLE", "ServeConfig", "ServeStats",
    "TendencyServer", "resolve_key", "trace_census", "reset_trace_census",
]
