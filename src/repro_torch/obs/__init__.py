"""repro_torch.obs — the shared observability substrate (a copy of
`repro.obs`).

One subsystem, three layers, every tier emits into it:

  spans     host-side phase/lifecycle tracing → Perfetto trace JSON
            (`tracing()`, `span()`, `synthesize_round_spans`)
  metrics   labeled counters/gauges/histograms adapting the existing
            CommLedger / EngineStats / fault-extras instruments, plus
            the shared `TraceCounter` retrace counter
  recorder  on-device per-round flight rows (outer gap, penalty, wire
            bytes, alive fraction) riding the `dagm_run_chunk` carry

Everything is off by default and contractually inert when off: a run
with observability disabled is bitwise identical to one that predates
this package (tests/test_torch_obs.py).
"""
from . import export
from .export import (MetricsJsonlWriter, StreamingTraceWriter,
                     TRACE_PID, parse_prometheus, prometheus_text,
                     read_trace, trace_events, validate_trace,
                     write_flight_jsonl, write_metrics_jsonl,
                     write_prometheus, write_trace)
from .metrics import (MetricsRegistry, TraceCounter, counter_value,
                      dropped_spans_counter, fused_fallback_counter,
                      observe_engine, observe_fault_extras,
                      observe_ledger, registry, reset_metrics)
from .recorder import (FIELDS, FlightBuffer, RecorderSpec,
                       flight_values, recorder_init, recorder_rows,
                       recorder_write, rows_to_dicts, wire_bytes_sent,
                       wire_constants)
from .spans import (DEFAULT_MAX_RESIDENT_SPANS, DEFAULT_TRACK,
                    SpanEvent, Tracer, enable_tracing, instant, span,
                    synthesize_round_spans, tracer, tracing)

__all__ = [
    "DEFAULT_MAX_RESIDENT_SPANS", "DEFAULT_TRACK", "FIELDS",
    "FlightBuffer", "MetricsJsonlWriter", "MetricsRegistry",
    "RecorderSpec", "SpanEvent", "StreamingTraceWriter", "TRACE_PID",
    "TraceCounter", "Tracer", "counter_value", "dropped_spans_counter",
    "enable_tracing", "export", "fused_fallback_counter",
    "flight_values", "instant", "observe_engine",
    "observe_fault_extras", "observe_ledger", "parse_prometheus",
    "prometheus_text", "read_trace", "recorder_init", "recorder_rows",
    "recorder_write", "registry", "reset_metrics", "rows_to_dicts",
    "span", "synthesize_round_spans", "trace_events", "tracer",
    "tracing", "validate_trace", "wire_bytes_sent", "wire_constants",
    "write_flight_jsonl", "write_metrics_jsonl", "write_prometheus",
    "write_trace",
]
