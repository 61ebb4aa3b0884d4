"""Metrics registry — counters, gauges, histograms with labels.

One `MetricsRegistry` holds labeled metric families; sinks render a
snapshot as Prometheus text exposition format or JSONL records
(`repro_torch.obs.export`); a copy of `repro.obs.metrics`.  The
registry *adapts* the port's instruments instead of replacing them —
`observe_ledger` publishes a `repro_torch.comm.CommLedger`'s per-channel byte accounting,
`observe_engine` a serve `EngineStats`, `observe_fault_extras` the
fault-injection extras a faulted `solve()` returns — so every tier
keeps its byte-exact native accounting and gains one shared read-out
surface.

`TraceCounter` is the shared build counter.  The port compiles no
programs: a "trace" here is one build of a runner (the serve engine's
bucket chunk runner, counted where the engine builds it), and `wrap()`
memoises a builder so that it ticks once per distinct build key —
calls served from the memo do not tick it.  `retraces` (= max(count −
1, 0)) is the quantity every zero-rebuild check pins to 0.  Each
counter also publishes `jit_traces_total{name=...}` into the registry
(`repro`'s family name, so dashboards read both packages alike).

All of this is host-side bookkeeping: nothing here runs inside a
device computation, so enabling metrics cannot perturb trajectories
(the on-device half of observability is `repro_torch.obs.recorder`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

#: Default histogram buckets (seconds-flavoured; callers override).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   float("inf"))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class _Sample:
    """One rendered sample: (name, labels, value) + family metadata."""
    name: str
    labels: tuple
    value: float
    kind: str
    help: str


class _Child:
    """One (family, label-set) time series."""

    __slots__ = ("kind", "value", "buckets", "counts", "total", "n")

    def __init__(self, kind: str, buckets=None):
        self.kind = kind
        self.value = 0.0
        self.buckets = buckets
        self.counts = [0] * len(buckets) if buckets else None
        self.total = 0.0
        self.n = 0

    def inc(self, amount: float = 1.0) -> None:
        if self.kind != "counter":
            raise TypeError(f"inc() on a {self.kind}")
        if amount < 0:
            raise ValueError(
                f"counters are monotonic; inc({amount}) would go "
                f"backwards — use a gauge for values that can fall")
        self.value += amount

    def set(self, value: float) -> None:
        if self.kind != "gauge":
            raise TypeError(f"set() on a {self.kind}")
        self.value = float(value)

    def observe(self, value: float) -> None:
        if self.kind != "histogram":
            raise TypeError(f"observe() on a {self.kind}")
        v = float(value)
        self.total += v
        self.n += 1
        # per-bucket (non-cumulative) counts; `samples()` does the
        # Prometheus cumulative sum at render time
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                break


class MetricFamily:
    """A named metric with a fixed kind and free-form labels."""

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = tuple(buckets) if buckets else None
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **labels) -> _Child:
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self.kind, self.buckets)
                self._children[key] = child
        return child

    # label-free conveniences
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def value(self, **labels) -> float:
        return self.labels(**labels).value

    def samples(self) -> list[_Sample]:
        out = []
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            if self.kind == "histogram":
                cum = 0
                for edge, cnt in zip(child.buckets, child.counts):
                    cum += cnt
                    le = "+Inf" if edge == float("inf") else repr(edge)
                    out.append(_Sample(self.name + "_bucket",
                                       key + (("le", le),), cum,
                                       self.kind, self.help))
                out.append(_Sample(self.name + "_sum", key, child.total,
                                   self.kind, self.help))
                out.append(_Sample(self.name + "_count", key, child.n,
                                   self.kind, self.help))
            else:
                out.append(_Sample(self.name, key, child.value,
                                   self.kind, self.help))
        return out


class MetricsRegistry:
    """Ordered collection of metric families."""

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str,
                buckets=None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as a "
                    f"{fam.kind}; cannot re-register as a {kind}")
        return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> MetricFamily:
        return self._family(name, "histogram", help, buckets)

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def samples(self) -> list[_Sample]:
        return [s for fam in self.families() for s in fam.samples()]

    def clear(self) -> None:
        with self._lock:
            self._families.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry the built-in adapters publish to."""
    return _REGISTRY


def reset_metrics() -> None:
    """Drop every family from the default registry (test isolation)."""
    _REGISTRY.clear()


# ---------------------------------------------------------------------------
# Shared retrace / compile-cache counter
# ---------------------------------------------------------------------------

class TraceCounter:
    """Build counter (see module docstring).

    >>> tc = TraceCounter("runner")
    >>> build = tc.wrap(lambda key: object())
    >>> r1 = build("a"); r2 = build("a")
    >>> tc.count, tc.retraces, r1 is r2
    (1, 0, True)
    """

    def __init__(self, name: str = "jit", reg: MetricsRegistry | None
                 = None):
        self.name = name
        self.count = 0
        self._metric = (reg or registry()).counter(
            "jit_traces_total",
            "times a TraceCounter-counted runner was built"
        ).labels(name=name)

    def bump(self) -> int:
        """Tick once — call this where a runner is built (callers with
        their own cache, e.g. the serve engine's chunk runners);
        returns the new count."""
        self.count += 1
        self._metric.inc()
        return self.count

    def wrap(self, fn):
        """A memoising `fn(*args)`: the first call with a given
        (hashable) argument tuple builds through `fn` and ticks this
        counter; later calls with the same arguments return the memo
        and are silent."""
        memo: dict = {}

        def build(*args):
            if args not in memo:
                self.bump()
                memo[args] = fn(*args)
            return memo[args]
        return build

    @property
    def traces(self) -> int:
        return self.count

    @property
    def retraces(self) -> int:
        """Builds beyond the first — 0 is the acceptance criterion on
        every zero-rebuild check."""
        return max(self.count - 1, 0)


# ---------------------------------------------------------------------------
# Adapters over the existing instruments
# ---------------------------------------------------------------------------

def observe_ledger(ledger, reg: MetricsRegistry | None = None,
                   **labels) -> None:
    """Publish a `repro_torch.comm.CommLedger` snapshot: per-channel sends,
    exact wire bytes and uncompressed-f32 words as labeled counters
    (gauge semantics would lose monotonicity across runs; ledgers are
    per-run, so callers label them — e.g. run="bench_faults/ring").
    """
    reg = reg or registry()
    sends = reg.counter("comm_sends_total",
                        "gossip sends per ledger channel")
    byts = reg.counter("comm_wire_bytes_total",
                       "exact wire bytes per ledger channel")
    floats = reg.counter("comm_wire_floats_total",
                         "uncompressed f32 words per ledger channel")
    for name, ch in ledger.channels.items():
        lab = dict(labels, ledger=ledger.name, channel=name,
                   spec=ch.spec)
        sends.labels(**lab).inc(ch.sends)
        byts.labels(**lab).inc(ch.bytes)
        floats.labels(**lab).inc(ch.floats)


def observe_engine(stats, reg: MetricsRegistry | None = None,
                   **labels) -> None:
    """Publish a serve `EngineStats` snapshot as gauges (the engine
    owns the counters; the registry mirrors its latest values)."""
    reg = reg or registry()
    for f in dataclasses.fields(stats):
        reg.gauge(f"serve_engine_{f.name}",
                  f"serve EngineStats.{f.name} snapshot"
                  ).labels(**labels).set(float(getattr(stats, f.name)))


def observe_fault_extras(extras: dict,
                         reg: MetricsRegistry | None = None,
                         **labels) -> None:
    """Publish a faulted solve's extras: the realized alive fraction
    (honest wire scale) and the trace's round/agent shape."""
    reg = reg or registry()
    frac = extras.get("fault_alive_fraction")
    if frac is not None:
        reg.gauge("fault_alive_fraction",
                  "realized / nominal directed sends of a faulted run"
                  ).labels(**labels).set(float(frac))
    trace = extras.get("fault_trace")
    if trace is not None:
        reg.gauge("fault_trace_rounds",
                  "rounds covered by the lowered fault trace"
                  ).labels(**labels).set(float(trace.rounds))


def fused_fallback_counter(reg: MetricsRegistry | None = None
                           ) -> MetricFamily:
    """`repro`'s counter of `MixingOp` fallbacks from a fused/Pallas
    dispatch onto a composed path.  Nothing in the port ticks it: the
    port's kernels take every shape their tier is asked for and never
    fall back (`repro_torch.topology.ops`), so it reads 0; it exists so
    that both packages export the same family."""
    return (reg or registry()).counter(
        "mixing_fused_fallbacks_total",
        "MixingOp fused/Pallas fallbacks onto the XLA compose path")


def dropped_spans_counter(reg: MetricsRegistry | None = None
                          ) -> MetricFamily:
    """The counter `Tracer` ticks when `max_resident_spans` evicts
    buffered events — nonzero means the trace is incomplete unless a
    `StreamingTraceWriter` sink persisted the evicted spans first."""
    return (reg or registry()).counter(
        "obs_dropped_spans_total",
        "spans evicted from a Tracer's bounded resident buffer")


def counter_value(metric: str, reg: MetricsRegistry | None = None,
                  **labels) -> float:
    """Read one time series back (tests, bench assertions).  First
    positional arg is the *family* name; `labels` are the series
    labels — which may themselves include a `name=` label (the
    TraceCounter convention), hence the distinct parameter name."""
    reg = reg or registry()
    with reg._lock:
        fam = reg._families.get(metric)
    if fam is None:
        return 0.0
    return fam.labels(**labels).value


#: Re-exported sample type for sinks.
Sample = _Sample
