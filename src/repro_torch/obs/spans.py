"""Structured span tracer — host-side phase timing for every tier.

A copy of `repro.obs.spans` (same span names, tracks and export), with
the port's round loop in place of `repro`'s compiled scan.

One `Tracer` records *spans* (named, nested intervals on a logical
track) and *instants* (zero-duration markers) with microsecond
timestamps relative to the tracer's epoch.  The schema is the Chrome /
Perfetto `trace_event` model — each finished span is one complete
("ph": "X") event with `name/cat/ts/dur/pid/tid/args` — so a recorded
run exports losslessly to a JSON that `ui.perfetto.dev` opens directly
(`repro_torch.obs.export.write_trace`).

Tracks ("tid") are *named*: `span("chunk", track="engine")` puts the
span on the "engine" track; the exporter emits the thread-name metadata
events Perfetto uses to label them.  Host threads are not the unit —
the solver is single-threaded host-side and the interesting concurrency
axis is logical (engine vs solver vs checkpoint I/O), so tracks are
chosen by the instrumentation, not by `threading.get_ident()`.

Off by default, and disabled tracing is *free* in the sense the
bitwise-identical contract needs: `span()` returns a shared no-op
context manager after one attribute check, no event is allocated, and
nothing about the instrumented computation changes either way (spans
only ever *observe* wall clock — regression-tested in
tests/test_obs.py, where a traced `solve()` must equal the untraced one
bit-for-bit with zero extra retraces).

The port's reference tier runs its K rounds as a Python loop that
never synchronizes with the card (`repro_torch.core.dagm`), so the
host's clock sees the dispatch of the rounds, not their execution.
`synthesize_round_spans` reconstructs per-round spans from what IS
measured — the chunk's wall clock up to one sync, the round count and
the per-phase gossip weights — and marks every such span
`"synthetic": true` in its args: the timeline is solver-semantic (one
span per outer round, nested inner/DIHGP/outer-step phases) while the
durations are an evenly divided model, never presented as
measurements.

Usage:

    from repro_torch import obs
    with obs.tracing():                       # or obs.enable_tracing()
        with obs.span("solve", method="dagm"):
            ...
    obs.export.write_trace(obs.tracer(), "trace.json")
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

#: Default logical track for spans that do not name one.
DEFAULT_TRACK = "main"

#: Default cap on resident (un-exported) events per tracer.  A span is
#: ~200 bytes host-side, so the default bounds a forgotten-`write_trace`
#: long-lived engine at ~13 MB before oldest-first eviction kicks in.
DEFAULT_MAX_RESIDENT_SPANS = 65536


@dataclasses.dataclass
class SpanEvent:
    """One finished span (or instant, when `dur_us` is None)."""
    name: str
    cat: str
    ts_us: float                  # offset from the tracer epoch, µs
    dur_us: float | None          # None → instant event ("ph": "i")
    track: str = DEFAULT_TRACK
    args: dict = dataclasses.field(default_factory=dict)


class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager that records one SpanEvent on exit."""

    __slots__ = ("tracer", "name", "cat", "track", "args", "_t0")

    def __init__(self, tracer, name, cat, track, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def annotate(self, **args) -> None:
        """Attach args discovered mid-span (e.g. a retry count)."""
        self.args.update(args)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tr = self.tracer
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        tr._record(SpanEvent(
            name=self.name, cat=self.cat,
            ts_us=(self._t0 - tr.epoch) * 1e6,
            dur_us=(t1 - self._t0) * 1e6,
            track=self.track, args=self.args))
        return False


class Tracer:
    """Span/instant recorder (see module docstring).

    Construction is cheap and tracers are independent — tests build
    their own; library instrumentation goes through the module-level
    default (`tracer()`) guarded by `enabled`.

    Resident memory is *bounded*: at most `max_resident_spans` events
    stay buffered, and recording past the cap evicts the oldest event
    (counted on `self.dropped` and published as the
    `obs_dropped_spans_total` registry counter).  A long-lived engine
    that never calls `write_trace` therefore plateaus instead of
    growing without bound; attach a `StreamingTraceWriter` (it
    registers itself via `add_sink`) to persist every event before it
    can be evicted.  Pass `max_resident_spans=None` to opt out."""

    def __init__(self, enabled: bool = False,
                 max_resident_spans: "int | None" =
                 DEFAULT_MAX_RESIDENT_SPANS):
        self.enabled = bool(enabled)
        self.epoch = time.perf_counter()
        self._events: collections.deque[SpanEvent] = collections.deque()
        if max_resident_spans is not None:
            max_resident_spans = int(max_resident_spans)
            if max_resident_spans < 1:
                raise ValueError(
                    f"max_resident_spans must be a positive event count "
                    f"or None for unbounded (got {max_resident_spans})")
        self.max_resident_spans = max_resident_spans
        self.dropped = 0
        self._sinks: list[Callable[[SpanEvent], None]] = []

    # -- recording ---------------------------------------------------------

    def _record(self, ev: SpanEvent) -> None:
        """Single funnel for every finished event: feed sinks first
        (streaming writers see each event exactly once, before any
        eviction can touch it), then buffer under the resident cap."""
        for sink in self._sinks:
            sink(ev)
        self._events.append(ev)
        cap = self.max_resident_spans
        if cap is not None:
            dropped = 0
            while len(self._events) > cap:
                self._events.popleft()
                dropped += 1
            if dropped:
                self.dropped += dropped
                from .metrics import dropped_spans_counter
                dropped_spans_counter().inc(dropped)

    def add_sink(self, sink: Callable[[SpanEvent], None]) -> None:
        """Subscribe `sink(event)` to every subsequently recorded
        event (used by `StreamingTraceWriter.attach`)."""
        if sink not in self._sinks:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[SpanEvent], None]) -> None:
        try:
            self._sinks.remove(sink)
        except ValueError:
            pass

    def span(self, name: str, cat: str = "solver",
             track: str = DEFAULT_TRACK, **args):
        """Context manager timing one phase; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, track, dict(args))

    def instant(self, name: str, cat: str = "solver",
                track: str = DEFAULT_TRACK, **args) -> None:
        """Zero-duration marker (retire, retry, quarantine, ...)."""
        if not self.enabled:
            return
        self._record(SpanEvent(
            name=name, cat=cat,
            ts_us=(time.perf_counter() - self.epoch) * 1e6,
            dur_us=None, track=track, args=dict(args)))

    def add_span(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "solver", track: str = DEFAULT_TRACK,
                 **args) -> None:
        """Record a span with explicit timing — the synthesized-span
        entry point (callers own the honesty of the timestamps)."""
        if not self.enabled:
            return
        self._record(SpanEvent(
            name=name, cat=cat, ts_us=float(ts_us),
            dur_us=float(dur_us), track=track, args=dict(args)))

    def now_us(self) -> float:
        """Current timestamp on the tracer clock (µs since epoch)."""
        return (time.perf_counter() - self.epoch) * 1e6

    # -- views -------------------------------------------------------------

    def events(self) -> list[SpanEvent]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0
        self.epoch = time.perf_counter()


# ---------------------------------------------------------------------------
# Module-level default tracer (what the library instrumentation uses)
# ---------------------------------------------------------------------------

_TRACER = Tracer(enabled=False)


def tracer() -> Tracer:
    """The process-default tracer every built-in span goes through."""
    return _TRACER


def enable_tracing(enabled: bool = True) -> Tracer:
    _TRACER.enabled = bool(enabled)
    return _TRACER


@contextlib.contextmanager
def tracing(enabled: bool = True):
    """Scoped enable/disable of the default tracer."""
    prev = _TRACER.enabled
    _TRACER.enabled = bool(enabled)
    try:
        yield _TRACER
    finally:
        _TRACER.enabled = prev


def span(name: str, cat: str = "solver", track: str = DEFAULT_TRACK,
         **args):
    return _TRACER.span(name, cat, track, **args)


def instant(name: str, cat: str = "solver", track: str = DEFAULT_TRACK,
            **args) -> None:
    _TRACER.instant(name, cat, track, **args)


# ---------------------------------------------------------------------------
# Synthesized solver-phase spans (unsynchronized rounds, reconstructed)
# ---------------------------------------------------------------------------

def synthesize_round_spans(tr: Tracer, *, t0_us: float, dur_us: float,
                           rounds: int, phases=None,
                           track: str = "solver",
                           round_args: "list[dict] | None" = None,
                           name: str = "outer_round",
                           cat: str = "solver.round") -> int:
    """Reconstruct per-round spans for a K-round chunk.

    The device ran `rounds` outer rounds inside one unsynchronized chunk of
    measured wall clock `dur_us` starting at `t0_us`; this emits one
    `name` span per round (evenly divided — a model, flagged
    `synthetic: true`) and, when `phases` is given as (label, weight)
    pairs, nests child spans splitting each round proportionally to the
    weights (e.g. the M inner-DGD, U DIHGP and 1 outer-step gossip
    exchanges).  `round_args[k]` attaches per-round scalars (flight-
    recorder rows: outer gap, penalty, bytes) to round k's span.
    Returns the number of events emitted."""
    if not tr.enabled or rounds <= 0 or dur_us <= 0:
        return 0
    per = dur_us / rounds
    weights = None
    if phases:
        total = float(sum(w for _, w in phases))
        if total > 0:
            weights = [(label, w / total) for label, w in phases if w > 0]
    emitted = 0
    for k in range(rounds):
        ts = t0_us + k * per
        args = {"round": k, "synthetic": True}
        if round_args is not None and k < len(round_args):
            args.update(round_args[k])
        tr.add_span(name, ts, per, cat=cat, track=track, **args)
        emitted += 1
        if weights:
            off = 0.0
            for label, frac in weights:
                tr.add_span(label, ts + off, per * frac,
                            cat=cat + ".phase", track=track,
                            round=k, synthetic=True)
                off += per * frac
                emitted += 1
    return emitted
