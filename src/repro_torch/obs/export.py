"""Exporters — Perfetto trace JSON, Prometheus text, metrics JSONL.

A copy of `repro.obs.export`: the same documents, byte for byte.

`write_trace` renders a `Tracer`'s events in the Chrome / Perfetto
`trace_event` JSON Object Format: complete events (`"ph": "X"` with
`ts`/`dur`), instant events (`"ph": "i"` with `"s": "t"`), and one
thread-name metadata event (`"ph": "M"`, `"name": "thread_name"`) per
logical track so Perfetto labels the rows — drop the file on
`ui.perfetto.dev` and a multi-tenant serve run opens at solver-semantic
granularity.  All events share one pid (this is a single-process trace;
the interesting axis is logical tracks, not OS processes) and each
named track maps to a stable small tid.

`validate_trace` is the schema check the tests (and the CI smoke) run
on an exported file: required keys per phase type, numeric ts/dur,
known pids/tids, and per-track well-formed nesting — complete events on
one track must form a proper forest (any two either disjoint or
nested), which is the invariant Perfetto's track builder needs to
render spans without overlap artifacts.

`write_prometheus` / `parse_prometheus` round-trip a MetricsRegistry
snapshot through the text exposition format (`# TYPE` / `# HELP`
comments + `name{label="v"} value` samples); `write_metrics_jsonl`
emits one self-describing JSON record per sample for log pipelines.
No third-party client libraries — the formats are simple and the
container must not grow dependencies.

For long-lived processes the batch exporters above are the wrong
shape — they need every event resident at export time.
`StreamingTraceWriter` is the incremental counterpart: it subscribes
to a tracer as a sink (`Tracer.add_sink`), buffers at most
`flush_every` closed events, and appends them to the current segment
file on every flush while keeping that file a complete,
`validate_trace`-clean JSON document at all times (the closing `]}` is
rewritten in place after each append).  Segments rotate on
event-count or byte thresholds, so both resident memory *and*
per-file size stay bounded.  `MetricsJsonlWriter` is the matching
rotating JSONL sink for registry snapshots.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any

from .spans import SpanEvent, Tracer

#: Single-process trace: every event shares this pid.
TRACE_PID = 1


def _track_ids(events) -> dict[str, int]:
    """Stable name → tid map in first-appearance order (tid 1..)."""
    tids: dict[str, int] = {}
    for ev in events:
        if ev.track not in tids:
            tids[ev.track] = len(tids) + 1
    return tids


def _thread_meta(track: str, tid: int) -> dict:
    return {"ph": "M", "name": "thread_name", "pid": TRACE_PID,
            "tid": tid, "args": {"name": track}}


def _event_record(ev: SpanEvent, tids: dict[str, int]) -> dict:
    """One SpanEvent as a trace_event JSON object (tid via `tids`)."""
    rec: dict[str, Any] = {
        "name": ev.name, "cat": ev.cat, "pid": TRACE_PID,
        "tid": tids[ev.track], "ts": ev.ts_us}
    if ev.dur_us is None:
        rec["ph"] = "i"
        rec["s"] = "t"        # thread-scoped instant
    else:
        rec["ph"] = "X"
        rec["dur"] = ev.dur_us
    if ev.args:
        rec["args"] = ev.args
    return rec


def trace_events(tr: "Tracer | list[SpanEvent]") -> list[dict]:
    """The `traceEvents` list for a tracer (or raw event list):
    thread-name metadata first, then the recorded spans/instants in
    recording order."""
    events = tr.events() if isinstance(tr, Tracer) else list(tr)
    tids = _track_ids(events)
    out: list[dict] = [_thread_meta(track, tid)
                       for track, tid in tids.items()]
    out.extend(_event_record(ev, tids) for ev in events)
    return out


def trace_event_json(tr: "Tracer | list[SpanEvent]") -> dict:
    """The complete JSON-object-format document."""
    return {"traceEvents": trace_events(tr),
            "displayTimeUnit": "ms"}


def write_trace(tr: "Tracer | list[SpanEvent]", path) -> int:
    """Write the Perfetto JSON to `path`; returns the event count
    (metadata included)."""
    doc = trace_event_json(tr)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return len(doc["traceEvents"])


# ---------------------------------------------------------------------------
# Trace validation (the exported-schema contract the tests pin)
# ---------------------------------------------------------------------------

def validate_trace(doc: "dict | list") -> list[dict]:
    """Schema-validate a trace document (parsed JSON dict, or the bare
    `traceEvents` list).  Raises ValueError naming the first violation;
    returns the event list on success.

    Checks: required `ph`/`pid`/`tid` everywhere and `ts` on every
    non-metadata event; numeric, finite, non-negative ts/dur; `"X"`
    events carry `dur`; and per-(pid, tid) the complete events nest
    well-formedly (sorted by start, each event either contains or is
    disjoint from the next — the Perfetto track invariant)."""
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError("trace document has no traceEvents list")

    def _num(ev, key):
        v = ev.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v) or v < 0:
            raise ValueError(
                f"event {ev.get('name')!r}: {key}={v!r} is not a "
                f"finite non-negative number")
        return float(v)

    spans: dict[tuple, list[tuple]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for key in ("ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(
                    f"traceEvents[{i}] ({ev.get('name')!r}) lacks "
                    f"required key {key!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        ts = _num(ev, "ts")
        if "name" not in ev:
            raise ValueError(f"traceEvents[{i}] lacks a name")
        if ph == "X":
            dur = _num(ev, "dur")
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (ts, ts + dur, ev["name"]))
        elif ph not in ("i", "I", "B", "E", "C"):
            raise ValueError(
                f"event {ev['name']!r}: unknown phase {ph!r}")

    for (pid, tid), ivals in spans.items():
        # sort by start asc, end desc: a containing span sorts before
        # its children, so well-formed nesting reduces to a stack walk
        ivals.sort(key=lambda t: (t[0], -t[1]))
        stack: list[tuple] = []
        eps = 1e-6   # float µs jitter tolerance at shared boundaries
        for s, e, name in ivals:
            while stack and s >= stack[-1][1] - eps:
                stack.pop()
            if stack and e > stack[-1][1] + eps:
                raise ValueError(
                    f"track (pid={pid}, tid={tid}): span {name!r} "
                    f"[{s}, {e}] partially overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, "
                    f"{stack[-1][1]}] — not well-nested")
            stack.append((s, e, name))
    return events


def read_trace(path) -> list[dict]:
    """Load + validate an exported trace file."""
    with open(path) as f:
        return validate_trace(json.load(f))


# ---------------------------------------------------------------------------
# Streaming trace export (bounded resident memory, rotating segments)
# ---------------------------------------------------------------------------

class StreamingTraceWriter:
    """Incremental Perfetto writer with bounded resident memory.

    Subscribes to a `Tracer` as an event sink (`attach` / the `tracer=`
    kwarg) so every *closed* span or instant is handed over immediately;
    at most `flush_every` events stay buffered before being appended to
    the current segment file.  The segment is a complete JSON-object-
    format document after **every** flush — the writer seeks back over
    the `]}` tail and rewrites it after each append — so a crash, a
    `kill -9`, or a concurrent reader always sees a `validate_trace`-
    clean file.  Segments rotate once they hold `rotate_events` events
    or reach `rotate_bytes` bytes, whichever triggers first (either may
    be None); rotated paths accumulate on `self.segments`.

    Each segment carries its own thread-name metadata (track → tid maps
    are per-segment, minted on first appearance), so any single segment
    opens standalone in `ui.perfetto.dev`.  Only closed spans are ever
    written, hence a child span can land one segment before its parent —
    that is a legal forest for `validate_trace` (per-track nesting is
    checked within each file).

    Usage:

        with obs.tracing() as tr, \\
                obs.StreamingTraceWriter("otel/", tracer=tr) as w:
            ... long-lived engine ...
        # w.segments: rotated trace-*.json files, each valid on its own
    """

    _TAIL = "\n]}\n"

    def __init__(self, directory, prefix: str = "trace",
                 flush_every: int = 64,
                 rotate_events: "int | None" = 4096,
                 rotate_bytes: "int | None" = None,
                 tracer: "Tracer | None" = None):
        self.directory = str(directory)
        self.prefix = prefix
        self.flush_every = max(1, int(flush_every))
        self.rotate_events = int(rotate_events) if rotate_events else None
        self.rotate_bytes = int(rotate_bytes) if rotate_bytes else None
        os.makedirs(self.directory, exist_ok=True)
        #: Paths of every segment opened so far, in order.
        self.segments: list[str] = []
        #: Events handed to the writer over its lifetime.
        self.total_events = 0
        self._buf: list[SpanEvent] = []
        self._file = None
        self._seq = 0
        self._tids: dict[str, int] = {}
        self._segment_events = 0
        self._body_end = 0
        self._tracer: "Tracer | None" = None
        if tracer is not None:
            self.attach(tracer)

    # -- tracer wiring -----------------------------------------------------

    def attach(self, tracer: Tracer) -> "StreamingTraceWriter":
        self.detach()
        tracer.add_sink(self.write_event)
        self._tracer = tracer
        return self

    def detach(self) -> None:
        if self._tracer is not None:
            self._tracer.remove_sink(self.write_event)
            self._tracer = None

    # -- recording ---------------------------------------------------------

    @property
    def resident(self) -> int:
        """Events currently buffered in memory (< `flush_every`)."""
        return len(self._buf)

    @property
    def current_segment(self) -> "str | None":
        return self.segments[-1] if self._file is not None else None

    def write_event(self, ev: SpanEvent) -> None:
        """Sink entry point; flushes once `flush_every` accumulate."""
        self._buf.append(ev)
        if len(self._buf) >= self.flush_every:
            self.flush()

    def _open_segment(self) -> None:
        path = os.path.join(
            self.directory, f"{self.prefix}-{self._seq:05d}.json")
        self._file = open(path, "w")
        self._file.write('{"displayTimeUnit": "ms", "traceEvents": [')
        self._body_end = self._file.tell()
        self._file.write(self._TAIL)
        self._file.flush()
        self._tids = {}
        self._segment_events = 0
        self.segments.append(path)

    def flush(self) -> None:
        """Append buffered events to the current segment, leaving it a
        complete valid JSON document; rotates if a threshold tripped."""
        if not self._buf:
            return
        if self._file is None:
            self._open_segment()
        recs: list[dict] = []
        for ev in self._buf:
            if ev.track not in self._tids:
                tid = self._tids[ev.track] = len(self._tids) + 1
                recs.append(_thread_meta(ev.track, tid))
            recs.append(_event_record(ev, self._tids))
        first = self._segment_events == 0
        body = "".join(
            ("\n " if first and i == 0 else ",\n ") + json.dumps(rec)
            for i, rec in enumerate(recs))
        self._segment_events += len(recs)
        self.total_events += len(self._buf)
        self._buf.clear()
        f = self._file
        f.seek(self._body_end)
        f.write(body)
        self._body_end = f.tell()
        f.write(self._TAIL)
        f.truncate()
        f.flush()
        if (self.rotate_events
                and self._segment_events >= self.rotate_events) or \
           (self.rotate_bytes
                and self._body_end + len(self._TAIL) >= self.rotate_bytes):
            self._close_segment()

    def _close_segment(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._seq += 1

    def close(self) -> None:
        """Flush the residue, close the open segment, detach."""
        self.detach()
        self.flush()
        self._close_segment()

    def __enter__(self) -> "StreamingTraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Metrics sinks
# ---------------------------------------------------------------------------

def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n") \
                .replace('"', '\\"')


def prometheus_text(reg) -> str:
    """Render a MetricsRegistry snapshot in the Prometheus text
    exposition format (families sorted by name for stable diffs)."""
    lines: list[str] = []
    for fam in sorted(reg.families(), key=lambda f: f.name):
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples():
            if s.labels:
                labels = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in s.labels)
                lines.append(f"{s.name}{{{labels}}} {s.value:g}")
            else:
                lines.append(f"{s.name} {s.value:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(reg, path) -> int:
    """Write the snapshot to `path`; returns the sample-line count."""
    text = prometheus_text(reg)
    with open(path, "w") as f:
        f.write(text)
    return sum(1 for ln in text.splitlines()
               if ln and not ln.startswith("#"))


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse exposition text back to {series: value} where series is
    `name{k="v",...}` exactly as rendered — the round-trip check the CI
    smoke runs on its own snapshot.  Raises ValueError on malformed
    sample lines."""
    out: dict[str, float] = {}
    for lineno, ln in enumerate(text.splitlines(), 1):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        series, _, value = ln.rpartition(" ")
        if not series:
            raise ValueError(f"line {lineno}: no value separator")
        try:
            out[series] = float(value)
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: bad sample value {value!r}") from e
    return out


def write_metrics_jsonl(reg, path) -> int:
    """One JSON record per sample: {"metric", "kind", "labels",
    "value"}; returns the record count."""
    n = 0
    with open(path, "w") as f:
        for s in reg.samples():
            json.dump({"metric": s.name, "kind": s.kind,
                       "labels": dict(s.labels), "value": s.value}, f)
            f.write("\n")
            n += 1
    return n


class MetricsJsonlWriter:
    """Rotating JSONL sink for registry snapshots.

    `write_snapshot(reg, **extra)` appends one record per sample (the
    same `{"metric", "kind", "labels", "value"}` schema as
    `write_metrics_jsonl`, merged with the caller's `extra` — e.g. a
    snapshot sequence number or wall-clock stamp) to the current
    `{prefix}-{seq:05d}.jsonl` segment, then rotates once the segment
    reaches `rotate_bytes`.  Every line is flushed as written, so
    partially-rotated directories always tail cleanly."""

    def __init__(self, directory, prefix: str = "metrics",
                 rotate_bytes: "int | None" = 1 << 20):
        self.directory = str(directory)
        self.prefix = prefix
        self.rotate_bytes = int(rotate_bytes) if rotate_bytes else None
        os.makedirs(self.directory, exist_ok=True)
        self.segments: list[str] = []
        self.total_records = 0
        self._file = None
        self._seq = 0

    def _segment(self):
        if self._file is None:
            path = os.path.join(
                self.directory, f"{self.prefix}-{self._seq:05d}.jsonl")
            self._file = open(path, "w")
            self.segments.append(path)
        return self._file

    def _maybe_rotate(self) -> None:
        if self.rotate_bytes and self._file.tell() >= self.rotate_bytes:
            self._file.close()
            self._file = None
            self._seq += 1

    def write_snapshot(self, reg, **extra) -> int:
        """Append the registry's current samples; returns the record
        count written for this snapshot."""
        f = self._segment()
        n = 0
        for s in reg.samples():
            rec = {"metric": s.name, "kind": s.kind,
                   "labels": dict(s.labels), "value": s.value}
            rec.update(extra)
            f.write(json.dumps(rec) + "\n")
            n += 1
        f.flush()
        self.total_records += n
        self._maybe_rotate()
        return n

    def write_record(self, rec: dict, **extra) -> None:
        """Append one arbitrary JSON-safe record to the sink — the
        escape hatch for structured non-registry payloads (e.g.
        `repro_torch.serve.SLOReport.as_record()`), sharing the snapshot
        stream's segments, flushing and rotation."""
        merged = dict(rec)
        merged.update(extra)
        f = self._segment()
        f.write(json.dumps(merged) + "\n")
        f.flush()
        self.total_records += 1
        self._maybe_rotate()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._seq += 1

    def __enter__(self) -> "MetricsJsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_flight_jsonl(rows, path, **extra) -> int:
    """Flight-recorder rows as JSONL ({field: value} + caller extras
    like job=...); accepts the (rows, F) array `recorder_rows` returns
    or an iterable of dicts."""
    from .recorder import rows_to_dicts
    import numpy as np
    if isinstance(rows, np.ndarray):
        rows = rows_to_dicts(rows)
    n = 0
    with open(path, "w") as f:
        for row in rows:
            json.dump(dict(row, **extra), f)
            f.write("\n")
            n += 1
    return n
