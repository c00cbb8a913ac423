"""Serialization of recorded traces: a JSONL event log and a Chrome trace
(``repro.obs.export``, copied, in its schema; a ``trace.jsonl`` written by
either package reads through the other's ``read_jsonl``).

* **JSONL**: one JSON object per line; spans (``type: "span"``), events
  (``type: "event"``), an optional metrics snapshot (``type: "metrics"``)
  and meta record (``type: "meta"``). ``read_jsonl`` gives it back as
  ``TraceData``.
* **Chrome trace / Perfetto**: the ``traceEvents`` format (``ph: "X"``
  complete events with microsecond ``ts``/``dur``, ``ph: "i"`` instants
  for events), loadable in ``chrome://tracing`` or ui.perfetto.dev.
  ``chrome_trace_ranks`` puts the recordings of several ranks of a pool
  on one timeline, each rank its own ``pid`` (the ranks' clocks are
  ``time.perf_counter``, the host's monotonic clock, which the processes
  of one host share).

Anything with ``spans`` and ``events`` lists exports: a ``Recorder``, or
the ``TraceData`` a pool rank sends back (a ``Recorder`` holds a lock and
does not pickle).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.obs.trace import Recorder, Span


@dataclass
class TraceData:
    """A deserialized trace: what ``read_jsonl`` hands back."""
    spans: List[Span] = field(default_factory=list)
    events: List[Dict[str, Any]] = field(default_factory=list)
    metrics: Optional[Dict[str, Any]] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children_of(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]


def recorded(rec: Recorder) -> TraceData:
    """A recorder's spans and events as a picklable ``TraceData``."""
    return TraceData(spans=list(rec.spans), events=list(rec.events))


def trace_lines(rec, *, metrics: Optional[Dict[str, Any]] = None,
                meta: Optional[Dict[str, Any]] = None) -> List[str]:
    """The JSONL lines of a recording (meta first when given, spans in
    completion order, then events, then the metrics record)."""
    lines: List[str] = []
    if meta:
        lines.append(json.dumps({"type": "meta", **meta}, sort_keys=True))
    for sp in rec.spans:
        lines.append(json.dumps(sp.to_dict(), sort_keys=True))
    for ev in rec.events:
        lines.append(json.dumps(ev, sort_keys=True))
    if metrics is not None:
        lines.append(json.dumps({"type": "metrics", "metrics": metrics},
                                sort_keys=True))
    return lines


def write_jsonl(path, rec, *, metrics: Optional[Dict[str, Any]] = None,
                meta: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as fh:
        for line in trace_lines(rec, metrics=metrics, meta=meta):
            fh.write(line + "\n")


def read_jsonl(path) -> TraceData:
    data = TraceData()
    with open(path) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            rec = json.loads(raw)
            kind = rec.get("type")
            if kind == "span":
                data.spans.append(Span.from_dict(rec))
            elif kind == "event":
                data.events.append(rec)
            elif kind == "metrics":
                data.metrics = rec.get("metrics")
            elif kind == "meta":
                data.meta = {k: v for k, v in rec.items() if k != "type"}
    return data


def _t0(recs) -> float:
    return min([s.t_start for r in recs for s in r.spans]
               + [e["t"] for r in recs for e in r.events], default=0.0)


def _events(rec, pid: int, tid: int, process_name: str, t0: float) -> List[Dict]:
    def us(t: float) -> float:
        return (t - t0) * 1e6

    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": process_name}}]
    for sp in rec.spans:
        if sp.t_end is None:
            continue
        events.append({
            "name": sp.name, "cat": sp.category or "span", "ph": "X",
            "pid": pid, "tid": tid, "ts": us(sp.t_start),
            "dur": us(sp.t_end) - us(sp.t_start),
            "args": {**sp.attrs, "span_id": sp.span_id, "depth": sp.depth}})
    for ev in rec.events:
        events.append({
            "name": ev["name"], "cat": "event", "ph": "i", "s": "t",
            "pid": pid, "tid": tid, "ts": us(ev["t"]),
            "args": dict(ev.get("attrs", {}))})
    return events


def chrome_trace(rec, *, pid: int = 1, tid: int = 1,
                 process_name: str = "repro") -> Dict[str, Any]:
    """The recording as a Chrome-trace ``traceEvents`` dict: one pid/tid
    lane (the recorder is one nested stack on one host thread)."""
    return {"traceEvents": _events(rec, pid, tid, process_name, _t0([rec])),
            "displayTimeUnit": "ms"}


def chrome_trace_ranks(recs: Mapping[int, Any], *, tid: int = 1,
                       process_name: str = "rank") -> Dict[str, Any]:
    """Several ranks' recordings ({rank: recording}) on one timeline, each
    rank its own ``pid`` and process name ``"<process_name> <rank>"``."""
    t0 = _t0(list(recs.values()))
    events: List[Dict[str, Any]] = []
    for rank in sorted(recs):
        events += _events(recs[rank], int(rank), tid, f"{process_name} {rank}", t0)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, rec, **kw) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(rec, **kw), fh, indent=1)


def write_chrome_trace_ranks(path, recs: Mapping[int, Any], **kw) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace_ranks(recs, **kw), fh, indent=1)
