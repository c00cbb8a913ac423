"""Nested span recorder (``repro.obs.trace``: ``Span``, ``Recorder``,
``current_recorder``, ``set_recorder``, ``use_recorder``, copied).

A ``Recorder`` collects *spans* (named, nested host-side intervals) and
*events* (point-in-time structured records). Instrumented code paths (the
sweeps of ``repro_torch.perf.sweep``) open spans around their phases.

* **Zero overhead when disabled.** A disabled recorder's ``span()``
  returns a module-level null singleton whose ``__enter__``/``__exit__``
  do nothing and allocate nothing.

* **Explicit device-sync policy.** CUDA launches are asynchronous: a span
  closed without a synchronise times the host's dispatch, not the
  device's work. ``span.sync(x)`` synchronises the device of ``x``'s CUDA
  tensors (``torch.cuda.synchronize``) only under
  ``sync_policy="boundary"`` and is the identity under the default
  ``"none"``, so enabling tracing adds no synchronise the untraced path
  did not already have.

* **Profiler pass-through.** With ``annotate=True``, spans carrying a
  ``step_num`` attribute also enter ``torch.profiler.record_function``
  (``"<name>#<step_num>"``), so a ``torch.profiler`` trace groups device
  activity by the same steps the recorder saw.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

SYNC_POLICIES = ("none", "boundary")


def _synchronize(value) -> None:
    """Wait for the devices of the CUDA tensors in ``value`` (a tensor, or
    nested lists, tuples and dicts of them)."""
    import torch
    stack, devices = [value], set()
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    for d in devices:
        torch.cuda.synchronize(d)


@dataclass
class Span:
    """One closed (or still-open) named interval.

    Times are seconds on the recorder's clock (``time.perf_counter``
    unless a test injects a deterministic one); ``t_end is None`` while
    the span is open. ``depth``/``parent_id`` encode the nesting at
    record time so exporters never have to re-derive it."""
    name: str
    span_id: int
    parent_id: Optional[int]
    t_start: float
    t_end: Optional[float] = None
    category: str = ""
    depth: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "span", "name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t_start": self.t_start,
                "t_end": self.t_end, "category": self.category,
                "depth": self.depth, "attrs": dict(self.attrs)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(name=d["name"], span_id=int(d["span_id"]),
                   parent_id=(None if d.get("parent_id") is None
                              else int(d["parent_id"])),
                   t_start=float(d["t_start"]),
                   t_end=(None if d.get("t_end") is None
                          else float(d["t_end"])),
                   category=d.get("category", ""),
                   depth=int(d.get("depth", 0)),
                   attrs=dict(d.get("attrs", {})))


class _NullSpan:
    """The disabled-path span: a no-op context manager singleton.

    Every method returns immediately; ``sync`` is the identity. One
    instance is shared process-wide, so the disabled hot path performs
    no allocation at all."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    @staticmethod
    def sync(value):
        return value


NULL_SPAN = _NullSpan()


class _ActiveSpan:
    """Context manager pairing one ``Span`` with its ``Recorder``."""
    __slots__ = ("_rec", "span", "_annotation")

    def __init__(self, rec: "Recorder", span: Span, annotation=None):
        self._rec = rec
        self.span = span
        self._annotation = annotation

    def __enter__(self) -> "_ActiveSpan":
        self._rec._push(self.span)
        if self._annotation is not None:
            self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            self.span.attrs.setdefault("error", repr(exc))
        self._rec._pop(self.span)
        return False

    def set(self, **attrs) -> "_ActiveSpan":
        self.span.attrs.update(attrs)
        return self

    def sync(self, value):
        """Block on ``value`` iff the recorder's policy says to.

        Under ``"none"`` (default) this is the identity: the span times
        host-side dispatch and never perturbs device scheduling. Under
        ``"boundary"`` it synchronises the devices of ``value``'s CUDA
        tensors: precise span durations at the cost of serializing any
        in-flight overlap."""
        if self._rec.sync_policy == "boundary":
            _synchronize(value)
        return value


class Recorder:
    """Span/event recorder with an on/off switch checked per call.

    ``clock`` is injectable for deterministic tests; ``sync_policy``
    gates ``span.sync`` (see module docstring); ``annotate=True`` makes
    spans with a ``step_num`` attribute pass through
    ``torch.profiler.record_function``."""

    def __init__(self, enabled: bool = True, *,
                 sync_policy: str = "none",
                 annotate: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        if sync_policy not in SYNC_POLICIES:
            raise ValueError(f"sync_policy {sync_policy!r} not in "
                             f"{SYNC_POLICIES}")
        self.enabled = bool(enabled)
        self.sync_policy = sync_policy
        self.annotate = bool(annotate)
        self.clock = clock
        self.spans: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self._stack: List[Span] = []
        self._next_id = 0
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, category: str = "", **attrs):
        """Open a span; use as ``with rec.span("step", step=i) as sp:``.

        Disabled recorders return the shared ``NULL_SPAN`` singleton —
        one attribute check, no allocation."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        sp = Span(name=name, span_id=sid,
                  parent_id=None if parent is None else parent.span_id,
                  t_start=self.clock(), category=category,
                  depth=len(self._stack), attrs=attrs)
        annotation = None
        if self.annotate and "step_num" in attrs:
            import torch
            annotation = torch.profiler.record_function(
                f"{name}#{int(attrs['step_num'])}")
        return _ActiveSpan(self, sp, annotation)

    def event(self, name: str, **attrs) -> None:
        """Record a point-in-time structured event (no-op disabled)."""
        if not self.enabled:
            return
        parent = self._stack[-1] if self._stack else None
        self.events.append({"type": "event", "name": name,
                            "t": self.clock(),
                            "parent_id": (None if parent is None
                                          else parent.span_id),
                            "attrs": attrs})

    def traced(self, name: Optional[str] = None, category: str = ""):
        """Decorator form: ``@rec.traced("fit")``."""
        def wrap(fn):
            label = name or fn.__name__

            def inner(*a, **kw):
                with self.span(label, category=category):
                    return fn(*a, **kw)
            inner.__name__ = getattr(fn, "__name__", label)
            inner.__doc__ = fn.__doc__
            return inner
        return wrap

    def sync(self, value):
        """Policy-gated synchronise outside any span object."""
        if self.enabled and self.sync_policy == "boundary":
            _synchronize(value)
        return value

    # -- internals ---------------------------------------------------------

    def _push(self, sp: Span) -> None:
        self._stack.append(sp)

    def _pop(self, sp: Span) -> None:
        sp.t_end = self.clock()
        # unwind to this span even if an exception skipped inner pops
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break
        self.spans.append(sp)

    # -- inspection --------------------------------------------------------

    @property
    def open_spans(self) -> int:
        return len(self._stack)

    def children_of(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        self.spans = []
        self.events = []
        self._stack = []


# ---------------------------------------------------------------------------
# The process-wide current recorder (disabled by default)
# ---------------------------------------------------------------------------
#
# Library code that cannot thread a recorder argument (the sweep's
# measure_trial, deep helpers) reads ``current_recorder()``; drivers
# install an enabled one with ``set_recorder``/``use_recorder``. The
# default is a disabled Recorder, so every instrumented path is
# zero-overhead until someone opts in.

_DISABLED = Recorder(enabled=False)
_current: Recorder = _DISABLED


def current_recorder() -> Recorder:
    return _current


def set_recorder(rec: Optional[Recorder]) -> Recorder:
    """Install ``rec`` (None = the disabled default); returns the old one."""
    global _current
    old = _current
    _current = rec if rec is not None else _DISABLED
    return old


@contextmanager
def use_recorder(rec: Recorder):
    old = set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(old)
