"""Counters, gauges, histograms and the model-derived metric helpers
(``repro.obs.metrics``, copied; the watermarks read ``torch.cuda``).

A ``Metrics`` registry of three instrument kinds, plus helpers that derive
the metrics the performance model speaks in: per-collective bytes from the
calibrated schedules, device memory watermarks (``torch.cuda.memory_stats``
of each CUDA device the run uses), throughput in the sweep's units
(samples/s, tokens/s), and straggler skew.

``StragglerMonitor`` wires ``train.ft.StragglerDetector`` to the metrics: it
feeds the detector every measured step time, keeps the straggler-skew gauge
current, and records a structured ``straggler`` event (step, measured,
expected, tolerance) through the recorder when the detector trips.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.trace import Recorder, current_recorder


@dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "counter", "value": self.value}


@dataclass
class Gauge:
    name: str
    value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "gauge", "value": self.value}


@dataclass
class Histogram:
    """Exact small-run histogram: keeps every observation (``max_samples``
    caps it, oldest dropped; count and total stay exact)."""
    name: str
    max_samples: int = 100_000
    values: List[float] = field(default_factory=list)
    count: int = 0
    total: float = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.values.append(float(v))
        if len(self.values) > self.max_samples:
            del self.values[:len(self.values) - self.max_samples]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, p: float) -> Optional[float]:
        if not self.values:
            return None
        h = sorted(self.values)
        idx = min(int(round((p / 100.0) * (len(h) - 1))), len(h) - 1)
        return h[idx]

    @property
    def median(self) -> Optional[float]:
        return self.percentile(50.0)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "histogram", "count": self.count,
                "mean": self.mean, "p50": self.median,
                "p95": self.percentile(95.0),
                "min": min(self.values) if self.values else None,
                "max": max(self.values) if self.values else None}


class Metrics:
    """Get-or-create registry; one namespace per run."""

    def __init__(self):
        self._by_name: Dict[str, Any] = {}

    def _get(self, name: str, kind, **kw):
        inst = self._by_name.get(name)
        if inst is None:
            inst = kind(name=name, **kw)
            self._by_name[name] = inst
        elif not isinstance(inst, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        return {name: m.to_dict() for name, m in sorted(self._by_name.items())}


# ---------------------------------------------------------------------------
# Model-derived metric helpers
# ---------------------------------------------------------------------------

def observe_step(metrics: Metrics, *, seconds: float, batch: int,
                 seq: Optional[int] = None) -> None:
    """One training step's throughput metrics: the step-time histogram and
    samples/s (tokens/s when ``seq`` is known)."""
    metrics.histogram("step_time_ms").observe(seconds * 1e3)
    metrics.counter("steps").inc()
    metrics.counter("samples").inc(batch)
    metrics.gauge("samples_per_s").set(batch / max(seconds, 1e-12))
    if seq is not None:
        metrics.counter("tokens").inc(batch * seq)
        metrics.gauge("tokens_per_s").set(batch * seq / max(seconds, 1e-12))


def collective_bytes(strategy, n_devices: int, param_bytes: int, *,
                     wire_bits: int = 32, act_bytes: int = 0,
                     axes: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """Per-collective payload bytes of one training iteration from the
    calibrated schedule layer, keyed ``op/axis/tensor`` (the keys
    ``obs.attribution`` aligns measurements to)."""
    from repro_torch.perf.costmodel import ScheduleInputs, build_schedule

    inp = ScheduleInputs(n_devices=n_devices, param_bytes=param_bytes,
                         wire_bits=wire_bits, act_bytes=act_bytes)
    out: Dict[str, float] = {}
    for call in build_schedule(strategy, inp, axes=axes):
        key = f"{call.op}/{call.axis}/{call.tensor}"
        out[key] = out.get(key, 0.0) + float(call.nbytes)
    return out


def record_collective_bytes(metrics: Metrics, strategy, n_devices: int,
                            param_bytes: int, **kw) -> Dict[str, float]:
    """``collective_bytes`` added to the per-term counters
    (``comm_bytes/<op>/<axis>/<tensor>``) as one step's increments."""
    per_term = collective_bytes(strategy, n_devices, param_bytes, **kw)
    for key, nbytes in per_term.items():
        metrics.counter(f"comm_bytes/{key}").inc(nbytes)
    return per_term


def device_memory_watermarks(devices: Optional[Sequence] = None
                             ) -> Dict[str, Dict[str, int]]:
    """Per-device watermarks from ``torch.cuda.memory_stats``: bytes in use
    and their peak (``max_memory_allocated``), and the card's size. Only
    CUDA devices report; a CPU device is absent, so instrumented code can
    call this on any host. ``devices`` defaults to every CUDA device once
    CUDA is initialised (none before, and none on a host without CUDA)."""
    import torch

    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() and torch.cuda.is_initialized() else [])
    out: Dict[str, Dict[str, int]] = {}
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        stats = torch.cuda.memory_stats(d)
        if not stats:
            continue
        out[str(d)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(d).total_memory)}
    return out


def record_memory_watermarks(metrics: Metrics, devices: Optional[Sequence] = None
                             ) -> Dict[str, Dict[str, int]]:
    """Watermarks written into gauges (max across devices)."""
    marks = device_memory_watermarks(devices)
    if marks:
        for key in ("bytes_in_use", "peak_bytes_in_use"):
            vals = [m[key] for m in marks.values() if key in m]
            if vals:
                metrics.gauge(f"memory/{key}_max").set(max(vals))
    return marks


def record_recovery(metrics: Metrics, recovery: Dict) -> None:
    """``launch.train``'s measured recovery breakdown written into gauges: each
    present term of plan_s / compile_s / restore_s / first_step_s /
    recovery_s as ``recovery/<term>_ms``, a ``recoveries`` counter and a
    ``recovery/steps_replayed`` gauge."""
    metrics.counter("recoveries").inc()
    for term in ("plan_s", "compile_s", "restore_s", "first_step_s", "recovery_s"):
        v = recovery.get(term)
        if v is not None:
            metrics.gauge(f"recovery/{term[:-2]}_ms").set(float(v) * 1e3)
    if recovery.get("steps_replayed") is not None:
        metrics.gauge("recovery/steps_replayed").set(float(recovery["steps_replayed"]))


def straggler_skew(step_seconds: Sequence[float]) -> float:
    """max/median step-time ratio over a window; 1.0 means no skew."""
    vals = [float(v) for v in step_seconds if v > 0]
    if len(vals) < 2:
        return 1.0
    h = sorted(vals)
    med = h[len(h) // 2]
    return h[-1] / max(med, 1e-12)


class StragglerMonitor:
    """Feeds measured step times to ``ft.StragglerDetector`` through the
    metrics and records a structured ``straggler`` event when it trips."""

    def __init__(self, detector, metrics: Optional[Metrics] = None,
                 recorder: Optional[Recorder] = None, skew_window: int = 32):
        self.detector = detector
        self.metrics = metrics if metrics is not None else Metrics()
        self._recorder = recorder
        self.skew_window = skew_window

    @property
    def recorder(self) -> Recorder:
        return self._recorder if self._recorder is not None else current_recorder()

    @property
    def flags(self) -> List[int]:
        return self.detector.flags

    def observe(self, step: int, seconds: float) -> bool:
        expected = self.detector.expected()     # the value the trip uses
        flagged = self.detector.observe(step, seconds)
        self.metrics.gauge("straggler_skew").set(straggler_skew(
            self.detector.history[-self.skew_window:]))
        if flagged:
            self.metrics.counter("straggler_flags").inc()
            self.recorder.event(
                "straggler", step=int(step), seconds=float(seconds),
                expected_s=(None if expected is None else float(expected)),
                tolerance=float(self.detector.tolerance),
                skew=straggler_skew(self.detector.history[-self.skew_window:]))
        return flagged
